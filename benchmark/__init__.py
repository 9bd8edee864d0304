"""The benchmark of the PyTorch/CUDA port (`e2e_multi_view_matching_tpu_torch`)."""
