"""The plain PyTorch reference of the port's timed paths, and the numbers
that judge the port against it (`judge.py`). Imports nothing of the port."""

import torch


def float32(tf32=False):
    """The reference's precision: float32 with TF32 off (the
    configurations'), or with TF32 on (the control, the precision below)."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
