"""Model FLOPs of the window's eval sub-chunks (SuperPoint's convolutions,
the matcher's linears, every attention layer's QK^T and PV, the pair score
products, the confidence head; `harness/work.py::eval_unit_flops`) over the
window's seconds, as a share of the H100's 67 TFLOP/s FP32 peak (the port
runs float32 with TF32 off)."""

from benchmark.harness import work


def read(run):
    if not run.units or not run.window_s:
        return None
    return 100.0 * run.units * work.eval_unit_flops(run.shapes) / run.window_s / work.PEAK_F32_OPS
