"""Model FLOPs of the window's training steps (the frozen SuperPoint once,
the matcher's forward three times for forward and backward;
`harness/work.py::train_step_flops`) over the window's seconds, as a share
of the H100's 67 TFLOP/s FP32 peak (float32 with TF32 off)."""

from benchmark.harness import work


def read(run):
    if not run.units or not run.window_s:
        return None
    return 100.0 * run.units * work.train_step_flops(run.shapes) / run.window_s / work.PEAK_F32_OPS
