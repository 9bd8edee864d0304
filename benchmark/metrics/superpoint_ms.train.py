"""Device milliseconds of SuperPoint a training step: CUDA events recorded
by the forward pre- and post-hooks on the program's `SuperPoint` (one call a
step, which runs the trunk V frames at a time inside), summed over the
window, over its steps."""


def read(run):
    spans = run.spans.get("superpoint")
    if spans is None or not spans.cuda or not run.units:
        return None
    return sum(spans.device_ms()) / run.units
