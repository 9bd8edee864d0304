"""Device milliseconds of SuperPoint a tuple: CUDA events recorded by the
forward pre- and post-hooks on the program's `SuperPoint`, summed over the
window's calls (one a sub-chunk), over the tuples of the window."""


def read(run):
    spans = run.spans.get("superpoint")
    if spans is None or not spans.cuda or not run.tuples:
        return None
    return sum(spans.device_ms()) / run.tuples
