"""Device milliseconds of the matcher a tuple: CUDA events recorded by the
forward pre- and post-hooks on the program's `MultiViewMatcher`, summed over
the window's calls, over its tuples."""


def read(run):
    spans = run.spans.get("matcher")
    if spans is None or not spans.cuda or not run.tuples:
        return None
    return sum(spans.device_ms()) / run.tuples
