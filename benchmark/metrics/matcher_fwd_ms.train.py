"""Device milliseconds of the matcher's forward a training step: CUDA
events recorded by the forward pre- and post-hooks on the program's
`MultiViewMatcher` (the backward runs after the post-hook), summed over the
window, over its steps."""


def read(run):
    spans = run.spans.get("matcher")
    if spans is None or not spans.cuda or not run.units:
        return None
    return sum(spans.device_ms()) / run.units
