"""Host milliseconds a tuple from the end of a sub-chunk's matcher call (its
post-hook) to the start of the next sub-chunk's SuperPoint call (its
pre-hook): the pose stage's enqueue (`mvba/pipeline.py`) plus the eval
loop's own work in between (`cli/eval_multi_view.py::evaluate`: the fetch
of the previous chunk, its pair errors), summed over the window."""


def read(run):
    sp = run.spans.get("superpoint")
    m = run.spans.get("matcher")
    if sp is None or m is None or min(len(sp.calls), len(m.calls)) < 2:
        return None
    n = min(len(sp.calls), len(m.calls))
    gaps = [sp.calls[i + 1][0] - m.calls[i][1] for i in range(n - 1)]
    return 1e3 * sum(gaps) / ((n - 1) * run.shapes["batch"])
