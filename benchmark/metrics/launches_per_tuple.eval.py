"""Device kernels a tuple in the traced stretch (memory copies and sets left
out), counted in the device-only trace."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    return t.launches() / (t.units * run.shapes["batch"])
