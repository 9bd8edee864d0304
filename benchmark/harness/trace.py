"""The traced run's instruments: a device-only profiler over a bounded
stretch of work run right after the window (the same calls as the window's),
and host and CUDA-event spans around module calls in the window.

`DeviceTrace` records device activity only (no host ops, no event trees:
those cost minutes for the eval pose stage's launches) and keeps, for each
device operation of the stretch, its name, start and duration. `Spans`
registers forward pre- and post-hooks on a module and records, for each call,
the host clock at both hooks and a CUDA event pair, read after the window.
The untraced run creates neither.
"""

import time


class DeviceTrace:
    """`start()` and `stop()` around a stretch of work; then `ops`
    holds (name, start_ns, duration_ns) of every device operation, and
    `wall_s` the host seconds between the two calls, the device synchronised
    before the stop."""

    def __init__(self, cuda=True):
        self.cuda = cuda
        self.ops = []
        self.wall_s = None
        self.units = 0
        self._prof = None
        self._t0 = None

    def start(self):
        """Start the stretch; without a card (the CPU tests) only its wall
        time is taken."""
        from torch.profiler import ProfilerActivity, profile

        if self.cuda:
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units):
        """End the stretch, which held `units` units of work (sub-chunks or
        steps)."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.units = units
        if not self.cuda:
            return
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.ops.append((e.name(), e.start_ns(), e.duration_ns()))
        self._prof = None

    @property
    def done(self):
        return self.wall_s is not None

    def launches(self):
        """Kernels in the stretch (memory copies and sets left out)."""
        return sum(1 for name, _, _ in self.ops if not name.startswith(("Memcpy", "Memset")))

    def busy_s(self):
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals)."""
        busy, end = 0, None
        for t0, dt in sorted((t0, dt) for _, t0, dt in self.ops):
            t1 = t0 + dt
            if end is None or t0 >= end:
                busy += dt
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e9

    def seconds_by(self, pattern):
        """(launches, device seconds) of the operations whose name matches
        the compiled regular expression `pattern`."""
        n, ns = 0, 0
        for name, _, dt in self.ops:
            if pattern.search(name):
                n += 1
                ns += dt
        return n, ns / 1e9

    def top_ops(self, count=10):
        """[[name, seconds], ...] of the operations that took most device
        time, summed by name."""
        by = {}
        for name, _, dt in self.ops:
            by[name] = by.get(name, 0) + dt
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count=10):
        """[[label, seconds], ...]: the idle time between device operations,
        summed by the operation that ended the gap ("before <name>"), the
        largest first; the host was enqueuing the work that led to it."""
        by, end = {}, None
        for name, t0, dt in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and t0 > end:
                key = f"before {name}"
                by[key] = by.get(key, 0) + (t0 - end)
            end = t0 + dt if end is None else max(end, t0 + dt)
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:count]]


class Spans:
    """Host-clock and CUDA-event spans of every forward call of `module`."""

    def __init__(self, module, cuda=True):
        self.calls = []  # [host_t0, host_t1, start_event, end_event]
        self.cuda = cuda
        self._handles = [module.register_forward_pre_hook(self._pre),
                         module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        ev = None
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.calls.append([time.perf_counter(), None, ev, None])

    def _post(self, module, args, out):
        call = self.calls[-1]
        if self.cuda:
            import torch

            call[3] = torch.cuda.Event(enable_timing=True)
            call[3].record()
        call[1] = time.perf_counter()

    def remove(self):
        for h in self._handles:
            h.remove()

    def device_ms(self):
        """Device milliseconds of each call, between its two events (after
        the window: the events have completed)."""
        return [c[2].elapsed_time(c[3]) for c in self.calls if c[3] is not None]
