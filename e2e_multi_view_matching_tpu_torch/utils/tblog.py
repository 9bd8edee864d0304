"""TensorBoard scalars and a step-window profiler of the training loop (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/utils/tblog.py`: `TBWriter`
writes train/val scalars under `<checkpoint_dir>/runs/<exp_name>` through
`torch.utils.tensorboard.SummaryWriter`, and does nothing when disabled or
when the `tensorboard` package is missing (logged once). `StepProfiler`
records `torch.profiler` (CPU and, on a GPU, CUDA activities) over a window
of optimizer steps and writes a Chrome trace under the trace directory.
"""

import logging
import os

import torch

log = logging.getLogger("tblog")


class TBWriter:
    """Lazy TensorBoard writer; no-ops when disabled or unavailable."""

    def __init__(self, checkpoint_dir, exp_name, enabled=True):
        self._writer = None
        self._enabled = enabled
        self._run_dir = os.path.join(checkpoint_dir, "runs", exp_name)

    def _get(self):
        if not self._enabled:
            return None
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                log.warning("tensorboard is not installed (%s): no scalars are written", e)
                self._enabled = False
                return None
            self._writer = SummaryWriter(log_dir=self._run_dir)
        return self._writer

    def scalars(self, tag, values, step):
        w = self._get()
        if w is not None:
            w.add_scalars(tag, values, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class StepProfiler:
    """Profile the steps from `start_step` up to `end_step` (global step
    counts, as the loop passes them before and after each step) and write
    `<trace_dir>/trace_steps_<start>_<end>.json`. A `trace_dir` of None
    disables it."""

    def __init__(self, trace_dir, start_step, end_step, cuda=False):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.end_step = end_step
        self.cuda = cuda
        self.trace_path = None
        self._prof = None

    def maybe_start(self, step):
        if self._prof is None and self.trace_dir is not None and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step):
        """End the window once `step` reaches `end_step`; True when it did."""
        if self._prof is None or step < self.end_step:
            return False
        self.close()
        return True

    def close(self):
        """End the window if it is open (a run that stopped inside it) and
        write its trace."""
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.trace_path = os.path.join(
            self.trace_dir, f"trace_steps_{self.start_step}_{self.end_step}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        log.info("profiler trace of steps %d-%d: %s", self.start_step, self.end_step,
                 self.trace_path)
