"""Optimizer and schedule of the training loop (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/train/optim.py`:
- `scale_lr`: lr *= sqrt(fact), decay_rate **= fact, start/end decay steps /=
  fact, with fact = tuple*batch*n_devices / (2 * 64) (megadepth base batch 16).
- Exponential decay whose exponent is clipped to [0, end - start].
- Two parameter groups: `conf_mlp` at a fixed rate of 1e-4, everything else
  on the schedule.
- Gradient value clipping at 0.1 and the non-finite guard only in the
  pose-loss stage; the clip comes before Adam.

`Adam` is a small functional Adam (optax's defaults: b1 0.9, b2 0.999, eps
1e-8 outside the root, bias-corrected; the first update uses `schedule(0)`).
The step count lives on the device, and the non-finite guard selects with
`torch.where` between the new and the old parameters, moments and count, so a
skipped step leaves all of them untouched without the host ever reading the
flag: no `if` on a device value, no synchronisation.
"""

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def scale_lr(tuple_size, batch_size, n_devices, lr, decay_rate, start_decay,
             end_decay, dataset):
    """Learning-rate scaling law."""
    orig_batch_size = 16.0 if "megadepth" in dataset else 64.0
    orig_tuple_size = 2.0
    fact = float(tuple_size * batch_size * n_devices) / (orig_tuple_size * orig_batch_size)
    return (
        math.sqrt(fact) * lr,
        decay_rate**fact,
        int(start_decay / fact),
        int(end_decay / fact),
    )


def windowed_exponential_schedule(base_lr, decay_rate, start_decay, end_decay):
    """lr(step) = base * decay_rate^clip(step - start, 0, end - start), in
    float32 like the JAX schedule (the float32 rounding of a decay rate this
    close to 1 is part of the result); `step` is a 0-dim integer tensor."""
    window = max(end_decay - start_decay, 0)

    def schedule(step):
        exponent = torch.clamp(step - start_decay, 0, window).to(torch.float32)
        # filled on the device: a host scalar copied over would synchronise
        rate = torch.full((), decay_rate, dtype=torch.float32, device=step.device)
        return base_lr * torch.pow(rate, exponent)

    return schedule


class Adam:
    """Grouped Adam over named parameters, updated in place.

    Args:
        named_params: iterable of (name, parameter); names containing
            "conf_mlp" form the fixed-rate group.
        schedule: 0-dim step tensor -> learning rate of the main group.
        conf_mlp_lr: the fixed rate of the `conf_mlp` group.
        grad_clip: clip gradient values to [-grad_clip, grad_clip] before
            Adam when > 0.
        skip_nonfinite: skip the whole update (parameters, moments, count)
            when any gradient entry is non-finite, and count the skip.
    """

    def __init__(self, named_params, schedule, conf_mlp_lr=1e-4, grad_clip=-1.0,
                 skip_nonfinite=False):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.is_conf = ["conf_mlp" in n for n in self.names]
        self.schedule = schedule
        self.conf_mlp_lr = conf_mlp_lr
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        dev = self.params[0].device
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.skipped = torch.zeros((), dtype=torch.int64, device=dev)

    @torch.no_grad()
    def step(self, grads):
        """One update from `grads` (one tensor per parameter, in order)."""
        grads = list(grads)
        finite = None
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if self.grad_clip > 0:
            grads = [g.clamp(-self.grad_clip, self.grad_clip) for g in grads]
        m_new = list(torch._foreach_mul(self.m, B1))
        torch._foreach_add_(m_new, grads, alpha=1.0 - B1)
        v_new = list(torch._foreach_mul(self.v, B2))
        torch._foreach_addcmul_(v_new, grads, grads, value=1.0 - B2)
        count_new = self.count + 1
        c = count_new.to(torch.float32)
        bc1 = 1.0 - torch.pow(B1, c)
        bc2 = 1.0 - torch.pow(B2, c)
        lr_main = self.schedule(self.count)
        for i, p in enumerate(self.params):
            lr = self.conf_mlp_lr if self.is_conf[i] else lr_main
            update = (m_new[i] / bc1) / (torch.sqrt(v_new[i] / bc2) + EPS)
            p_new = p - lr * update
            if finite is not None:
                p_new = torch.where(finite, p_new, p)
                m_new[i] = torch.where(finite, m_new[i], self.m[i])
                v_new[i] = torch.where(finite, v_new[i], self.v[i])
            p.copy_(p_new)
        if finite is not None:
            count_new = torch.where(finite, count_new, self.count)
            self.skipped = self.skipped + (~finite).to(torch.int64)
        self.m, self.v, self.count = m_new, v_new, count_new

    def state_dict(self):
        """Moments keyed by parameter name, plus the two counters."""
        return {"m": dict(zip(self.names, self.m)), "v": dict(zip(self.names, self.v)),
                "count": self.count, "skipped": self.skipped}

    def load_state_dict(self, state):
        """Load a `state_dict()`; raises KeyError/ValueError when its
        parameters are not this optimizer's (another parameter grouping)."""
        if set(state["m"]) != set(self.names):
            raise KeyError("optimizer state belongs to another set of parameters")
        for i, n in enumerate(self.names):
            if state["m"][n].shape != self.params[i].shape:
                raise ValueError(f"optimizer state of {n} has another shape")
        dev = self.count.device
        self.m = [state["m"][n].to(dev).clone() for n in self.names]
        self.v = [state["v"][n].to(dev).clone() for n in self.names]
        self.count = state["count"].to(dev).clone()
        self.skipped = state["skipped"].to(dev).clone()


def build_optimizer(named_params, base_lr, decay_rate, start_decay, end_decay,
                    pose_loss=False, conf_mlp_lr=1e-4, grad_clip=0.1):
    """The reference optimizer: grouped Adam + windowed decay + (with
    `pose_loss`) value clip and the non-finite guard."""
    schedule = windowed_exponential_schedule(base_lr, decay_rate, start_decay, end_decay)
    return Adam(named_params, schedule, conf_mlp_lr=conf_mlp_lr,
                grad_clip=grad_clip if pose_loss else -1.0, skip_nonfinite=pose_loss)
