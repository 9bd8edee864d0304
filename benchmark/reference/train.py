"""Stage-1 training steps in plain float32 PyTorch: the benchmark's reference.

A stage-1 step of the port's `train/step.py` written out: ground-truth
matches from depth and pose (`gt_matches.py`), the matcher's forward in
training mode, the match loss of every pair (the weighted NLL of the log
assignment, summed over pairs, over the batch and divided by the pair count),
its gradient by autograd (the attention recomputed in the backward, so that
the cross layers' scores need not all be kept), and grouped Adam with the
port's hyperparameters (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside
the root, bias-corrected; the main group on the windowed exponential
schedule, `conf_mlp` at a fixed 1e-4).
"""

import torch

from .gt_matches import gt_matches_all_pairs

B1, B2, EPS = 0.9, 0.999, 1e-8


def match_loss_of_pair(log_p, gt_indices, gt_weights):
    """Weighted NLL of one pair's (B, K+1, K+1) log assignment; -1 is the dustbin."""
    B, F, _ = log_p.shape
    idx0 = gt_indices[:, 0].to(torch.int64)
    idx1 = gt_indices[:, 1].to(torch.int64)
    idx0 = torch.where(idx0 < 0, F - 1, idx0)
    idx1 = torch.where(idx1 < 0, F - 1, idx1)
    l0 = -torch.gather(log_p, 2, idx0[..., None])[..., 0]
    l1 = -torch.gather(log_p.transpose(1, 2), 2, idx1[..., None])[..., 0]
    return ((l0 * gt_weights[:, 0]).sum() + (l1 * gt_weights[:, 1]).sum()) / B


def step_loss(matcher, batch, sp_out, match_reproj_err, unmatch_reproj_err):
    """The stage-1 loss of one batch from the detector's outputs
    (kpts (B, V, K, 2), scores (B, V, K), descs (B, V, K, D))."""
    kpts, scores, descs = sp_out
    B, V, H, W = batch["images"].shape[:4]
    gt_i, gt_w = gt_matches_all_pairs(kpts, batch["intr"], batch["poses"], batch["depths"],
                                      match_reproj_err, unmatch_reproj_err)
    out = matcher(kpts, scores, descs, (H, W), train=True, full_output=False)
    log_p = out["log_assignment"]
    P = log_p.shape[1]
    loss = sum(match_loss_of_pair(log_p[:, p], gt_i[:, p], gt_w[:, p]) for p in range(P))
    return loss / float(P)


class Adam:
    """Grouped Adam over named parameters, in place."""

    def __init__(self, named_params, lr, decay_rate, start_decay, end_decay, conf_mlp_lr=1e-4):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.lr, self.decay_rate = lr, decay_rate
        self.start, self.window = start_decay, max(end_decay - start_decay, 0)
        self.conf_mlp_lr = conf_mlp_lr

    @torch.no_grad()
    def step(self, grads):
        exponent = min(max(self.count - self.start, 0), self.window)
        rate = torch.tensor(self.decay_rate, dtype=torch.float32)
        lr_main = self.lr * torch.pow(rate, torch.tensor(float(exponent))).item()
        self.count += 1
        bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32), self.count).item()
        bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32), self.count).item()
        for i, (name, p, g) in enumerate(zip(self.names, self.params, grads)):
            self.m[i] = B1 * self.m[i] + (1.0 - B1) * g
            self.v[i] = B2 * self.v[i] + (1.0 - B2) * g * g
            lr = self.conf_mlp_lr if "conf_mlp" in name else lr_main
            p -= lr * ((self.m[i] / bc1) / (torch.sqrt(self.v[i] / bc2) + EPS))


def run_steps(matcher, batches, sp_outputs, hp):
    """Three (len(batches)) steps of `matcher` from its current weights.
    `hp`: lr, decay_rate, start_decay, end_decay, match_reproj_err,
    unmatch_reproj_err. Returns {"losses", "grad_norms" (the first step's,
    per parameter), "change_norms" (after the last step, per parameter),
    "names"}."""
    params = [p for _, p in matcher.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = Adam(matcher.named_parameters(), hp["lr"], hp["decay_rate"], hp["start_decay"],
               hp["end_decay"])
    losses, grad_norms = [], None
    for batch, sp_out in zip(batches, sp_outputs):
        loss = step_loss(matcher, batch, sp_out, hp["match_reproj_err"],
                         hp["unmatch_reproj_err"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        del loss
        opt.step(grads)
    change = [float(torch.linalg.vector_norm(p.detach() - s)) for p, s in zip(params, start)]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "names": opt.names}
