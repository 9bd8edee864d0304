"""The training step: SuperPoint inference -> GT supervision -> matcher
forward/backward -> optimizer update (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/train/step.py`. Parameters and
BatchNorm statistics live in the matcher module, the moments in the optimizer;
`TrainState` ties them to the step count and the pose-loss ramp. One step
enqueues its work on the device and returns the metrics as device scalars: the
caller's read of them is the step's only synchronisation.
"""

from dataclasses import dataclass

import torch

from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
from e2e_multi_view_matching_tpu_torch.train.losses import combine_losses, matcher_losses

RATIO_INCREMENT = 2.5e-5  # pose_match_ratio ramp per step (stage 2)


@dataclass
class TrainState:
    matcher: torch.nn.Module
    optimizer: object  # train.optim.Adam
    step: int = 0
    pose_match_ratio: float = 0.0


def superpoint_outputs(superpoint, images, generator):
    """Frozen SuperPoint over all B*V frames: (kpts (B, V, K, 2), scores
    (B, V, K), descs (B, V, K, D))."""
    B, V, H, W = images.shape[:4]
    sp_out = superpoint(images.reshape(B * V, H, W, 1), generator=generator)
    K = sp_out["keypoints"].shape[1]
    return (sp_out["keypoints"].reshape(B, V, K, 2), sp_out["scores"].reshape(B, V, K),
            sp_out["descriptors"].reshape(B, V, K, -1))


def tuple_losses(matcher, opt, pose_match_ratio, batch, sp_outputs, train):
    """GT matches, matcher forward and the blended loss of one (micro)batch:
    (total, scaled losses)."""
    kpts, scores, descs = sp_outputs
    B, V, H, W = batch["images"].shape[:4]
    gt_indices, gt_weights = gt_matches_all_pairs(
        kpts, batch["intr"], batch["poses"], batch["depths"],
        opt.match_reproj_err, opt.unmatch_reproj_err)
    image_size = torch.empty((B, V, 2), dtype=torch.float32, device=kpts.device)
    image_size[..., 0] = H  # filled on the device: no host copy, no sync
    image_size[..., 1] = W
    out = matcher(kpts, scores, descs, image_size, train=train,
                  full_output=bool(opt.pose_loss))
    losses = matcher_losses(out, gt_indices, gt_weights, kpts, batch["intr"],
                            batch["poses"], pose_loss=bool(opt.pose_loss))
    n_pairs = opt.tuple_size * (opt.tuple_size - 1) // 2
    return combine_losses(losses, n_pairs, pose_match_ratio, opt.rot_weight,
                          opt.trans_weight)


def make_train_step(superpoint, opt, grad_accum=1, return_grads=False):
    """Build the train step.

    Args:
        superpoint: the frozen SuperPoint module.
        opt: namespace with `pose_loss`, `rot_weight`, `trans_weight`,
            `final_pose_match_ratio`, `match_reproj_err`, `unmatch_reproj_err`,
            `tuple_size`.
        grad_accum: microbatch count. The batch's leading dim splits into
            `grad_accum` microbatches; their gradients, totals and scaled
            losses are averaged before the single optimizer update (the loss
            is sum / batch, so the average equals the full-batch gradient).
            BatchNorm running statistics move once per microbatch.
        return_grads: also return the pre-optimizer gradients by parameter
            name (parity tests compare before Adam, which amplifies ulps on
            near-zero gradients into rate-sized updates).

    Returns:
        train_step(state, batch, generator=None, sp_outputs=None) -> metrics,
        updating `state` in place. batch = dict of device tensors: images
        (B, V, H, W, 1), intr (B, V, 3|4, 3|4), poses (B, V, 4, 4), depths
        (B, V, H, W). `generator` drives the random keypoint fill;
        `sp_outputs` = (kpts, scores, descs) replaces the SuperPoint run.
    """

    def microbatch_grads(state, params, batch, generator, sp_outputs):
        if sp_outputs is None:
            sp_outputs = superpoint_outputs(superpoint, batch["images"], generator)
        total, scaled = tuple_losses(state.matcher, opt, state.pose_match_ratio, batch,
                                sp_outputs, train=True)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        return grads, total.detach(), {k: v.detach() for k, v in scaled.items()}

    def train_step(state, batch, generator=None, sp_outputs=None):
        params = state.optimizer.params
        if grad_accum == 1:
            grads, total, scaled = microbatch_grads(state, params, batch, generator,
                                                    sp_outputs)
        else:
            n = batch["images"].shape[0] // grad_accum
            grads, total, scaled = None, 0.0, {}
            for i in range(grad_accum):
                cut = slice(i * n, (i + 1) * n)
                mb = {k: v[cut] for k, v in batch.items()}
                sp_i = None if sp_outputs is None else tuple(x[cut] for x in sp_outputs)
                g_i, tot_i, scaled_i = microbatch_grads(state, params, mb, generator, sp_i)
                grads = g_i if grads is None else torch._foreach_add(grads, g_i)
                total = total + tot_i
                scaled = {k: scaled.get(k, 0.0) + v for k, v in scaled_i.items()}
            inv = 1.0 / grad_accum
            grads = torch._foreach_mul(list(grads), inv)
            total = total * inv
            scaled = {k: v * inv for k, v in scaled.items()}

        state.optimizer.step(grads)
        if opt.pose_loss and state.pose_match_ratio < opt.final_pose_match_ratio:
            state.pose_match_ratio = min(state.pose_match_ratio + RATIO_INCREMENT, 1.0)
        state.step += 1
        metrics = {"train_loss": total, **scaled}
        if return_grads:
            metrics["grads"] = dict(zip(state.optimizer.names, grads))
        return metrics

    return train_step


def make_eval_step(superpoint, opt):
    """Validation step: the same forward path without grad (so the Sinkhorn
    takes its eval kernel), BatchNorm on running statistics, no update."""

    @torch.no_grad()
    def eval_step(state, batch, generator=None, sp_outputs=None):
        if sp_outputs is None:
            sp_outputs = superpoint_outputs(superpoint, batch["images"], generator)
        total, scaled = tuple_losses(state.matcher, opt, state.pose_match_ratio, batch,
                                sp_outputs, train=False)
        return {"val_loss": total, **scaled}

    return eval_step
