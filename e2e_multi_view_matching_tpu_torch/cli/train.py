"""Training entry point: two-stage training around one train step (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/cli/train.py`:

    python -m e2e_multi_view_matching_tpu_torch.cli.train \
        --data_dir ... --checkpoint_dir ... --dataset scannet --tuple_size 5 \
        --batch_size 8 [--pose_loss --init_exp_name <stage1>] [--exp_name <resume>]

`main()` reads `<data_dir>/<dataset>` with `data/tuples.py` (train tuples
with the dataset's color jitter, resampled before every epoch after the
first; validation on rotating subsets of at least 60000 tuples) and runs
`train`. `train(opt, train_batches, val_batches, device="cuda")` is the
loop: models and state
(fresh, resumed with `--exp_name`, or initialized with `--init_exp_name`), the
step loop with `--max_steps` and `--i_train` logging, validation after every
epoch, and the checkpoints `last_model.ckpt`, `{epoch:06d}_model.ckpt`,
`best_model.ckpt` beside `cfg.json`, TensorBoard scalars under
`<checkpoint_dir>/runs/<exp_name>` (not with `--no_tensorboard`) and, with
`--profile_steps start,end`, a profiler trace of those steps under
`<exp_dir>/profile/`. Stage 1 trains the match loss; stage 2
(`--pose_loss --init_exp_name <stage-1 run>`) starts from the stage-1 run's
best weights, adds the confidence MLP and blends in the pose loss of the
weighted eight-point solve on the ramp of `pose_match_ratio`, with the value
clip and the non-finite guard in the optimizer. A caller can feed `train`
its own batches:

    opt = parse_args(["--checkpoint_dir", ckpts, "--dataset", "scannet",
                      "--tuple_size", "5", "--batch_size", "8"])
    state = train(opt, train_batches, val_batches)          # on the GPU

where `train_batches(epoch)` and `val_batches(epoch)` return iterators of
dicts of numpy arrays: images (B, V, H, W, 1), intr (B, V, 3|4, 3|4), poses
(B, V, 4, 4) cam->world, depths (B, V, H, W).

Not ported yet: `--model_parallel` / `--multi_host`, which wait for the ports
of `parallel/mesh.py` and `mvba/distributed.py`.
"""

import argparse
import datetime
import logging
import os

import numpy as np
import torch

from e2e_multi_view_matching_tpu_torch.data.sampling import create_sequential_subsets
from e2e_multi_view_matching_tpu_torch.data.tuples import MatchingTupleDataset, batch_iterator
from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_
from e2e_multi_view_matching_tpu_torch.models.matcher import (
    MatcherConfig,
    MultiViewMatcher,
    default_gnn_layers,
)
from e2e_multi_view_matching_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from e2e_multi_view_matching_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_config,
    save_checkpoint,
    save_config,
)
from e2e_multi_view_matching_tpu_torch.train.optim import build_optimizer, scale_lr
from e2e_multi_view_matching_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from e2e_multi_view_matching_tpu_torch.utils.config import (
    add_generic_arguments,
    apply_dataset_defaults,
    get_exp_dir,
    resolve_device,
    strict_float32,
    to_device,
)
from e2e_multi_view_matching_tpu_torch.utils.tblog import StepProfiler, TBWriter
from e2e_multi_view_matching_tpu_torch.utils.trackers import MeanTracker, TimeTracker

log = logging.getLogger("train")
BATCH_KEYS = ("images", "intr", "poses", "depths")
LOSS_PARTS = ("match_loss", "rot_loss", "transl_loss")  # TensorBoard scalars


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Training multi-view matcher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser = add_generic_arguments(parser)
    parser.add_argument("--exp_name", type=str, default=None,
                        help="experiment to resume; None starts a new run")
    parser.add_argument("--init_exp_name", type=str, default=None,
                        help="experiment to initialize parameters from")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="per-process batch size")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="gradient-accumulation microbatches per step: each step "
                        "takes a batch of batch_size * grad_accum (the effective "
                        "batch of the LR scaling law) one microbatch at a time")
    parser.add_argument("--pose_loss", action="store_true", help="apply a pose loss")
    parser.add_argument("--final_pose_match_ratio", type=float, default=0.99)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--decay_rate", type=float, default=0.999992)
    parser.add_argument("--n_epochs", type=int, default=1000)
    parser.add_argument("--i_train", type=int, default=100,
                        help="log train statistics every n iterations")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor-parallel axis size (only 1 until "
                             "parallel/mesh.py is ported)")
    parser.add_argument("--multi_host", action="store_true",
                        help="multi-process job (not until parallel/mesh.py is "
                             "ported)")
    parser.add_argument("--sinkhorn_iterations", type=int, default=100)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke testing)")
    parser.add_argument("--val_every_epoch", type=int, default=1)
    parser.add_argument("--no_tensorboard", action="store_true")
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="'start,end' step window for a torch.profiler trace")
    parser.add_argument("--dump_first_grad", type=str, default=None,
                        help="debug: save the FIRST step's pre-optimizer gradients "
                             "to <this>_p0.npz (parity testing)")
    opt = parser.parse_args(argv)
    if opt.model_parallel != 1 or opt.multi_host:
        parser.error("--model_parallel and --multi_host wait for the ports of "
                     "parallel/mesh.py and mvba/distributed.py")
    return opt


def build_models(opt, seed=0):
    """SuperPoint (frozen, random fill on) and the matcher for `opt`, their
    weights drawn from `seed` as flax's default initializers draw them."""
    superpoint = SuperPoint(SuperPointConfig(
        nms_radius=opt.nms_radius,
        keypoint_threshold=opt.keypoint_threshold,
        max_keypoints=opt.max_keypoints,
        remove_borders=opt.remove_borders,
        fill_with_random_keypoints=True,
        compute_dtype=getattr(opt, "compute_dtype", "float32"),
    ))
    matcher = MultiViewMatcher(MatcherConfig(
        gnn_layers=default_gnn_layers(opt.gnn_layers, opt.cross_attention_layers),
        sinkhorn_iterations=opt.sinkhorn_iterations,
        conf_mlp=bool(opt.pose_loss),
        multi_frame_matching=opt.tuple_size > 2,
        attention_impl=opt.attention_impl, sinkhorn_impl=opt.sinkhorn_impl,
        compute_dtype=getattr(opt, "compute_dtype", "float32"),
    ))
    g = torch.Generator().manual_seed(seed)
    init_like_flax_(superpoint, g)
    init_like_flax_(matcher, g)
    return superpoint, matcher


def setup_run(opt, device):
    """Settle `opt` before anything reads it: the dataset defaults and the LR
    law, then a resumed run's config (`--exp_name`) or a fresh run's name and
    `cfg.json`. Returns `(exp_dir, resume)`."""
    apply_dataset_defaults(opt, device)
    # the LR law sees the EFFECTIVE batch: per-process batch x accumulation
    opt.lr, opt.decay_rate, opt.start_decay, opt.end_decay = scale_lr(
        opt.tuple_size, opt.batch_size * opt.grad_accum, 1, opt.lr,
        opt.decay_rate, opt.start_decay, opt.end_decay, opt.dataset,
    )

    resume = opt.exp_name is not None
    if resume:
        exp_dir, _ = get_exp_dir(opt.checkpoint_dir, opt.exp_name)
        for k, v in load_config(exp_dir).items():
            if k not in ("exp_name",):
                setattr(opt, k, v)
        opt.exp_name = os.path.basename(exp_dir)
    else:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        opt.exp_name, n = stamp, 0
        # two runs started within one second must not share a directory
        while os.path.exists(get_exp_dir(opt.checkpoint_dir, opt.exp_name)[0]):
            n += 1
            opt.exp_name = f"{stamp}_{n}"
        exp_dir, _ = get_exp_dir(opt.checkpoint_dir, opt.exp_name)
        save_config(exp_dir, dict(vars(opt)))
    log.info("experiment %s", opt.exp_name)
    return exp_dir, resume


def train(opt, train_batches, val_batches, device="cuda"):
    """Run the training loop; returns the final `TrainState`.

    Args:
        opt: `parse_args` namespace (`setup_run` settles it here).
        train_batches, val_batches: callables `epoch -> iterator` of batch
            dicts of numpy arrays (see the module docstring); a train batch
            holds batch_size * grad_accum tuples.
        device: "cuda" by default; raises if no GPU is present.
    """
    device = resolve_device(device)
    exp_dir, resume = setup_run(opt, device)
    return _train_loop(opt, exp_dir, resume, train_batches, val_batches, device)


def _train_loop(opt, exp_dir, resume, train_batches, val_batches, device):
    """`train` on a settled `opt` (see `setup_run`)."""
    strict_float32()
    tb = TBWriter(opt.checkpoint_dir, opt.exp_name, enabled=not opt.no_tensorboard)
    if opt.profile_steps:
        p_start, p_end = (int(x) for x in opt.profile_steps.split(","))
        profiler = StepProfiler(os.path.join(exp_dir, "profile"), p_start, p_end,
                                cuda=device.type == "cuda")
    else:
        profiler = StepProfiler(None, None, None)

    # models / state
    superpoint, matcher = build_models(opt)
    superpoint.to(device).eval()
    matcher.to(device)
    optimizer = build_optimizer(
        matcher.named_parameters(), opt.lr, opt.decay_rate, opt.start_decay,
        opt.end_decay, pose_loss=opt.pose_loss, grad_clip=opt.grad_clip,
    )
    state = TrainState(matcher=matcher, optimizer=optimizer)

    start_epoch = 0
    min_val_loss = 1e6
    if resume:
        state, epoch, min_val_loss, info = load_checkpoint(exp_dir, state, model_id="last")
        start_epoch = epoch + 1
        log.info("resumed from epoch %d (missing=%s)", epoch, info["missing"])
    elif opt.init_exp_name is not None:
        init_dir, _ = get_exp_dir(opt.checkpoint_dir, opt.init_exp_name)
        state, epoch, _, info = load_checkpoint(
            init_dir, state, model_id="best", load_opt_state=opt.pose_loss
        )
        if opt.pose_loss:
            start_epoch = epoch + 1
        log.info("initialized from %s (missing=%s)", opt.init_exp_name, info["missing"])

    train_step = make_train_step(superpoint, opt, grad_accum=opt.grad_accum,
                                 return_grads=bool(opt.dump_first_grad))
    eval_step = make_eval_step(superpoint, opt)

    def device_batch(batch):
        return {k: to_device(batch[k], device) for k in BATCH_KEYS}

    generator = torch.Generator(device=device).manual_seed(1)  # keypoint fill
    time_tracker = TimeTracker()
    metrics_tracker = MeanTracker()
    global_step = start_step = state.step
    try:
        for epoch in range(start_epoch, opt.n_epochs):
            time_tracker.start_epoch()
            for i, batch in enumerate(train_batches(epoch)):
                time_tracker.start_batch()
                profiler.maybe_start(global_step)
                metrics = train_step(state, device_batch(batch), generator)
                if opt.dump_first_grad:
                    grads = metrics.pop("grads")
                    if global_step == start_step:
                        np.savez(f"{opt.dump_first_grad}_p0.npz",
                                 **{n: g.cpu().numpy() for n, g in grads.items()})
                # reading the metrics is the step's one synchronisation
                metrics_tracker.add({k: float(v) for k, v in metrics.items()})
                time_tracker.finish_batch()
                global_step += 1
                profiler.maybe_stop(global_step)
                if (i + 1) % opt.i_train == 0:
                    log.info("epoch %3d it %5d | batch %.3fs | loss %.4f", epoch, i + 1,
                             time_tracker.get_batch_time(), metrics_tracker.get("train_loss"))
                    tb.scalars("loss", {"train": metrics_tracker.get("train_loss")},
                               global_step)
                    if opt.pose_loss:
                        for k in LOSS_PARTS:
                            if metrics_tracker.has(k):
                                tb.scalars(k, {"train": metrics_tracker.get(k)}, global_step)
                    metrics_tracker.reset()
                if opt.max_steps is not None and global_step >= opt.max_steps:
                    break

            # validation + checkpointing
            val_metrics = MeanTracker()
            for batch in val_batches(epoch):
                m = eval_step(state, device_batch(batch), generator)
                val_metrics.add({k: float(v) for k, v in m.items()})
            val_loss = (val_metrics.get("val_loss") if val_metrics.has("val_loss")
                        else float("inf"))
            log.info("epoch %3d | val loss %.4f", epoch, val_loss)
            tb.scalars("loss", {"val": val_loss}, global_step)
            for k in LOSS_PARTS:
                if val_metrics.has(k):
                    tb.scalars(k, {"val": val_metrics.get(k)}, global_step)
            names = ["last_model.ckpt", f"{epoch:06d}_model.ckpt"]
            if val_loss < min_val_loss:
                min_val_loss = val_loss
                names.append("best_model.ckpt")
            for name in names:
                save_checkpoint(exp_dir, name, state, epoch, val_loss)
            if opt.max_steps is not None and global_step >= opt.max_steps:
                break
    finally:
        profiler.close()
        tb.close()
    return state


class TupleBatches:
    """The `train_batches` and `val_batches` callables of `main()`, over the
    ScanNet-format tree `<data_dir>/<dataset>`, for an `opt` that
    `setup_run` has settled (tuples per scene, color jitter).

    Training resamples its tuples before every epoch after the first and
    shuffles with the epoch as the seed; validation walks one subset of at
    least 60000 tuples an epoch, in turn.
    """

    def __init__(self, opt):
        self.batch_size = opt.batch_size * opt.grad_accum
        dataset_dir = os.path.join(opt.data_dir, opt.dataset)
        self.train_set = MatchingTupleDataset(
            dataset_dir, split="train", tuple_size=opt.tuple_size,
            n_samples=opt.n_samples, jitter=opt.color_jitter)
        self.val_set = MatchingTupleDataset(
            dataset_dir, split="val", tuple_size=opt.tuple_size, n_samples=opt.n_samples)
        self.val_subsets = create_sequential_subsets(len(self.val_set), 60000)
        self.val_subset_idx = 0
        self.resample = False
        log.info("loaded %d train / %d val tuples", len(self.train_set), len(self.val_set))

    def train_batches(self, epoch):
        if self.resample:
            self.train_set.start_epoch()
        self.resample = True
        return batch_iterator(self.train_set, self.batch_size, shuffle=True, seed=epoch)

    def val_batches(self, epoch):
        subset = self.val_subsets[self.val_subset_idx]
        self.val_subset_idx = (self.val_subset_idx + 1) % len(self.val_subsets)
        return batch_iterator(self.val_set, self.batch_size, shuffle=False,
                              indices=subset.copy())


def main(argv=None):
    """Train from `--data_dir` on `--device` (cuda unless asked for the
    CPU); returns the final `TrainState`."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    exp_dir, resume = setup_run(opt, device)
    batches = TupleBatches(opt)
    return _train_loop(opt, exp_dir, resume, batches.train_batches, batches.val_batches,
                       device)


if __name__ == "__main__":
    main()
