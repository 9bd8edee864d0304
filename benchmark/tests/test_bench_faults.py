"""Whole runs of both cells at CPU-test sizes, the look for a card skipped:
a sound program comes out correct, and a program broken underneath the
timed path comes out not correct, once for each fault the cell can have
(one chip: no exchange between chips to leave out)."""

import pytest
import torch

import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, patch=None, seed=7):
    return tiny.run_cell(*root, cell, seed=seed, patch=patch)


def _failed(result):
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", ["megadepth5-eval", "scannet5-train"])
def test_sound_runs_are_correct(root, cell):
    result = _run(root, cell, seed=3_000_000_011)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _wrap(monkeypatch, module, name, make):
    original = getattr(module, name)
    monkeypatch.setattr(module, name, make(original))


def test_eval_match_moved(root, monkeypatch):
    """One match of each sub-chunk moved where the matcher produces it."""
    from e2e_multi_view_matching_tpu_torch.models import matcher

    def make(original):
        def forward(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            m0 = out["matches0"]
            K = m0.shape[-1]
            m0[0, 0, 0] = (m0[0, 0, 0] + 1) % K if m0[0, 0, 0] >= 0 else 0
            return out
        return forward

    _wrap(monkeypatch, matcher.MultiViewMatcher, "forward", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and "matches_off" in _failed(result)


def test_eval_sinkhorn_round_left_out(root, monkeypatch):
    """The Sinkhorn runs one round fewer than the configuration states: ten
    iterations, since the scaling domain counts them in rounds of ten."""
    from e2e_multi_view_matching_tpu_torch.models import matcher

    def make(original):
        def log_optimal_transport(scores, alpha, iters, *args, **kwargs):
            return original(scores, alpha, iters - 10, *args, **kwargs)
        return log_optimal_transport

    _wrap(monkeypatch, matcher, "log_optimal_transport", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and "sinkhorn_err" in _failed(result)


def test_eval_attention_altered(root, monkeypatch):
    """Every attention message scaled by 1.001 where the GNN produces it."""
    from e2e_multi_view_matching_tpu_torch.models import matcher

    def make(original):
        def forward(self, *args, **kwargs):
            return original(self, *args, **kwargs) * 1.001
        return forward

    _wrap(monkeypatch, matcher.AttentionalLayer, "forward", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and "gnn_err" in _failed(result)


def test_eval_answer_altered(root, monkeypatch):
    """One confidence of each sub-chunk raised where the matcher produces it."""
    from e2e_multi_view_matching_tpu_torch.models import matcher

    def make(original):
        def forward(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            out["conf_scores"][0, 0, 0] += 0.01
            return out
        return forward

    _wrap(monkeypatch, matcher.MultiViewMatcher, "forward", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and "conf_err" in _failed(result)


def test_eval_keypoint_altered(root, monkeypatch):
    """One keypoint of each sub-chunk moved by a pixel where SuperPoint
    produces it."""
    from e2e_multi_view_matching_tpu_torch.models import superpoint

    def make(original):
        def forward(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            out["keypoints"][0, 0, 0] += 1.0
            return out
        return forward

    _wrap(monkeypatch, superpoint.SuperPoint, "forward", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and {"kp_gap", "desc_err"} & set(_failed(result))


def test_eval_pose_altered(root, monkeypatch):
    """The pose stage's extrinsics of one view rotated where they are made."""
    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view

    def make(original):
        def pose(*args, **kwargs):
            extr = original(*args, **kwargs).clone()
            c, s = 0.9, 0.4358898943540674
            rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            extr[:, 1, :3, :3] = rot @ extr[:, 1, :3, :3]
            return extr
        return pose

    _wrap(monkeypatch, eval_multi_view, "multi_view_pose_device", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"] and "pose_gap" in _failed(result)


def test_eval_half_batch_left_out(root, monkeypatch):
    """SuperPoint runs on the first half of the sub-chunk's frames and
    hands their outputs to the second half too."""
    from e2e_multi_view_matching_tpu_torch.models import superpoint

    def make(original):
        def forward(self, image, *args, **kwargs):
            half = image.shape[0] // 2
            out = original(self, image[:half], *args, **kwargs)
            return {k: torch.cat([v, v[:image.shape[0] - half]]) for k, v in out.items()}
        return forward

    _wrap(monkeypatch, superpoint.SuperPoint, "forward", make)
    result = _run(root, "megadepth5-eval")
    assert not result["correct"]


def test_train_state_unchanged(root, monkeypatch):
    """The optimizer's step returns the state as it found it."""
    from e2e_multi_view_matching_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self, grads: None)
    result = _run(root, "scannet5-train")
    assert not result["correct"] and "change_gap" in _failed(result)


def test_train_half_batch_left_out(root, monkeypatch):
    """The step takes the first half of the batch, the loss the mean over it."""
    from e2e_multi_view_matching_tpu_torch.train import step

    def make(original):
        def make_train_step(*args, **kwargs):
            train_step = original(*args, **kwargs)

            def half_step(state, batch, *a, **k):
                n = batch["images"].shape[0] // 2
                return train_step(state, {key: v[:n] for key, v in batch.items()}, *a, **k)
            return half_step
        return make_train_step

    _wrap(monkeypatch, step, "make_train_step", make)
    result = _run(root, "scannet5-train")
    assert not result["correct"]


def test_train_loss_altered(root, monkeypatch):
    """The match loss, and so every gradient, scaled by 1.1 where it is
    produced."""
    from e2e_multi_view_matching_tpu_torch.train import step

    def make(original):
        def matcher_losses(*args, **kwargs):
            out = original(*args, **kwargs)
            return {**out, "match_loss": out["match_loss"] * 1.1}
        return matcher_losses

    _wrap(monkeypatch, step, "matcher_losses", make)
    result = _run(root, "scannet5-train")
    assert not result["correct"] and "grad_gap" in _failed(result)


def test_train_keypoint_altered(root, monkeypatch):
    """One keypoint of each step moved by a pixel where the training step's
    SuperPoint produces it."""
    from e2e_multi_view_matching_tpu_torch.models import superpoint

    def make(original):
        def forward(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            out["keypoints"][0, 0] += 1.0
            return out
        return forward

    _wrap(monkeypatch, superpoint.SuperPoint, "forward", make)
    result = _run(root, "scannet5-train")
    assert not result["correct"] and {"kp_gap", "desc_err"} & set(_failed(result))
