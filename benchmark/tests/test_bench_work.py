"""The benchmark's work arithmetic against counts made by hand."""

import pytest

from benchmark.harness import work


def test_attention_forward_counts():
    # BH 2, S 3 queries, 5 keys, dh 4: 30 (query, key) pairs
    ops, nbytes, exps = work.attn_fwd(2, 3, 5, 4)
    assert ops == 30 * 4 * 4 + 30  # two FMAs a pair and head dimension, one exp
    assert nbytes == 4 * 2 * 3 * 4 * 4  # q, k, v read, o written: 4 (BH S dh) floats
    assert exps == 30


def test_attention_training_counts():
    pairs, rows = 2 * 3 * 5, 2 * 3
    assert work.attn_fwd_lse(2, 3, 5, 4) == (pairs * 17, 4 * (4 * rows * 4 + rows), pairs)
    assert work.attn_bwd_dq(2, 3, 5, 4) == (pairs * 27, 4 * (5 * rows * 4 + 2 * rows), pairs)
    assert work.attn_bwd_dkv(2, 3, 5, 4) == (pairs * 35, 4 * (6 * rows * 4 + 2 * rows), pairs)


def test_attention_shapes_of_a_cell():
    s = {"batch": 2, "views": 5, "kpts": 7, "dim": 256, "heads": 4}
    shapes = work.attention_shapes(s)
    assert shapes["self"] == (2 * 5 * 4, 7, 7, 64)
    assert shapes["cross"] == (2 * 4, 5 * 7, 4 * 7, 64)


def test_sinkhorn_counts():
    # 3 matrices of 2 x 2, 10 iterations: one absorption
    elems = 3 * 2 * 2
    ops, nbytes, exps = work.sinkhorn_scaling(3, 2, 2, 10)
    assert ops == elems * (4 * 9 + 6 + 3 + 3)
    assert nbytes == 2 * elems * 4 and exps == elems * 3
    ops, nbytes, exps = work.sinkhorn_log_stash(3, 2, 2, 10)
    assert ops == elems * 103 and exps == elems * 20
    assert nbytes == 2 * 4 * elems + 4 * 3 * 10 * 4  # duals: T (M + N) floats a matrix
    ops, nbytes, exps = work.sinkhorn_bwd(3, 2, 2, 10)
    assert ops == elems * 120 and exps == elems * 20


def test_bound_takes_the_binding_resource():
    assert work.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(1.0, 1.0, work.PEAK_EXPS) == pytest.approx(1.0)


def test_superpoint_flops_by_hand():
    # 16 x 16: the full-resolution convs at 256 pixels, then 64, 16 and 4
    by_hand = 2 * (256 * (1 * 64 + 64 * 64) * 9 + 64 * (64 * 64 * 2) * 9
                   + 16 * (64 * 128 + 128 * 128) * 9
                   + 4 * ((128 * 128 * 2 + 128 * 256 * 2) * 9 + 256 * 65 + 256 * 256))
    assert work.superpoint_flops(16, 16) == by_hand


def test_matcher_flops_by_hand():
    s = {"batch": 1, "views": 2, "kpts": 3, "dim": 4, "heads": 2, "layers": ("self", "cross"),
         "sinkhorn_iters": 1, "conf_mlp": True, "keypoint_encoder": (2,),
         "conf_mlp_hidden": (3,)}
    tokens = 6
    kenc = 2 * tokens * (3 * 2 + 2 * 4)
    layer = 2 * tokens * (4 * 16 + 8 * 8 + 8 * 4)
    attn = 4 * (2 * 2 * 3 * 3 * 2) + 4 * (1 * 2 * 6 * 3 * 2)  # self, then cross
    final = 2 * tokens * 16
    scores = 2 * 1 * 1 * 3 * 3 * 4
    conf = 2 * 3 * (9 * 3 + 3 * 1)
    assert work.matcher_flops(s) == kenc + 2 * layer + attn + final + scores + conf
    assert work.train_step_flops({**s, "height": 8, "width": 8}) == (
        2 * work.superpoint_flops(8, 8) + 3 * work.matcher_flops(s))
