"""bfloat16 training (`--compute_dtype bfloat16` in `cli.train`) of the PyTorch
port against the JAX package's bfloat16 training, on the CPU and the same
seeded inputs.

The cross layers under grad run the three training kernels' bfloat16 plain
twins (what the autograd function runs on CPU tensors; the card holds the
kernels against them): the forward with the float32 LSE stash, and dq and
dk/dv with p and ds rounded to bfloat16 where the Pallas bodies round them.
JAX's Pallas kernels run in interpret mode. The self and full layers take the
VJP of bfloat16 `multi_head_attention`, as JAX's `_bwd` takes that of
`_ref_attention`. The whole train step, stage 1 and stage 2, is held against
JAX's jitted bfloat16 step on bridged weights in both pairings of the
attention implementations, and against JAX's float32 step in the relative
form: the port is no farther from it than JAX's bfloat16 step is, plus a
stated slack. Both packages' steps see JAX's bfloat16 SuperPoint outputs: in
bfloat16 the two SuperPoints order near-tied keypoints differently
(`test_torch_bf16.py` holds them against each other).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.cli import eval_multi_view as jev  # noqa: E402
from e2e_multi_view_matching_tpu.cli import eval_pairs as jep  # noqa: E402
from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu.ops import attention_pallas as jpal  # noqa: E402
from e2e_multi_view_matching_tpu.ops import sinkhorn as jsink  # noqa: E402
from e2e_multi_view_matching_tpu.ops.sinkhorn_pallas import (  # noqa: E402
    log_optimal_transport_pallas,
)
from e2e_multi_view_matching_tpu.train import optim as joptim  # noqa: E402
from e2e_multi_view_matching_tpu.train import step as jstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_pairs as tep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import train as tcli  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as tsink  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import optim as toptim  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import step as tstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.utils import config as tconfig  # noqa: E402
from chip_smoke import _sharp_pair_scores  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

BF16 = torch.bfloat16
B, V, K, H, W, D = 2, 3, 32, 64, 96, 64
SP_CFG = dict(nms_radius=4, keypoint_threshold=0.0, max_keypoints=K, remove_borders=4,
              fill_with_random_keypoints=True, descriptor_dim=D, compute_dtype="bfloat16")
MATCHER_CFG = dict(descriptor_dim=D, keypoint_encoder=(32, 64), gnn_layers=("self", "cross"),
                   num_heads=4, sinkhorn_iterations=20, multi_frame_matching=True)
LR = (1e-3, 0.999992, 100, 1000)
IMPLS = [("xla", "xla"), ("pallas", "cuda")]  # (JAX attention_impl, the port's)
SINKHORN_TOL = 2e-4  # transport probabilities (JAX test_pallas_scaling_kernel_matches_xla)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def bf16_grid(rng, *shape, n=4, scale=2.0):
    """`n` float32 arrays already on the bfloat16 grid."""
    return [np.asarray(torch.from_numpy(scale * rng.normal(size=shape).astype(np.float32))
                       .to(BF16).float()) for _ in range(n)]


def from_jax(x):
    """A JAX array as a torch tensor of its dtype (bfloat16 exactly)."""
    out = torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)))
    return out.to(BF16) if x.dtype == jnp.bfloat16 else out


# ------------------------------------------------------ the kernels' twins

@pytest.mark.parametrize("K_,dh", [(16, 16), (24, 32)])
def test_bf16_twins_match_the_jax_kernels(rng, K_, dh):
    """The bfloat16 twins of the three training kernels against JAX's
    `_fused_cross_attention_fwd_lse` and `_fused_cross_attention_bwd` on the
    same bfloat16 q, k, v, dO in interpret mode, V = 3 (K = 24: query blocks
    and views that are no multiple of 16): O within one bfloat16 ulp of JAX's
    + 1e-6, the float32 LSE within 1e-5 absolute; dq, dk and dv (from JAX's
    LSE and one float32 dvec) within one bfloat16 ulp + 1e-6 + 2^-18 of the
    sum's absolute scale + one ulp of every rounded p or ds times its partner
    (`cross_attn_bwd_bf16_slack`: the two packages sum dp in another order,
    so a rounding of ds to bfloat16 may land on the neighbour)."""
    BH, S = 4, 3 * K_
    q, k, v, do = bf16_grid(rng, BH, S, dh)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(BF16) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(dh)
    block = jpal._pick_block(K_)
    o_ref, lse_ref = jpal._fused_cross_attention_fwd_lse(jq, jk, jv, scale, 3, K_, block, True)
    assert o_ref.dtype == jnp.bfloat16 and lse_ref.dtype == jnp.float32
    o, lse = ac.cross_attn_fwd_lse_plain(tq, tk, tv, 3, K_, scale)
    assert o.dtype == BF16 and lse.dtype == torch.float32 and lse.shape == (BH, S)
    assert ac.bf16_ulp_error(o, from_jax(o_ref)) <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=1e-5)

    lse_t = from_jax(lse_ref[..., 0])
    dvec = (tdo.float() * o.float()).sum(-1)
    refs = jpal._fused_cross_attention_bwd(
        jq, jk, jv, jdo, lse_ref, jnp.asarray(np.broadcast_to(dvec.numpy()[..., None],
                                                              (BH, S, 128))),
        scale, 3, K_, block, True)
    args = (tq, tk, tv, tdo, lse_t, dvec, 3, K_, scale)
    for name, g, r, terms in zip(("dq", "dk", "dv"), ac.cross_attn_bwd_plain(*args), refs,
                                 ac.cross_attn_bwd_bf16_slack(*args)):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16, name
        assert ac.bf16_ulp_error(g, from_jax(r), *terms) <= 1.0, name


@pytest.mark.parametrize("mode", ["cross", "full"])
def test_fused_view_attention_bf16_gradient_matches_jax(rng, mode):
    """`fused_view_attention` under grad on bfloat16 CPU tensors against
    `jax.vjp` of JAX's `fused_view_attention` in interpret mode (4 heads of
    16). Cross (V = 3, K = 24: JAX's flash path, block 24): the LSE forward
    and the bfloat16 twins of dq and dk/dv; the value within one bfloat16 ulp,
    the gradients within the gate of `cross_attn_bwd_bf16_slack` (from the
    port's own O and LSE, on split heads). Full (one view of K = 48): the
    forward is the kernels' twin, the backward the VJP of bfloat16
    `multi_head_attention` in both packages (JAX's `_ref_attention`): value
    one ulp; gradients within one bfloat16 ulp + 2^-7 of the largest |grad|
    of their tensor (measured 2^-9.3: dP is rounded to bfloat16 before the
    softmax's VJP, and the two packages sum dP = g v^T in another order, so
    a rounding may flip there too)."""
    h, dh = 4, 16
    nv, K_ = (3, 24) if mode == "cross" else (1, 48)
    S = nv * K_
    q, k, v, w = bf16_grid(rng, 2, S, h * dh)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref, vjp = jax.vjp(lambda a, b, c: jpal.fused_view_attention(a, b, c, h, nv, K_, mode,
                                                                 True), *jx)
    refs = vjp(jnp.asarray(w, jnp.bfloat16))
    xs = [torch.from_numpy(x).to(BF16).requires_grad_() for x in (q, k, v)]
    out = ac.fused_view_attention(*xs, h, nv, K_, mode)
    assert "FusedViewAttention" in type(out.grad_fn).__name__
    tw = torch.from_numpy(w).to(BF16)
    grads = torch.autograd.grad(out, xs, tw)
    assert ac.bf16_ulp_error(out.detach(), from_jax(ref)) <= 1.0
    if mode == "cross":
        def split(x):
            return x.reshape(2, S, h, dh).transpose(1, 2).reshape(2 * h, S, dh).contiguous()

        qs, ks, vs, ws = (split(x.detach()) for x in (*xs, tw))
        o, lse = ac.cross_attn_fwd_lse_plain(qs, ks, vs, nv, K_, dh ** -0.5)
        dvec = (ws.float() * o.float()).sum(-1)
        slack = ac.cross_attn_bwd_bf16_slack(qs, ks, vs, ws, lse, dvec, nv, K_, dh ** -0.5)
        for g, r, terms in zip(grads, refs, slack):
            assert g.dtype == BF16
            assert ac.bf16_ulp_error(split(g), split(from_jax(r)), *terms) <= 1.0
    else:
        for g, r in zip(grads, refs):
            r = from_jax(r)
            assert g.dtype == BF16
            top = float(r.float().abs().max())
            assert ac.bf16_ulp_error(g, r, flips=torch.full_like(r.float(), top / 128)) <= 1.0


# ------------------------------------------------------------ the train step

def _matcher_vars(cfg, seed=3):
    j32 = jm.MultiViewMatcher(jm.MatcherConfig(**cfg))
    return to_np(j32.init(jax.random.PRNGKey(seed), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
                          jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), float(H))))


def _env(stage2):
    """One batch (plane scenes in stage 1, sphere fields in stage 2), the
    configuration, bridged weights and JAX's bfloat16 SuperPoint outputs."""
    cfg = dict(MATCHER_CFG)
    if stage2:
        cfg.update(conf_mlp=True, conf_mlp_hidden=(32, 16), match_threshold=0.0)
    kw = dict(scene_cls=tsyn.SphereFieldScene) if stage2 else {}
    batch = tsyn.training_batch(np.random.default_rng(0), B, V, H, W, f=80.0, **kw)
    # stage 2: hand-set pose weights (tuple size 3 has none of its own) and the
    # ratio at 0.5, so that the pose term carries half of the loss
    opt = types.SimpleNamespace(
        pose_loss=stage2, rot_weight=2.0 if stage2 else 0.0,
        trans_weight=1.0 if stage2 else 0.0, final_pose_match_ratio=0.99,
        match_reproj_err=3.0, unmatch_reproj_err=6.0, tuple_size=V)
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    sp_vars = j_sp.init({"params": jax.random.PRNGKey(1), "keypoints": jax.random.PRNGKey(2)},
                        jnp.zeros((1, H, W, 1)))
    key = jax.random.PRNGKey(5)
    sp_out = to_np(jax.jit(j_sp.apply)(sp_vars, batch["images"].reshape(B * V, H, W, 1),
                                       rngs={"keypoints": key}))
    sp_outputs = (torch.from_numpy(sp_out["keypoints"].reshape(B, V, K, 2)),
                  torch.from_numpy(sp_out["scores"].reshape(B, V, K)),
                  torch.from_numpy(sp_out["descriptors"].reshape(B, V, K, D)))
    optim_kw = dict(pose_loss=True, grad_clip=0.1) if stage2 else {}
    return types.SimpleNamespace(
        cfg=cfg, batch=batch, opt=opt, j_sp=j_sp, sp_vars=sp_vars, key=key,
        sp_outputs=sp_outputs, m_vars=_matcher_vars(cfg), optim_kw=optim_kw,
        ratio=0.5 if stage2 else 0.0, jax_steps={})


def _jax_step(env, dtype, impl):
    """JAX's jitted train step (cached per dtype and impl): (new state, metrics)."""
    if (dtype, impl) not in env.jax_steps:
        j_m = jm.MultiViewMatcher(jm.MatcherConfig(**env.cfg, compute_dtype=dtype,
                                                   attention_impl=impl))
        tx = joptim.build_optimizer(*LR, **env.optim_kw)
        state = jstep.create_train_state(env.m_vars["params"], env.m_vars["batch_stats"],
                                         tx)._replace(pose_match_ratio=jnp.asarray(env.ratio))
        step = jax.jit(jstep.make_train_step(env.j_sp, j_m, tx, env.opt, return_grads=True))
        new_state, metrics = step(state, env.sp_vars,
                                  {k: jnp.asarray(v) for k, v in env.batch.items()}, env.key)
        env.jax_steps[(dtype, impl)] = (new_state, to_np(metrics))
    return env.jax_steps[(dtype, impl)]


def _port_state(env, impl):
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        **env.cfg, compute_dtype="bfloat16", attention_impl=impl,
        sinkhorn_impl="cuda" if impl == "cuda" else "xla"))
    matcher.load_state_dict(state_dict_from_flax(env.m_vars))
    return tstep.TrainState(matcher=matcher, optimizer=toptim.build_optimizer(
        matcher.named_parameters(), *LR, **env.optim_kw), pose_match_ratio=env.ratio)


@pytest.fixture(scope="module")
def stage1():
    return _env(stage2=False)


@pytest.fixture(scope="module")
def stage2():
    return _env(stage2=True)


def _check_step(env, impls, loss_rtol, grad_worst, grad_median, bs_atol, f32_slack):
    """One bfloat16 step of the port against JAX's (the tolerances are the
    caller's), and against JAX's float32 step in the relative form."""
    new_state, metrics = _jax_step(env, "bfloat16", impls[0])
    _, metrics32 = _jax_step(env, "float32", "xla")
    state = _port_state(env, impls[1])
    out = tstep.make_train_step(None, env.opt, return_grads=True)(
        state, {k: torch.from_numpy(v) for k, v in env.batch.items()}, None, env.sp_outputs)
    assert state.step == int(new_state.step) == 1
    for k in ("train_loss", "match_loss", "rot_loss", "transl_loss"):
        np.testing.assert_allclose(float(out[k]), float(metrics[k]), rtol=loss_rtol, err_msg=k)

    ref, ref32 = flat(metrics["grads"]), flat(metrics32["grads"])
    ours = flat(flax_from_state_dict(out["grads"])["params"])
    assert set(ours) == set(ref) and len(ref) > 30
    assert all(g.dtype == torch.float32 for g in out["grads"].values())
    top = max(np.linalg.norm(g) for g in ref32.values())
    diffs = {k: np.linalg.norm(ours[k] - ref[k]) / top for k in ref}
    assert max(diffs.values()) <= grad_worst, max(diffs, key=diffs.get)
    assert np.median(list(diffs.values())) <= grad_median
    for k in ref:  # no farther from float32 than JAX's bfloat16 step is, + the slack
        assert (np.linalg.norm(ours[k] - ref32[k]) / top
                <= np.linalg.norm(ref[k] - ref32[k]) / top + f32_slack), k

    after = flax_from_state_dict(state.matcher.state_dict())
    ref_bs, ours_bs = flat(to_np(new_state.batch_stats)), flat(after["batch_stats"])
    assert set(ref_bs) == set(ours_bs)
    for k in ref_bs:
        np.testing.assert_allclose(ours_bs[k], ref_bs[k], atol=bs_atol, err_msg=k)
    assert all(p.dtype == torch.float32 for p in state.matcher.parameters())
    # after Adam: one learning rate (1e-3) at most, and most entries alike
    # (Adam turns flips of near-zero gradients into rate-sized steps)
    ref_p, ours_p = flat(to_np(new_state.params)), flat(after["params"])
    d = np.concatenate([np.abs(ours_p[k] - ref_p[k]).ravel() for k in ref_p])
    assert d.max() <= 2.5e-3 and np.mean(d <= 1e-5) >= 0.97
    return out


@pytest.mark.parametrize("impls", IMPLS, ids=["xla", "pallas-cuda"])
def test_bf16_train_step_matches_jax(stage1, impls):
    """One bfloat16 stage-1 step (two GNN layers, K = 32, 20 iterations) of the
    port against JAX's jitted bfloat16 step on bridged weights and the same
    SuperPoint outputs: JAX "xla" against the port's "xla", JAX "pallas"
    (interpret) against the port's "cuda" on CPU tensors. Loss 1e-3 relative
    (measured 1.3e-4 in both: bfloat16 roundings that flip in one package);
    gradient leaves within 5e-2 of the largest float32 leaf norm (measured
    2.2e-2 and 1.9e-2, on the first keypoint-encoder layer's bias, in front of
    a BatchNorm, whose true gradient is ~0) and 5e-3 on the median leaf
    (measured 1.6e-3, 1.5e-3); every leaf no farther from JAX's float32 step
    than JAX's bfloat16 step is + 1e-2 of the largest norm (measured 2.6e-3,
    1.7e-3; bfloat16 itself is up to 0.15 away); running statistics 1e-3
    (measured 1.1e-4, 8e-5, on statistics that move by 0.17); parameters,
    gradients and Adam float32."""
    _check_step(stage1, impls, 1e-3, 5e-2, 5e-3, 1e-3, 1e-2)


@pytest.mark.parametrize("impls", IMPLS, ids=["xla", "pallas-cuda"])
def test_bf16_stage2_step_matches_jax(stage2, impls):
    """One bfloat16 stage-2 step (the conf MLP in bfloat16, the pose loss of
    the weighted eight-point solve at ratio 0.5, value clip and guard) the
    same way. Losses 5e-3 relative (measured up to 8.8e-4 on the pose terms);
    gradient leaves 6e-2 of the largest norm, median 5e-3 (measured 2.4e-2,
    1.5e-3); each leaf no farther from JAX's float32 step than JAX's bfloat16
    step + 1.5e-2 (measured 5.2e-3); running statistics 2e-3 (measured
    4.2e-4)."""
    out = _check_step(stage2, impls, 5e-3, 6e-2, 5e-3, 2e-3, 1.5e-2)
    assert float(out["rot_loss"]) > 0 and float(out["transl_loss"]) > 0
    assert any(k.startswith("conf_mlp.") for k in out["grads"])


def test_bf16_eval_step_and_grad_accum(stage1):
    """Validation in bfloat16: the port's eval step against JAX's jitted
    bfloat16 eval step on the same SuperPoint outputs (loss 1e-3 relative,
    as the train step), no update and no gradient. grad_accum = 2 on a
    duplicated batch gives the full batch's step (each microbatch is the
    full batch; loss 1e-5 relative, gradients 1e-5 of the largest norm)."""
    env = stage1
    j_m = jm.MultiViewMatcher(jm.MatcherConfig(**env.cfg, compute_dtype="bfloat16"))
    tx = joptim.build_optimizer(*LR)
    j_state = jstep.create_train_state(env.m_vars["params"], env.m_vars["batch_stats"], tx)
    ref = to_np(jax.jit(jstep.make_eval_step(env.j_sp, j_m, env.opt))(
        j_state, env.sp_vars, {k: jnp.asarray(v) for k, v in env.batch.items()}, env.key))
    state = _port_state(env, "cuda")
    before = {k: v.clone() for k, v in state.matcher.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in env.batch.items()}
    out = tstep.make_eval_step(None, env.opt)(state, batch, None, env.sp_outputs)
    np.testing.assert_allclose(float(out["val_loss"]), float(ref["val_loss"]), rtol=1e-3)
    assert not out["val_loss"].requires_grad
    for k, v in state.matcher.state_dict().items():
        assert torch.equal(v, before[k]), k

    dup = {k: torch.cat([v, v]) for k, v in batch.items()}
    dup_sp = tuple(torch.cat([x, x]) for x in env.sp_outputs)
    one = tstep.make_train_step(None, env.opt, return_grads=True)(
        _port_state(env, "cuda"), batch, None, env.sp_outputs)
    two = tstep.make_train_step(None, env.opt, grad_accum=2, return_grads=True)(
        _port_state(env, "cuda"), dup, None, dup_sp)
    np.testing.assert_allclose(float(two["train_loss"]), float(one["train_loss"]), rtol=1e-5)
    top = max(float(g.norm()) for g in one["grads"].values())
    for k, g in one["grads"].items():
        assert float((two["grads"][k] - g).norm()) <= 1e-5 * top, k


def test_superpoint_bf16_keeps_the_training_contract():
    """SuperPoint with the bfloat16 trunk and the random keypoint fill on (the
    training contract): frozen and without grad, float32 outputs, K slots
    per frame with the empty ones filled at random (score 0) inside the
    image; the detected keypoints overlap JAX's bfloat16 detections > 0.8 (as
    `test_torch_bf16.py` asks: top-K ties order differently)."""
    # more slots than a 64 x 96 frame has NMS maxima: some are filled
    cfg = dict(SP_CFG, max_keypoints=160)
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**cfg))
    sp_vars = j_sp.init({"params": jax.random.PRNGKey(1), "keypoints": jax.random.PRNGKey(2)},
                        jnp.zeros((1, H, W, 1)))
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**cfg)).eval()
    sp.load_state_dict(state_dict_from_flax(to_np(sp_vars)))
    images = tsyn.training_batch(np.random.default_rng(3), 1, V, H, W, f=80.0)["images"]
    images = images.reshape(V, H, W, 1)
    ref = to_np(jax.jit(j_sp.apply)(sp_vars, images, rngs={"keypoints": jax.random.PRNGKey(0)}))
    with torch.enable_grad():
        out = sp(torch.from_numpy(images), generator=torch.Generator().manual_seed(0))
    assert all(v.dtype == torch.float32 and not v.requires_grad for v in out.values())
    kp, sc = out["keypoints"].numpy(), out["scores"].numpy()
    assert kp.shape == (V, 160, 2) and np.isfinite(out["descriptors"].numpy()).all()
    filled = sc == 0
    assert filled.any() and (~filled).sum() >= 16  # some of each
    assert (kp[..., 0] >= 0).all() and (kp[..., 0] < W).all()
    assert (kp[..., 1] >= 0).all() and (kp[..., 1] < H).all()
    for f in range(V):
        ours = {tuple(x) for x in kp[f][~filled[f]].astype(int)}
        theirs = {tuple(x) for x in ref["keypoints"][f][ref["scores"][f] > 0].astype(int)}
        assert len(ours & theirs) > 0.8 * len(theirs)


def test_cli_train_bf16_stage1_then_stage2(tmp_path, monkeypatch):
    """`cli.train.train --compute_dtype bfloat16` on the CPU, stage 1 (two
    steps, grad_accum 2, the first step's gradients dumped) then stage 2
    (`--pose_loss --init_exp_name`) on sphere-field pairs: finite losses,
    float32 parameters, float32 finite gradients in the dump, checkpoints,
    bfloat16 models, and `strict_float32` in force (TF32 and cuBLAS's
    reduced-precision bfloat16 sums off)."""
    full = tconfig.apply_dataset_defaults

    def small(opt, device):
        full(opt, device)
        opt.max_keypoints, opt.remove_borders, opt.keypoint_threshold = 16, 4, 0.0
        opt.gnn_layers, opt.cross_attention_layers = 1, 1
        opt.match_reproj_err, opt.unmatch_reproj_err = 3.0, 6.0
        return opt

    monkeypatch.setattr(tcli, "apply_dataset_defaults", small)
    rng = np.random.default_rng(1)
    batches = [tsyn.training_batch(rng, 4, 2, H, W, f=80.0, scene_cls=tsyn.SphereFieldScene)
               for _ in range(2)]
    feed = lambda epoch: iter(batches)  # noqa: E731
    common = ["--checkpoint_dir", str(tmp_path), "--dataset", "scannet", "--tuple_size", "2",
              "--batch_size", "2", "--sinkhorn_iterations", "10", "--i_train", "1",
              "--no_tensorboard", "--compute_dtype", "bfloat16", "--attention_impl", "cuda",
              "--sinkhorn_impl", "cuda"]
    flags = ((torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(m, a) for m, a in flags]
    logged = []
    monkeypatch.setattr(tcli.log, "info", lambda msg, *a: logged.append(msg % a))
    dump = str(tmp_path / "grads")
    try:
        for m, a in flags:
            setattr(m, a, True)
        opt1 = tcli.parse_args(common + ["--n_epochs", "1", "--max_steps", "2",
                                         "--grad_accum", "2", "--dump_first_grad", dump])
        assert opt1.compute_dtype == "bfloat16"
        stage1 = tcli.train(opt1, feed, feed, device="cpu")
        assert [getattr(m, a) for m, a in flags] == [False] * 3
    finally:
        for (m, a), v in zip(flags, saved):
            setattr(m, a, v)
    assert stage1.step == 2 and stage1.matcher.config.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in stage1.matcher.parameters())
    grads = np.load(dump + "_p0.npz")
    assert set(grads.files) == set(stage1.optimizer.names)
    assert all(grads[k].dtype == np.float32 and np.isfinite(grads[k]).all() for k in grads.files)

    opt2 = tcli.parse_args(common + ["--pose_loss", "--init_exp_name", opt1.exp_name,
                                     "--n_epochs", "2", "--max_steps", "4"])
    stage2 = tcli.train(opt2, feed, feed, device="cpu")
    assert stage2.step == 4 and hasattr(stage2.matcher, "conf_mlp")
    assert int(stage2.optimizer.skipped) == 0
    assert (tmp_path / opt2.exp_name / "000001_model.ckpt").exists()
    losses = [float(m.rsplit(" ", 1)[1]) for m in logged if " it " in m]
    val = [float(m.rsplit(" ", 1)[1]) for m in logged if "val loss" in m]
    assert len(losses) == 4 and len(val) == 2 and np.all(np.isfinite(losses + val))


# ------------------------------------------------------------ command lines

def test_eval_cli_flags_match_jax():
    """Both eval command lines take JAX's flags, names and defaults, plus
    `--device`; `--data_parallel` above 1 is refused until the distributed
    modes are ported (the multi-view one names its flag like JAX's)."""
    for ours_mod, ref_mod in ((tev, jev), (tep, jep)):
        ours, ref = vars(ours_mod.parse_args([])), vars(ref_mod.parse_args([]))
        assert set(ours) == set(ref) | {"device"}, ours_mod.__name__
        for k in ref:
            assert ours[k] == ref[k], (ours_mod.__name__, k)
        assert ours_mod.parse_args(["--data_parallel", "1"]).data_parallel == 1
        with pytest.raises(SystemExit):
            ours_mod.parse_args(["--data_parallel", "2"])


# ----------------------------------------------------------- Sinkhorn, sharp

def test_scaling_twin_at_sharp_scores_is_no_farther_from_float64_than_jax():
    """`sinkhorn_scaling`'s plain twin (the scaling-domain iteration the
    kernel is held to) and JAX's `log_optimal_transport_pallas` (interpret
    mode) against the float64 log-domain Sinkhorn at the same 100
    iterations, on `chip_smoke._sharp_pair_scores` (a seeded two-view matcher
    at the default widths with its final projection x 4; |s| ~ 1e4-4e4) at K = 64 and 128, four
    seeds each, and at K = 512, one seed, in max |p - p64| / max(1, p64):
    over the nine draws the port is no farther from float64 than JAX is, +
    SINKHORN_TOL (measured: the twin 1.1e-4 to 6.5e-4 at K <= 128 and 1.6e-3
    at K = 512, JAX's kernel 2.3e-4 to 6.7e-4 and 0.18, each the nearer on
    some small draws; the scaling iteration in float64 is within 3e-10 of the
    log domain, so both distances are float32 rounding in the scaling domain
    at sharp scores). The twin is JAX's own plain scaling iteration
    (`impl="mxu"`) within SINKHORN_TOL (measured 1.5e-5: the order of the
    sums)."""
    far = {"port": [], "jax": []}
    for K_, seeds in ((64, range(4)), (128, range(4)), (512, range(1))):
        for seed in seeds:
            s, alpha = _sharp_pair_scores(K_, seed, "cpu")
            assert float(s.abs().max()) > 5e3
            with torch.no_grad():
                p64 = tsink.log_optimal_transport(s.double(), alpha, 100, impl="xla").exp()
                port = sinkhorn_cuda.log_optimal_transport_cuda(s, alpha, 100).double().exp()
            js = jnp.asarray(s.numpy())
            jx = np.exp(np.asarray(log_optimal_transport_pallas(js, alpha, 100, interpret=True),
                                   np.float64))
            jmxu = np.exp(np.asarray(jsink.log_optimal_transport(js, alpha, 100, impl="mxu"),
                                     np.float64))
            p64 = p64.numpy()
            for name, p in (("port", port.numpy()), ("jax", jx)):
                far[name].append(float(np.max(np.abs(p - p64) / np.maximum(p64, 1.0))))
            assert float(np.max(np.abs(port.numpy() - jmxu) / np.maximum(jmxu, 1.0))) \
                <= SINKHORN_TOL
    assert max(far["port"]) <= max(far["jax"]) + SINKHORN_TOL, far
