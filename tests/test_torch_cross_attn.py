"""The cross-view attention of the training path: forward with the LSE stash
and the flash backward (dq, dk/dv) of the PyTorch port against the JAX
package's Pallas kernels.

CPU tests feed the same numpy inputs to both packages; the JAX Pallas
functions run in interpret mode, as the JAX package's own tests run them, and
the port runs its plain versions of the three kernels (what the autograd
function runs on CPU tensors). The hand-written kernels are held against
those plain versions on the card by `tests/test_torch_kernels_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2e_multi_view_matching_tpu.ops import attention_pallas as jpal  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("V,K,dh", [(3, 16, 16), (3, 24, 16)])
def test_plain_twins_match_the_jax_kernels(rng, V, K, dh):
    """O, LSE (JAX's lane 0), dq, dk, dv of the plain twins against JAX's
    `_fused_cross_attention_fwd_lse` and `_fused_cross_attention_bwd` in
    interpret mode: 5e-5 (f32 reduction order, the JAX package's attention
    gradient bound). K = 24 is no multiple of any power of two above 8."""
    BH, S = 4, V * K
    q, k, v, do = (rng.normal(size=(BH, S, dh)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(dh)
    block = jpal._pick_block(K)
    o_ref, lse_ref = jpal._fused_cross_attention_fwd_lse(
        *(jnp.asarray(x) for x in (q, k, v)), scale, V, K, block, True)
    o, lse = ac.cross_attn_fwd_lse_plain(t(q), t(k), t(v), V, K, scale)
    assert lse.shape == (BH, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=5e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=5e-5)
    dvec = (do * o.numpy()).sum(-1).astype(np.float32)
    refs = jpal._fused_cross_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, do)), lse_ref,
        jnp.asarray(np.broadcast_to(dvec[..., None], (BH, S, 128))), scale, V, K, block,
        True)
    grads = ac.cross_attn_bwd_plain(t(q), t(k), t(v), t(do), lse, t(dvec), V, K, scale)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5, err_msg=name)


def test_fused_view_attention_gradient_matches_jax(rng):
    """The cross layer under grad at V = 5, K = 40 (JAX: block 40, flash
    path): the port's autograd function on CPU tensors (split heads, LSE
    stash, dvec, the plain twins, merge) against `jax.grad` of JAX
    `fused_view_attention` in interpret mode: values and gradients 5e-5."""
    V, K, D, h = 5, 40, 32, 2
    q, k, v, w = (rng.normal(size=(2, V * K, D)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jpal.fused_view_attention(q, k, v, h, V, K, "cross", True) * w)

    ref_val, ref = jax.value_and_grad(jloss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = ac.fused_view_attention(qt, kt, vt, h, V, K, "cross")
    assert out.grad_fn is not None and "FusedViewAttention" in type(out.grad_fn).__name__
    loss = (out * t(w)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(ref_val), rtol=5e-5)
    for g, r in zip(torch.autograd.grad(loss, (qt, kt, vt)), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """No fallback: CPU tensors, and a wrong LSE shape, are refused."""
    x = torch.zeros(2, 48, 16)
    r = torch.zeros(2, 48)
    with pytest.raises(ValueError):
        ac.cross_attn_fwd_lse(x, x, x, 3, 16, 0.25)
    with pytest.raises(ValueError):
        ac.cross_attn_bwd_dq(x, x, x, x, r, r, 3, 16, 0.25)
    with pytest.raises(ValueError):
        ac.cross_attn_bwd_dkv(x, x, x, x, r, r, 3, 16, 0.25)
    with pytest.raises(ValueError):
        ac.cross_attn_fwd_lse(x.bfloat16(), x, x, 3, 16, 0.25)
