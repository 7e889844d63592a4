"""The plain versions of kernels K1/K2 and their autograd.Function, against
paa_tpu's fused Pallas attention in interpret mode (float32, CPU). The
kernels themselves are held against these plain versions on a GPU in
tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops.pallas import attention as jattn
from paa_tpu_torch.ops.kernels import attention

B, H, D = 2, 3, 16
TOL = 3e-5  # float32, as tests/test_pallas_attention.py holds the Pallas kernel


def _inputs(T, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) * 0.5 for _ in range(3))
    ct = np.random.default_rng(7).standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, ct


def _jax(q, k, v, ct):
    f = lambda a, b, c: jattn.fused_attention(a, b, c, interpret=True)
    out = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * ct), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("T", [128, 130, 499])
def test_function_and_plain_match_pallas(T):
    q, k, v, ct = _inputs(T)
    want_o, want_g = _jax(q, k, v, ct)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = attention.attention(*leaves)
    (o * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), want_o, rtol=TOL, atol=TOL)
    for leaf, want, name in zip(leaves, want_g, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=TOL, atol=TOL, err_msg=name)

    # the plain forward under autograd: the reference the kernels meet on the card
    leaves = [torch.from_numpy(x.reshape(B, T, H * D)).requires_grad_(True) for x in (q, k, v)]
    o_plain, lse = attention.attention_fwd_plain(*leaves, H)
    (o_plain * torch.from_numpy(ct.reshape(B, T, H * D))).sum().backward()
    np.testing.assert_allclose(o_plain.detach().numpy().reshape(B, T, H, D), want_o,
                               rtol=TOL, atol=TOL)
    for leaf, want, name in zip(leaves, want_g, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy().reshape(B, T, H, D), want,
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert lse.shape == (B, H, T)


def test_lse_is_the_row_logsumexp():
    q, k, v, _ = _inputs(130)
    flat = lambda x: torch.from_numpy(x.reshape(B, 130, H * D))
    _, lse = attention.attention_fwd(flat(q), flat(k), flat(v), H)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_plain_stays_within_bf16_noise():
    """In bf16, the plain versions return bf16 and stay within bf16 noise of
    the float32 result."""
    q, k, v, ct = _inputs(130)
    flat = lambda x: torch.from_numpy(x.reshape(B, 130, H * D))
    f32 = [flat(x) for x in (q, k, v, ct)]
    b16 = [t.bfloat16() for t in f32]
    o32, lse32 = attention.attention_fwd(*f32[:3], H)
    o16, lse16 = attention.attention_fwd(*b16[:3], H)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert float((o16.float() - o32).abs().max()) < 2e-2
    g32 = attention.attention_bwd(*f32[:3], o32, lse32, f32[3], H)
    g16 = attention.attention_bwd(*b16[:3], o16, lse16, b16[3], H)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) < 2e-2 * float(b.abs().max())


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    """The shape checks run before any CUDA call, so they hold on the CPU."""
    q = torch.zeros(2, 10, 3 * 16)
    if bad == "head_dim":
        with pytest.raises(ValueError, match="head dim"):
            attention._check("t", 2, q)  # d = 24
    elif bad == "dtype":
        with pytest.raises(ValueError, match="dtype"):
            attention._check("t", 3, q.half())
    else:
        with pytest.raises(ValueError, match="contiguous"):
            attention._check("t", 3, q, q.transpose(0, 1).contiguous().transpose(0, 1))
