"""The port's feature-extractor conv lowerings (``conv_impl``) and
``fused_qkv`` against paa_tpu.models.wav2vec2's, float32 on the CPU, with the
same weights carried across by params_from_jax; ``_HybridConvFn`` and each
lowering alone against stock autograd of ``F.conv1d``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v

IMPLS = ["hybrid", "pairdot", "im2col", "tapdot"]
# the lv60 preset's four flags on the tiny widths
LV60_FLAGS = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
                  do_normalize=True)
PRESETS = {"tiny": ("wav2vec2-tiny", {}), "lv60_flags": ("wav2vec2-tiny", LV60_FLAGS)}


def _randomize_affine(params, seed):
    """Biases N(0, 0.1) and norm scales 1 + N(0, 0.1) in place of the 0/1
    initial values, so that every conv bias and norm scale is seen."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("bias", "conv_bias"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        if name == "scale":
            return 1.0 + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return np.array(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(preset, seed=0, **over):
    """The JAX model and the port's model on the same random weights (every
    bias and norm scale drawn), both with ``over``."""
    jc = jw2v.get_config(preset, compute_dtype="float32", **over)
    params = _randomize_affine(jw2v.init_params(jc, seed=seed, example_len=2000), seed + 1)
    tc = tw2v.get_config(preset, compute_dtype="float32", **over)
    model = tw2v.Wav2Vec2ForCTC(tc)
    model.load_state_dict(convert.params_from_jax(params, tc))
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    return (lambda a: jmodel.apply({"params": params}, a)), model.eval()


@functools.lru_cache(maxsize=None)
def _model_run(impl, preset):
    """Logits and ∂(Σ logits·ct)/∂audio of both packages under ``impl``, at
    0.25 s (12 frames) on two rows."""
    name, flags = PRESETS[preset]
    japply, model = _pair(name, **flags, conv_impl=impl)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((2, 12, 32)).astype(np.float32)

    def loss(a):
        logits = japply(a)
        return jnp.sum(logits * ct), logits

    (_, want), want_grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(audio))
    x = torch.from_numpy(audio).requires_grad_(True)
    got = model(x)
    (got * torch.from_numpy(ct)).sum().backward()
    assert model.cfg.conv_impl == impl
    return (got.detach().numpy(), np.asarray(want)), (x.grad.numpy(), np.asarray(want_grad))


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("impl", IMPLS)
def test_lowering_logits_match_jax(impl, preset):
    """Tolerance 2e-4, as the conv lowering's (test_torch_wav2vec2.py):
    float32 sums in another order through the stack and 2 layers."""
    (got, want), _ = _model_run(impl, preset)
    assert got.shape == want.shape == (2, 12, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("impl", IMPLS)
def test_lowering_grad_wrt_audio_matches_jax(impl, preset):
    """Tolerance 1e-3 of the gradient's largest value, as
    ``test_grad_wrt_audio_matches_jax``'s."""
    _, (got, want) = _model_run(impl, preset)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


# (T, C, O, k, s): layer-0-like, layer-1-like with the phase grid longer
# than T (T odd) and shorter (T even), k == s, and k % s != 0 with nb = 2
# (the JAX package's test_hybrid_conv_grads_match_autodiff)
GEOMETRIES = [(1009, 1, 16, 10, 5), (501, 8, 16, 3, 2), (500, 8, 16, 3, 2), (64, 8, 16, 2, 2),
              (37, 4, 8, 5, 3)]
GEOM_IDS = ["T{}_C{}_O{}_k{}_s{}".format(*g) for g in GEOMETRIES]


def _conv_grads(fn, x, w, ct):
    """fn(x, w) and the gradients of Σ cos(fn(x, w))·ct."""
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(x, w)
    (torch.cos(y) * ct).sum().backward()
    return y.detach(), x.grad, w.grad


def _geometry(T, C, O, k, s):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((O, C, k)).astype(np.float32) * 0.1)
    ct = torch.from_numpy(rng.standard_normal((2, (T - k) // s + 1, O)).astype(np.float32))
    ref = _conv_grads(lambda x_, w_: F.conv1d(x_.transpose(1, 2), w_, None, s).transpose(1, 2),
                      x, w, ct)
    return x, w, ct, ref


@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOM_IDS)
def test_hybrid_conv_grads_match_autograd(geom):
    """``_HybridConvFn``'s input and weight gradients (its phase-matmul
    backward) against stock autograd of ``F.conv1d``, float32, within 1e-5;
    the forward is ``F.conv1d``'s own."""
    x, w, ct, (y0, dx0, dw0) = _geometry(*geom)
    s = geom[4]
    y, dx, dw = _conv_grads(lambda x_, w_: tw2v._HybridConvFn.apply(x_, w_, s), x, w, ct)
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, dx0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, dw0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOM_IDS)
@pytest.mark.parametrize("impl", ["pairdot", "im2col", "tapdot"])
def test_lowering_matches_conv1d(impl, geom):
    """Each matmul lowering (``feature_conv``), its output and the autograd
    gradients of input and weight, against ``F.conv1d``'s in float32 within
    1e-5 (sums in another order)."""
    x, w, ct, (y0, dx0, dw0) = _geometry(*geom)
    s = geom[4]
    y, dx, dw = _conv_grads(lambda x_, w_: tw2v.feature_conv(impl, x_, w_, s), x, w, ct)
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, dx0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, dw0, rtol=1e-5, atol=1e-5)


def test_pairdot_blocks_layout():
    """Row ``r·C + c`` of block ``j`` is tap ``j·s + r`` of channel ``c``; the
    last block's missing tap is zero rows (k=3, s=2)."""
    w = torch.arange(5 * 4 * 3, dtype=torch.float32).reshape(5, 4, 3)  # (O, C, k)
    wb = tw2v._pairdot_blocks(w, 2)
    assert wb.shape == (2, 8, 5)
    for j in range(2):
        for r in range(2):
            for c in range(4):
                tap = j * 2 + r
                want = w[:, c, tap] if tap < 3 else torch.zeros(5)
                assert torch.equal(wb[j, r * 4 + c], want), (j, r, c)


@pytest.mark.parametrize("preset, over, tol", [
    ("wav2vec2-tiny", {}, 2e-4),
    # base geometry (hidden 768, 12 heads of 64) at depth 2, as
    # test_logits_match_jax holds it
    ("wav2vec2-base", dict(num_hidden_layers=2), 1e-3),
], ids=["tiny", "base_depth2"])
def test_fused_qkv_logits_match_jax(preset, over, tol):
    """``fused_qkv``: one (3H, H) product with the q scale folded in, against
    JAX's ``fused_qkv=True`` on the same weights, and against the unfused
    port."""
    japply, model = _pair(preset, **over, fused_qkv=True)
    audio = (np.random.default_rng(3).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    want = np.asarray(japply(jnp.asarray(audio)))
    unfused = tw2v.Wav2Vec2ForCTC(tw2v.get_config(preset, compute_dtype="float32", **over))
    unfused.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
        plain = unfused.eval()(torch.from_numpy(audio)).numpy()
    assert model.cfg.fused_qkv and not unfused.cfg.fused_qkv
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, plain, rtol=tol, atol=tol)


def test_config_rejects_an_unknown_conv_impl():
    with pytest.raises(ValueError, match="conv_impl"):
        tw2v.get_config("wav2vec2-tiny", conv_impl="winograd")
