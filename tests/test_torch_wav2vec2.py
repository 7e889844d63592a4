"""The port's Wav2Vec2-CTC against paa_tpu.models.wav2vec2 (float32, CPU),
with the same weights carried across by params_from_jax."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paa_tpu.models import checkpoint_io
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.ops.kernels.fe_norm import _FeNorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")


def _pair(preset, seed=0, **over):
    """The JAX model and the port's model on the same random weights."""
    jc = jw2v.get_config(preset, compute_dtype="float32", **over)
    params = jw2v.init_params(jc, seed=seed, example_len=2000)
    tc = tw2v.get_config(preset, compute_dtype="float32", **over)
    model = tw2v.Wav2Vec2ForCTC(tc)
    model.load_state_dict(convert.params_from_jax(params, tc))
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    return (lambda a: jmodel.apply({"params": params}, a)), model.eval()


def _audio(b, t, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, t)) * 0.1).astype(np.float32)


# the lv60 preset's four flags on the tiny widths
LV60_FLAGS = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
                  do_normalize=True)


def _randomize_affine(params, seed):
    """Biases N(0, 0.1) and norm scales 1 + N(0, 0.1) in place of the 0/1
    initial values, so that the tests see every bias and scale (with zero
    conv biases the LayerNorm feature extractor ignores the input's scale)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("bias", "conv_bias"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        if name == "scale":
            return 1.0 + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return np.array(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _lv60_pair(attention_impl, seed=0):
    """The lv60-flag tiny model in JAX (with ``attention_impl``) and in the
    port, on the same weights with every bias and norm scale drawn."""
    jc = jw2v.get_config("wav2vec2-tiny", compute_dtype="float32", **LV60_FLAGS)
    params = _randomize_affine(jw2v.init_params(jc, seed=seed, example_len=2000), seed + 1)
    tc = tw2v.get_config("wav2vec2-tiny", compute_dtype="float32", **LV60_FLAGS)
    model = tw2v.Wav2Vec2ForCTC(tc)
    model.load_state_dict(convert.params_from_jax(params, tc))
    jmodel = jw2v.Wav2Vec2ForCTC(jw2v.get_config(
        "wav2vec2-tiny", compute_dtype="float32", attention_impl=attention_impl, **LV60_FLAGS))
    return (lambda a: jmodel.apply({"params": params}, a)), model.eval()


@pytest.mark.parametrize("attention_impl", ["flash", "xla"])
def test_lv60_flags_logits_and_input_grad_match_jax(attention_impl):
    """Conv bias, a LayerNorm in every FE layer, pre-LN layers with the final
    LayerNorm after the stack, and do_normalize, at 4 s (199 frames). The
    JAX side runs K4 (stock Pallas flash attention) in TPU interpret mode,
    or its dense attention. Tolerance: logits 2e-4 (f32 sums in another
    order through 2 layers, as the tiny test); input gradient 1e-3 of its
    largest value."""
    japply, model = _lv60_pair(attention_impl)
    audio = _audio(2, 64000, seed=5)
    ct = np.random.default_rng(6).standard_normal((2, 199, 32)).astype(np.float32)

    def loss(a):
        logits = japply(a)
        return jnp.sum(logits * ct), logits

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(audio))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    x = torch.from_numpy(audio).requires_grad_(True)
    got = model(x)
    (got * torch.from_numpy(ct)).sum().backward()
    assert got.shape == want.shape == (2, 199, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-3, atol=1e-3 * scale)


def test_do_normalize_uses_the_population_variance():
    """Rows with different means and variances: the waveform the feature
    extractor sees is ``(a − mean) / sqrt(var + 1e-7)`` with the population
    variance (``np.var``'s and ``jnp.var``'s default), and the logits match
    JAX."""
    japply, model = _lv60_pair("xla", seed=2)
    rng = np.random.default_rng(7)
    t = 800  # short rows, where the unbiased estimator would differ by 1/(2·800)
    audio = np.stack([rng.standard_normal(t) * 0.05 + 0.3,
                      rng.standard_normal(t) * 0.6 - 0.2,
                      rng.uniform(-1.0, 1.0, t)]).astype(np.float32)
    seen = []
    model.wav2vec2.register_forward_pre_hook(lambda _m, args: seen.append(args[0].clone()))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    a64 = audio.astype(np.float64)
    want_in = (a64 - a64.mean(-1, keepdims=True)) / np.sqrt(a64.var(-1, keepdims=True) + 1e-7)
    np.testing.assert_allclose(seen[0].numpy(), want_in, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(japply(jnp.asarray(audio))), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("preset, over, t, tol", [
    ("wav2vec2-tiny", {}, 4000, 2e-4),
    # base geometry (hidden 768, 12 heads of 64, 512-wide conv stack) at depth 2
    ("wav2vec2-base", dict(num_hidden_layers=2), 4000, 1e-3),
])
def test_logits_match_jax(preset, over, t, tol):
    japply, model = _pair(preset, **over)
    audio = _audio(2, t)
    want = np.asarray(japply(jnp.asarray(audio)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, model.cfg.feat_extract_output_length(t), 32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_committed_checkpoint_logits_match_jax():
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})

    from paa_tpu.models import convert as jconvert

    jc = jw2v.get_config("wav2vec2-tiny")
    params = jconvert.convert_hf_state_dict(sd, jc)
    audio = _audio(2, 16000, seed=3)
    want = np.asarray(jw2v.Wav2Vec2ForCTC(jc).apply({"params": params}, jnp.asarray(audio)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_grad_wrt_audio_matches_jax():
    japply, model = _pair("wav2vec2-tiny", seed=1)
    audio = _audio(2, 4000, seed=2)
    ct = np.random.default_rng(9).standard_normal((2, 12, 32)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(japply(a) * ct))(jnp.asarray(audio)))
    x = torch.from_numpy(audio).requires_grad_(True)
    (model(x) * torch.from_numpy(ct)).sum().backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-3, atol=1e-3 * scale)


def test_hf_state_dict_loads_and_matches_hf():
    """An HF ``Wav2Vec2ForCTC`` state dict loads as it is (spec-augment
    embedding dropped) and the logits agree with HF's own forward."""
    transformers = pytest.importorskip("transformers")
    cfg = tw2v.get_config("wav2vec2-tiny")
    hf_cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), conv_bias=False, feat_extract_norm="group",
        do_stable_layer_norm=False, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ForCTC(hf_cfg).eval()
    model = tw2v.Wav2Vec2ForCTC(cfg)
    model.load_state_dict(hf.state_dict())
    audio = torch.from_numpy(_audio(2, 4000, seed=4))
    with torch.no_grad():
        np.testing.assert_allclose(model(audio).numpy(), hf(input_values=audio).logits.numpy(),
                                   rtol=1e-3, atol=2e-4)


def test_hf_lv60_layout_state_dict_loads_and_matches_hf():
    """The lv60 layout (conv biases, a LayerNorm in every FE layer, pre-LN
    layers, the final encoder LayerNorm after the stack) at tiny widths: an
    HF state dict, its positional conv's weight norm in the older
    ``weight_g``/``weight_v`` names, loads as it is and the logits agree
    with HF's forward. HF normalises the waveform in its processor, not in
    the model, so the port's ``do_normalize`` is off here."""
    transformers = pytest.importorskip("transformers")
    cfg = tw2v.get_config("wav2vec2-tiny", **{**LV60_FLAGS, "do_normalize": False})
    hf_cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(1)
    hf = transformers.Wav2Vec2ForCTC(hf_cfg).eval()
    with torch.no_grad():  # biases and norms away from their 0/1 initial values
        for name, p in hf.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    sd = dict(hf.state_dict())
    pce = "wav2vec2.encoder.pos_conv_embed.conv."
    sd[pce + "weight_g"] = sd.pop(pce + "parametrizations.weight.original0")
    sd[pce + "weight_v"] = sd.pop(pce + "parametrizations.weight.original1")
    model = tw2v.Wav2Vec2ForCTC(cfg)
    model.load_state_dict(sd)
    audio = torch.from_numpy(_audio(2, 4000, seed=4))
    with torch.no_grad():
        np.testing.assert_allclose(model(audio).numpy(), hf(input_values=audio).logits.numpy(),
                                   rtol=1e-3, atol=2e-4)


def test_bf16_storage_keeps_bf16_outputs_and_f32_head():
    """cast_param_storage stores matmul and FE-conv weights in bf16 and keeps
    norms, biases, the positional conv and the lm_head in f32; under bf16
    compute the logits are unchanged."""
    cfg = tw2v.get_config("wav2vec2-tiny", compute_dtype="bfloat16")
    model = tw2v.init_model(cfg, seed=3)
    audio = torch.from_numpy(_audio(1, 4000))
    with torch.no_grad():
        before = model(audio)
        model.cast_param_storage(torch.bfloat16)
        after = model(audio)
    assert before.dtype == torch.float32
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    kernels = {f"{n}.weight" for n, m in model.named_modules()
               if isinstance(m, torch.nn.Linear) and n != "lm_head"}
    kernels |= {f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight" for i in range(7)}
    for name, p in model.named_parameters():
        assert p.dtype == (torch.bfloat16 if name in kernels else torch.float32), name


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_feature_extractor_layer_norm_matches_layer_norm(dtype, tol):
    """The lv60 feature extractor's LayerNorm over channels (its own
    backward, which keeps no float32 copy of the layer): values and the
    gradients of input, scale and bias against torch's LayerNorm on the
    transposed layout in float32. Tolerance 1e-5 relative in float32;
    2e-2 in bf16, the output's rounding step being 2^-8."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 24, 50)).astype(np.float32) * 2 + 0.5)
    w = torch.from_numpy(1 + rng.standard_normal(24).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32) * 0.1)
    ct = torch.from_numpy(rng.standard_normal((2, 24, 50)).astype(np.float32))

    def grads(fn, xin):
        leaves = [t.clone().requires_grad_(True) for t in (xin, w, b)]
        y = fn(*leaves)
        (y.float() * ct).sum().backward()
        return y.detach().float(), [t.grad.float() for t in leaves]

    got, got_g = grads(lambda x_, w_, b_: _FeNorm.apply(x_, w_, b_, 1e-5, 1),
                       x.to(dtype))
    want, want_g = grads(lambda x_, w_, b_: torch.nn.functional.layer_norm(
        x_.float().transpose(1, 2), (24,), w_, b_, 1e-5).transpose(1, 2), x.to(dtype))
    rel = lambda a, c: float((a - c).abs().max() / c.abs().max())
    assert rel(got, want) <= tol
    for name, g, c in zip(("x", "weight", "bias"), got_g, want_g):
        assert rel(g, c) <= tol, name
