"""The port's Wav2Vec2-CTC against paa_tpu.models.wav2vec2 (float32, CPU),
with the same weights carried across by params_from_jax."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.models import checkpoint_io
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v

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
