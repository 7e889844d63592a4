"""The Wav2Vec2-Conformer with relative positions on the CPU, in float32.

K8's plain version (``ops/kernels/attention.py``) against ``transformers``'
``_apply_relative_embeddings`` scores, their softmax attention and its
autograd; the port's tiny relative conformer against the benchmark's plain
reference (``portbench/reference/wav2vec2-conformer-relpos.py``) and against
``transformers.Wav2Vec2ConformerForCTC(position_embeddings_type="relative")``
on one state dict with non-zero biases; three faults that each fail that
comparison (a shift off by one position, u and v swapped, the positional
term dropped); the tables' counters and caches, the frozen-weight guard, the
preset and the CLI at tiny widths. K8 itself is held to its plain version on
the card in ``tests/test_torch_relpos_gpu.py``."""

import json
import os
import sys

import pytest
import torch

from paa_tpu_torch import spans
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.models import hf_cache, presets
from paa_tpu_torch.models import wav2vec2_conformer as conformer
from paa_tpu_torch.ops.kernels import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the benchmark's reference and weight draw
    sys.path.insert(0, REPO)

from portbench import family, inputs  # noqa: E402

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
hf_conformer = pytest.importorskip("transformers.models.wav2vec2_conformer.modeling_wav2vec2_conformer")

PRESET = "wav2vec2-conformer-rel-pos-large"
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=[32] * 7)
# float32 on both sides, differing in summation order (and, for the model,
# in the port's fast LayerNorm variance and folded BatchNorm): ~1e-6 of the
# scale; each fault below moves the outputs by 1e-2 of it or more
TOL = 2e-5


def _hf_config(hidden: int, heads: int, **kw):
    return transformers.Wav2Vec2ConformerConfig(
        vocab_size=32, hidden_size=hidden, num_attention_heads=heads,
        position_embeddings_type="relative", hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0,
        conformer_conv_dropout=0.0, layerdrop=0.0, **kw)


def _rel_err(got, want) -> float:
    """max |got − want| over max |want|, at least 0.01: at T = 1 HF's dq and
    dk are 0 and the port's float32 rounding noise (~1e-7)."""
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 0.01)


# ---- K8's plain version against HF's scores ----------------------------------


def _hf_attention(attn, q, k, v, pe):
    """HF's relative scores of (B, H, T, d) q, k, v, softmax and ``p·v``."""
    scores = attn._apply_relative_embeddings(query=q, key=k, relative_position_embeddings=pe)
    return torch.softmax(scores, dim=-1) @ v


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("T", [1, 2, 7, 64, 65, 130])
def test_plain_k8_matches_hf_scores_and_autograd(T, d):
    B, H = 2, 2
    cfg = _hf_config(H * d, H)
    torch.manual_seed(T + d)
    attn = hf_conformer.Wav2Vec2ConformerSelfAttention(cfg).eval()
    with torch.no_grad():
        attn.pos_bias_u.normal_()
        attn.pos_bias_v.normal_()
    attn.requires_grad_(False)
    pe = hf_conformer.Wav2Vec2ConformerRelPositionalEmbedding(cfg)(torch.zeros(1, T, H * d))
    assert torch.equal(pe[0], conformer.sinusoids(T, H * d, torch.device("cpu")))
    q, k, v = (torch.randn(B, H, T, d, requires_grad=True) for _ in range(3))
    do = torch.randn(B, H, T, d)
    want = _hf_attention(attn, q, k, v, pe)
    want_grads = torch.autograd.grad(want, (q, k, v), do)

    # the port's inputs: (B, T, H·d), the biased queries scaled, P = linear_pos(pe)
    flat = lambda t: t.transpose(1, 2).reshape(B, T, H * d)
    c = d ** -0.5
    qu = flat((q + attn.pos_bias_u[:, None]) * c)
    qv = flat((q + attn.pos_bias_v[:, None]) * c)
    table = attn.linear_pos(pe[0])
    got = attention.attention_relpos(qu, qv, flat(k), flat(v), table, H)
    got_grads = torch.autograd.grad(got, (q, k, v), flat(do))
    assert _rel_err(got, flat(want)) <= TOL
    for g, w in zip(got_grads, want_grads):
        assert _rel_err(g, w) <= 1e-4  # the backward doubles the rounding paths


def test_plain_k8_refuses_a_table_that_needs_a_gradient():
    x = torch.randn(1, 3, 32)
    with pytest.raises(ValueError, match="no gradient"):
        attention.attention_relpos(x, x, x, x, torch.randn(5, 32, requires_grad=True), 2)


# ---- the model against the reference and HF ----------------------------------


def _ref_cfg(**over) -> dict:
    with open(os.path.join(REPO, "portbench", "configs", f"{PRESET}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, **over)
    return cfg


def _port(cfg: dict):
    fields = ("conv_bias", "feat_extract_norm", "do_normalize")
    return presets.build(presets.get_config(
        PRESET, compute_dtype="float32", conv_dim=tuple(cfg["conv_dim"]),
        **{k: cfg[k] for k in fields + tuple(k for k in TINY if k != "conv_dim")}))


def _pair(seed: int = 2**31 + 5):
    """(reference module, its cfg, float32 params, the port's model on them)."""
    cfg = _ref_cfg()
    params = {k: v.float() for k, v in inputs.weights(cfg, seed, torch.device("cpu")).items()}
    model = _port(cfg)
    model.load_state_dict(params)
    return family.reference(cfg), cfg, params, model.requires_grad_(False).eval()


def _audio(rows=2, samples=16000, seed=0):
    return torch.randn((rows, samples), generator=torch.Generator().manual_seed(seed)) * 0.1


def test_logits_and_audio_gradient_match_the_reference():
    ref, cfg, params, model = _pair()
    bias = "wav2vec2_conformer.encoder.layers.0.self_attn.pos_bias_"
    assert float(params[bias + "u"].abs().min()) > 0
    assert not torch.equal(params[bias + "u"], params[bias + "v"])
    g = torch.Generator().manual_seed(1)
    labels, lengths = torch.randint(5, 32, (2, 6), generator=g), torch.full((2,), 6)
    out = []
    for fn in (model, lambda a: ref.forward(params, cfg, a)):
        audio = _audio().requires_grad_(True)
        logits = fn(audio)
        ref.ctc_losses(logits, labels, lengths).sum().backward()
        out.append((logits.detach(), audio.grad))
    (got, got_grad), (want, want_grad) = out
    assert _rel_err(got, want) <= TOL
    assert _rel_err(got_grad, want_grad) <= 1e-4


def _hf_pair():
    """(HF's model, the port loaded with its state dict, its float32 params).
    HF's model takes the benchmark's seeded weights (products N(0, 1/fan_in),
    u and v N(0, 1)), so that attention and its positional term shape the
    logits; the positional conv it builds and never calls keeps its own. HF
    normalises the waveform in its processor, so ``do_normalize`` is off."""
    cfg = _ref_cfg(do_normalize=False)
    hf_cfg = _hf_config(64, 4, num_hidden_layers=2, intermediate_size=128, hidden_act="swish",
                        conv_dim=cfg["conv_dim"], conv_kernel=cfg["conv_kernel"],
                        conv_stride=cfg["conv_stride"], conv_bias=True,
                        feat_extract_norm="layer", conv_depthwise_kernel_size=31)
    torch.manual_seed(2)
    hf = transformers.Wav2Vec2ConformerForCTC(hf_cfg).eval()
    seeded = {k: v.float() for k, v in inputs.weights(cfg, 2**31 + 9, torch.device("cpu")).items()}
    sd = dict(hf.state_dict())
    dropped = {k for k in sd if "pos_conv_embed" in k or k.endswith("masked_spec_embed")}
    assert set(sd) - dropped == set(seeded)
    hf.load_state_dict(seeded, strict=False)
    sd = dict(hf.state_dict())
    model = _port(cfg)
    model.load_state_dict(sd)
    assert set(model.state_dict()) == set(sd) - dropped
    for leaf in ("linear_pos.weight", "pos_bias_u", "pos_bias_v"):
        key = f"wav2vec2_conformer.encoder.layers.1.self_attn.{leaf}"
        assert torch.equal(model.state_dict()[key], sd[key])
    params = {k: v.float() for k, v in sd.items() if k not in dropped}
    return hf, cfg, model.requires_grad_(False), params


def test_port_and_reference_match_transformers():
    hf, cfg, model, params = _hf_pair()
    audio = _audio(samples=8000, seed=4)
    with torch.no_grad():
        want = hf(input_values=audio).logits
        got = {"port": model(audio),
               "reference": family.reference(cfg).forward(params, cfg, audio)}
    for name, logits in got.items():
        assert _rel_err(logits, want) <= TOL, name


def _off_by_one(monkeypatch):
    shift = attention._rel_shift
    monkeypatch.setattr(attention, "_rel_shift", lambda bd: shift(torch.roll(bd, 1, dims=-1)))


def _dropped(monkeypatch):
    shift = attention._rel_shift
    monkeypatch.setattr(attention, "_rel_shift", lambda bd: torch.zeros_like(shift(bd)))


def _swapped(model):
    for layer in model.wav2vec2_conformer.encoder.layers:
        a = layer.self_attn
        a.pos_bias_u, a.pos_bias_v = a.pos_bias_v, a.pos_bias_u


@pytest.mark.parametrize("fault", ["off_by_one", "swapped_u_v", "dropped_term"])
def test_each_fault_fails_the_comparison(fault, monkeypatch):
    hf, _, model, _ = _hf_pair()
    if fault == "off_by_one":
        _off_by_one(monkeypatch)
    elif fault == "dropped_term":
        _dropped(monkeypatch)
    else:
        _swapped(model)
    audio = _audio(samples=8000, seed=4)
    with torch.no_grad():
        err = _rel_err(model(audio), hf(input_values=audio).logits)
    assert err > 100 * TOL, err


# ---- tables, counters, guard, preset, CLI ------------------------------------


def test_tables_once_a_frame_count_and_again_after_a_weight_changes():
    _, _, _, model = _pair()
    conformer.reset_counts()
    assert "relpos_tables" not in conformer.counts
    for samples in (16000, 16000, 16001, 8000):  # 49, 49, 49 and 24 frames
        with torch.no_grad():
            model(_audio(samples=samples))
    assert conformer.counts == {"dwconv": 4 * 2, "dwconv_dgrad": 0, "rotary_tables": 0,
                                "relpos_tables": 2 * 2}
    attn = model.wav2vec2_conformer.encoder.layers[0].self_attn
    with torch.no_grad():
        before = model(_audio())
        attn.linear_pos.weight.mul_(2.0)
        after = model(_audio())
    assert conformer.counts["relpos_tables"] == 2 * 2 + 1
    assert not torch.equal(before, after)


def test_tables_again_after_the_weight_is_replaced():
    """A new weight at the old one's address and version, and new storage
    under the same Parameter (as ``cast_param_storage`` gives it), each
    make P again."""
    _, _, _, model = _pair()
    attn = model.wav2vec2_conformer.encoder.layers[0].self_attn
    w = attn.linear_pos.weight.detach()
    storage = w.clone()

    def on_storage():  # a fresh Parameter on ``storage``, at version 1 each time
        return torch.nn.Parameter(torch.empty(0, dtype=w.dtype).set_(
            storage.untyped_storage(), 0, w.shape, w.stride()))

    with torch.no_grad():
        attn.linear_pos.weight = on_storage()
        before = model(_audio())
        conformer.reset_counts()
        storage.mul_(2.0)
        attn.linear_pos.weight = on_storage()
        doubled = model(_audio())
        assert conformer.counts["relpos_tables"] == 1
        attn.linear_pos.weight.data = 0.5 * attn.linear_pos.weight.data
        restored = model(_audio())
    assert conformer.counts["relpos_tables"] == 2
    assert not torch.equal(before, doubled)
    torch.testing.assert_close(restored, before, rtol=1e-6, atol=1e-6)


def test_a_weight_that_needs_a_gradient_raises():
    _, _, _, model = _pair()
    model.wav2vec2_conformer.encoder.layers[1].self_attn.pos_bias_v.requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        model(_audio())
    with torch.no_grad():
        model(_audio())


def test_spans_of_the_relative_terms():
    """``paa.relpos`` once a block inside ``paa.encoder`` (the tables are
    made in the first call), and ``paa.attention`` once a block."""
    _, _, _, model = _pair()
    audio = _audio().requires_grad_(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(audio).sum().backward()
    found = {}
    for e in prof.events():
        if e.name in spans.SPANS:
            found[e.name] = found.get(e.name, 0) + 1
    assert found["paa.relpos"] >= 2 and found["paa.attention"] == 2


def test_preset_and_hub_repo():
    cfg = presets.get_config(PRESET)
    assert (cfg.position_embeddings_type, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size, cfg.conv_depthwise_kernel_size,
            cfg.max_source_positions, cfg.vocab_size) == ("relative", 1024, 24, 16, 4096, 31,
                                                          5000, 32)
    assert cfg.do_normalize and cfg.conv_bias and cfg.feat_extract_norm == "layer"
    assert hf_cache.HF_REPOS[PRESET] == "facebook/wav2vec2-conformer-rel-pos-large-960h-ft"
    with pytest.raises(ValueError, match="position_embeddings_type"):
        presets.get_config(PRESET, position_embeddings_type="absolute")


def test_entry_point_runs_the_relative_conformer(tmp_path, monkeypatch):
    tiny = presets.get_config(PRESET, **{**TINY, "conv_dim": (32,) * 7})
    monkeypatch.setitem(presets.PRESETS, PRESET, tiny)
    args = tparser.parse_args([
        "--platform", "cpu", "--model", PRESET, "--dataset", "synthetic",
        "--synthetic_samples", "8", "--batch_size", "4", "--accum_steps", "2",
        "--num_epochs", "1", "--norm_type", "fletcher_munson", "--optimizer_type", "pgd",
        "--num_items_to_inspect", "0", "--save_root", str(tmp_path)])
    conformer.reset_counts()
    assert trun.main(args) == 0
    assert conformer.counts["relpos_tables"] >= 2 and conformer.counts["rotary_tables"] == 0
    results = json.loads((tmp_path / "untargeted" / "synthetic" /
                          "fletcher_munson_2_untargeted_pgd" / "results.json").read_text())
    assert results["finished_training"] is True
