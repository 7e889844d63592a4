"""The port's Wav2Vec2-Conformer (``models/wav2vec2_conformer.py``) on the CPU,
in float32, at tiny widths: against the benchmark's plain reference
(``portbench/reference/wav2vec2-conformer.py``) on its seeded random weights,
and against ``transformers``' ``Wav2Vec2ConformerForCTC`` (rotary, eval mode)
on one state dict loaded into all three; its rotary table and depthwise-conv
counters, BatchNorm buffers and refused knobs; and the preset registry
(``models/presets.py``) that the entry point builds every preset through."""

import hashlib
import json
import os
import sys

import pytest
import torch

from paa_tpu_torch import spans
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.models import presets, wav2vec2
from paa_tpu_torch.models import wav2vec2_conformer as conformer
from paa_tpu_torch.parallel import tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the benchmark's reference and weight draw
    sys.path.insert(0, REPO)

from portbench import family, inputs  # noqa: E402

PRESET = "wav2vec2-conformer-rope-large"
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=[32] * 7)
# the feature extractor's two layouts: lv60's (the preset's) and base's
LAYOUTS = {"layer_fe": dict(conv_bias=True, feat_extract_norm="layer", do_normalize=True),
           "group_fe": dict(conv_bias=False, feat_extract_norm="group", do_normalize=False)}
# sha256 of the (name, shape, dtype) rows of each wav2vec2 preset's state
# dict, read at the commit before the conformer came
OLD_KEYS = {
    "wav2vec2-base": "25ebff441fb0b41eb5c9f4b0c938a7c60787ee32553a76a90586e5aab7c6dda1",
    "wav2vec2-large-lv60": "351f9c1f254a4083ab5a64c9b410517ae1caaf0ea16254686a7fe4fe9da2f388",
    "wav2vec2-tiny": "58af057a74552f7bf08dc8bdd9d2b57093bec3f69a5f7221b31cc80899cb3e69",
}


def _ref_cfg(**over) -> dict:
    """The benchmark's configuration file at tiny widths."""
    with open(os.path.join(REPO, "portbench", "configs", f"{PRESET}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, **over)
    return cfg


def _port(cfg: dict):
    """The port's conformer of the reference configuration ``cfg``, float32."""
    fields = ("conv_bias", "feat_extract_norm", "do_normalize")
    return presets.build(presets.get_config(
        PRESET, compute_dtype="float32", conv_dim=tuple(cfg["conv_dim"]),
        **{k: cfg[k] for k in fields + tuple(k for k in TINY if k != "conv_dim")}))


def _pair(layout: str, seed: int = 2**31 + 3):
    """(reference module, its cfg, float32 params, the port's model on them)."""
    cfg = _ref_cfg(**LAYOUTS[layout])
    params = {k: v.float() for k, v in inputs.weights(cfg, seed, torch.device("cpu")).items()}
    model = _port(cfg)
    model.load_state_dict(params)
    return family.reference(cfg), cfg, params, model.requires_grad_(False).eval()


def _audio(rows=2, samples=16000, seed=0):
    return torch.randn((rows, samples), generator=torch.Generator().manual_seed(seed)) * 0.1


def _labels(rows=2, length=6):
    g = torch.Generator().manual_seed(1)
    return torch.randint(5, 32, (rows, length), generator=g), torch.full((rows,), length)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_logits_match_the_reference(layout):
    ref, cfg, params, model = _pair(layout)
    audio = _audio()
    with torch.no_grad():
        got, want = model(audio), ref.forward(params, cfg, audio)
    # float32 on both sides; they differ in summation order and in the
    # port's fast LayerNorm variance and folded BatchNorm: ~1e-6 of the
    # logits' scale, against the 1e-2 that a bf16 product gives
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_audio_gradient_matches_the_reference(layout):
    """∂CTC/∂audio with the model frozen, the loss of both read through the
    reference's ``ctc_losses``."""
    ref, cfg, params, model = _pair(layout)
    labels, lengths = _labels()
    grads = []
    for fn in (model, lambda a: ref.forward(params, cfg, a)):
        audio = _audio().requires_grad_(True)
        ref.ctc_losses(fn(audio), labels, lengths).sum().backward()
        grads.append(audio.grad)
    got, want = grads
    # the backward doubles the forward's rounding paths: 1e-4 of the largest
    # gradient entry, well under bf16's ~1e-2
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_port_and_reference_match_transformers():
    """One HF state dict (rotary, eval mode, biases, norms and BatchNorm
    statistics away from their initial values) loads as it is into the
    port, and the port's and the reference's logits agree with HF's.
    HF normalises the waveform in its processor, not in the model, so
    ``do_normalize`` is off here."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = _ref_cfg(do_normalize=False)
    hf_cfg = transformers.Wav2Vec2ConformerConfig(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, hidden_act="swish", conv_dim=cfg["conv_dim"],
        conv_kernel=cfg["conv_kernel"], conv_stride=cfg["conv_stride"], conv_bias=True,
        feat_extract_norm="layer", position_embeddings_type="rotary",
        rotary_embedding_base=10000, conv_depthwise_kernel_size=31, hidden_dropout=0.0,
        activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
        final_dropout=0.0, conformer_conv_dropout=0.0, layerdrop=0.0, mask_time_prob=0.05)
    torch.manual_seed(2)
    hf = transformers.Wav2Vec2ConformerForCTC(hf_cfg).eval()
    with torch.no_grad():
        for name, t in hf.state_dict().items():
            if name.endswith(("bias", "running_mean")) or "norm.weight" in name:
                t.add_(torch.randn_like(t) * 0.1)
            elif name.endswith("running_var"):
                t.add_(torch.rand_like(t) * 0.5)
    sd = dict(hf.state_dict())
    dropped = {k for k in sd if "pos_conv_embed" in k or k.endswith(("masked_spec_embed",
                                                                     "inv_freq"))}
    assert len(dropped) >= 4  # what HF holds and the forward never reads
    model = _port(cfg)
    model.load_state_dict(sd)
    assert set(model.state_dict()) == set(sd) - dropped
    params = {k: v.float() for k, v in sd.items() if k not in dropped}
    audio = _audio(seed=4)
    with torch.no_grad():
        want = hf(input_values=audio).logits
        got = {"port": model.eval()(audio), "reference": family.reference(cfg).forward(
            params, cfg, audio)}
    scale = float(want.abs().max())
    for name, logits in got.items():  # float32 throughout, as above
        assert float((logits - want).abs().max()) <= 2e-5 * scale, name


def test_rotary_table_once_a_frame_count_and_the_depthwise_counts():
    _, _, _, model = _pair("layer_fe")
    conformer.reset_counts()
    for samples in (16000, 16000, 16001, 8000):  # 49, 49, 49 and 24 frames
        with torch.no_grad():
            model(_audio(samples=samples))
    assert conformer.counts == {"dwconv": 4 * 2, "dwconv_dgrad": 0, "rotary_tables": 2}
    conformer.reset_counts()
    audio = _audio().requires_grad_(True)
    model(audio).sum().backward()
    assert conformer.counts == {"dwconv": 2, "dwconv_dgrad": 2, "rotary_tables": 0}


def test_batch_norm_buffers_round_trip():
    _, _, params, model = _pair("layer_fe")
    bn = "wav2vec2_conformer.encoder.layers.1.conv_module.batch_norm."
    other = _port(_ref_cfg(**LAYOUTS["layer_fe"]))
    other.load_state_dict(model.state_dict())
    for leaf in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(other.state_dict()[bn + leaf], model.state_dict()[bn + leaf])
    assert not torch.equal(params[bn + "running_var"], torch.ones_like(params[bn + "running_var"]))
    assert torch.equal(model.state_dict()[bn + "running_var"], params[bn + "running_var"])
    fresh = presets.init_model(presets.get_config(PRESET, compute_dtype="float32",
                                                  **{**TINY, "conv_dim": (32,) * 7}), seed=3)
    sd = fresh.state_dict()
    assert torch.equal(sd[bn + "running_mean"], torch.zeros(64))
    assert torch.equal(sd[bn + "running_var"], torch.ones(64))


@pytest.mark.parametrize("knob", [{"remat": True}, {"remat_policy": "save_cheap"},
                                  {"remat_ffn": True}, {"fused_qkv": True}],
                         ids=lambda k: next(iter(k)))
def test_refused_knobs_raise(knob):
    (name,) = knob
    with pytest.raises(ValueError, match=name):
        presets.get_config(PRESET, **knob)


def test_tensor_parallelism_raises():
    with pytest.raises(ValueError, match="wav2vec2-conformer"):
        tp.check_model_axis(presets.get_config(PRESET), 2)
    tp.check_model_axis(presets.get_config(PRESET), 1)


@pytest.mark.parametrize("name", sorted(OLD_KEYS))
def test_old_presets_build_as_before(name):
    cfg = presets.get_config(name)
    assert cfg == wav2vec2.get_config(name)
    model = presets.build(cfg)
    assert type(model) is wav2vec2.Wav2Vec2ForCTC
    rows = [[k, list(v.shape), str(v.dtype)] for k, v in model.state_dict().items()]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == OLD_KEYS[name]


def test_entry_point_builds_the_conformer(tmp_path, monkeypatch):
    """``run_attack --model wav2vec2-conformer-rope-large`` through the
    registry, runner and step of every preset (the preset cut to tiny widths
    here, on the CPU): one epoch writes its results."""
    tiny = presets.get_config(PRESET, **{**TINY, "conv_dim": (32,) * 7})
    monkeypatch.setitem(presets.PRESETS, PRESET, tiny)
    assert PRESET in tparser.create_arg_parser().parse_args(["--model", PRESET]).model
    args = tparser.parse_args([
        "--platform", "cpu", "--model", PRESET, "--dataset", "synthetic",
        "--synthetic_samples", "16", "--batch_size", "4", "--accum_steps", "2",
        "--num_epochs", "1", "--norm_type", "fletcher_munson", "--optimizer_type", "pgd",
        "--num_items_to_inspect", "0", "--save_root", str(tmp_path)])
    conformer.reset_counts()
    assert trun.main(args) == 0
    assert conformer.counts["dwconv_dgrad"] > 0 and conformer.counts["rotary_tables"] >= 1
    results = json.loads((tmp_path / "untargeted" / "synthetic" /
                          "fletcher_munson_2_untargeted_pgd" / "results.json").read_text())
    assert results["finished_training"] is True


def test_spans_of_the_conv_module():
    """``paa.conv_module`` once a block inside ``paa.encoder``, and
    ``paa.dwconv`` inside it; ``paa.attention`` once a block."""
    _, _, _, model = _pair("layer_fe")
    audio = _audio().requires_grad_(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(audio).sum().backward()
    ranges = {}
    for e in prof.events():
        if e.name in spans.SPANS:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert {k: len(v) for k, v in ranges.items()} == {
        "paa.fe": 1, "paa.encoder": 1, "paa.attention": 2, "paa.conv_module": 2, "paa.dwconv": 2}

    def inside(name, outer):
        return all(any(a <= s and t <= b for a, b in ranges[outer]) for s, t in ranges[name])

    assert inside("paa.conv_module", "paa.encoder") and inside("paa.dwconv", "paa.conv_module")
