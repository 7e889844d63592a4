"""How far float32 parameter gradients of the tiny victim sit from float64
ones, in the JAX package and in the port.

    python3 tools/grad_precision_torch.py

Runs on the CPU. For the two cases of ``tests/test_torch_pretrain.py``
(the tiny preset, and the lv60 layout on tiny widths with drawn biases and
norm scales), on one batch of 4 synthetic clips and the same weights, it
takes the mean CTC's gradient of every parameter from the JAX package
(float32, ``jax.value_and_grad``), from the port (float32) and from the port
in float64: a copy of the port's model module whose source has every
float32 made float64 (its norms take float32 statistics by design). It
prints one JSON line per case: the largest error of each float32 gradient
against float64, as a share of that tensor's largest float64 gradient
(the k_proj biases, whose exact gradient is 0, left out), and the largest
port-against-JAX difference on the same scale. A last line compares the
CTC alone on the JAX model's logits: the logits gradient of torch's
``F.ctc_loss`` in float32 and of optax's, each against ``F.ctc_loss`` in
float64.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from paa_tpu.data import datasets as jdatasets, pipeline as jpipeline  # noqa: E402
from paa_tpu.models import wav2vec2 as jw2v  # noqa: E402
from paa_tpu.ops import ctc as jctc  # noqa: E402
from paa_tpu_torch.models import convert, wav2vec2 as tw2v  # noqa: E402
from paa_tpu_torch.ops import ctc as tctc  # noqa: E402

LV60_LAYOUT = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True)


def float64_model_module() -> types.ModuleType:
    """The port's ``models/wav2vec2.py`` with float32 replaced by float64."""
    src = open(tw2v.__file__).read().replace(".float()", ".double()")
    src = src.replace("torch.float32", "torch.float64")
    module = types.ModuleType("wav2vec2_float64")
    sys.modules[module.__name__] = module  # dataclasses look the module up
    exec(compile(src, tw2v.__file__ + " (float64)", "exec"), module.__dict__)
    return module


def draw_affine(params, seed: int):
    """Biases N(0, 0.1) and norm scales 1 + N(0, 0.1), as the tests draw them."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("bias", "conv_bias"):
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        if name == "scale":
            return 1.0 + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return np.array(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def ctc64(logits: torch.Tensor, labels, pads) -> torch.Tensor:
    """Mean CTC in float64 (``ops/ctc.py``'s reduction)."""
    lp = torch.log_softmax(logits.double(), -1)
    lengths = (pads.shape[1] - pads.sum(1)).round().long()
    per = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), labels.long(),
        torch.full((lp.shape[0],), lp.shape[1], dtype=torch.long), lengths,
        blank=0, reduction="none", zero_infinity=True)
    return (per / lengths.clamp(min=1).double()).mean()


def main() -> int:
    samples = jdatasets.load_dataset_tuples("synthetic", seed=7, synthetic_samples=24,
                                            synthetic_words=(3, 4))
    batch = next(jpipeline.build_pipeline(samples, seed=7).train.batches(4))
    audio, labels, pads = (torch.from_numpy(np.asarray(a))
                           for a in (batch.audio, batch.labels, batch.label_paddings))
    w64 = float64_model_module()
    for name, layout in (("tiny", {}), ("lv60_layout", LV60_LAYOUT)):
        jc = jw2v.get_config("wav2vec2-tiny", **layout)
        params = jw2v.init_params(jc, seed=1, example_len=2000)
        if layout:
            params = draw_affine(params, 2)
        jmodel = jw2v.Wav2Vec2ForCTC(jc)
        loss = lambda p: jctc.ctc_loss(jmodel.apply({"params": p}, batch.audio),
                                       jnp.asarray(batch.labels),
                                       jnp.asarray(batch.label_paddings), reduction="mean")
        _, jg = jax.jit(jax.value_and_grad(loss))(params)
        tc = tw2v.get_config("wav2vec2-tiny", **layout)
        sd = convert.params_from_jax(params, tc)
        jgrads = convert.params_from_jax(jax.tree.map(np.asarray, jg), tc)

        model = tw2v.Wav2Vec2ForCTC(tc)
        model.load_state_dict(sd)
        names, leaves = zip(*model.requires_grad_(True).named_parameters())
        g32 = torch.autograd.grad(tctc.ctc_loss(model(audio), labels, pads, reduction="mean"),
                                  leaves)
        m64 = w64.Wav2Vec2ForCTC(w64.get_config("wav2vec2-tiny", compute_dtype="float64",
                                                **layout)).double()
        m64.load_state_dict({k: v.double() for k, v in sd.items()})
        n64, l64 = zip(*m64.requires_grad_(True).named_parameters())
        g64 = dict(zip(n64, torch.autograd.grad(ctc64(m64(audio.double()), labels, pads), l64)))

        def share(a, b, ref):
            return float((a.double() - b.double()).abs().max() / ref.abs().max())

        rows = {n: (share(g, g64[n], g64[n]), share(jgrads[n], g64[n], g64[n]),
                    share(g, jgrads[n], g64[n]))
                for n, g in zip(names, g32) if not n.endswith("k_proj.bias")}
        worst = lambda i: max(rows.items(), key=lambda kv: kv[1][i])
        print(json.dumps({
            "case": name, "device": "cpu", "tensors": len(rows),
            "port_f32_vs_f64": {"max_share": worst(0)[1][0], "tensor": worst(0)[0]},
            "jax_f32_vs_f64": {"max_share": worst(1)[1][1], "tensor": worst(1)[0]},
            "port_vs_jax": {"max_share": worst(2)[1][2], "tensor": worst(2)[0]},
        }), flush=True)

    # the CTC alone, on the JAX model's logits of the tiny case
    jc = jw2v.get_config("wav2vec2-tiny")
    params = jw2v.init_params(jc, seed=1, example_len=2000)
    logits = np.asarray(jw2v.Wav2Vec2ForCTC(jc).apply({"params": params}, batch.audio))
    g_optax = np.asarray(jax.grad(lambda z: jctc.ctc_loss(
        z, jnp.asarray(batch.labels), jnp.asarray(batch.label_paddings), reduction="mean"))(
        jnp.asarray(logits)))
    x32 = torch.from_numpy(logits.copy()).requires_grad_(True)
    tctc.ctc_loss(x32, labels, pads, reduction="mean").backward()
    x64 = torch.from_numpy(logits.astype(np.float64)).requires_grad_(True)
    ctc64(x64, labels, pads).backward()
    ref = x64.grad.numpy()
    print(json.dumps({
        "case": "ctc_logits_gradient", "device": "cpu", "max_abs": float(np.abs(ref).max()),
        "torch_f32_vs_f64": float(np.abs(x32.grad.numpy() - ref).max()),
        "optax_f32_vs_f64": float(np.abs(g_optax - ref).max()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
