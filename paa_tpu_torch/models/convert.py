"""``paa_tpu``'s Flax parameter tree → the port's state dict, and the
port's state dict → an HF-layout checkpoint.

The port's module tree uses HF's state-dict names, so weights made by the
JAX package (``paa_tpu.models.wav2vec2.init_params``, its converter, its
pretraining) carry across with :func:`params_from_jax`, and the port's own
weights export with :func:`export_hf_state_dict` under the names
``paa_tpu.models.convert.export_hf_state_dict`` writes. Both are written
again here because that module imports flax; tests hold them equal to it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from paa_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from paa_tpu_torch.parallel import tp


def params_from_jax(params: dict, cfg: Wav2Vec2Config) -> dict[str, torch.Tensor]:
    """Flax tree (numpy or JAX arrays; encoder layers stacked on a leading
    axis) → ``{HF name: float32 tensor}`` for ``Wav2Vec2ForCTC.load_state_dict``."""
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    sd: dict[str, np.ndarray] = {}

    def linear(name: str, leaf: dict, i: int | None = None) -> None:
        kernel, bias = f32(leaf["kernel"]), f32(leaf["bias"])
        if i is not None:
            kernel, bias = kernel[i], bias[i]
        sd[f"{name}.weight"] = kernel.T
        sd[f"{name}.bias"] = bias

    def norm(name: str, leaf: dict, i: int | None = None) -> None:
        scale, bias = f32(leaf["scale"]), f32(leaf["bias"])
        if i is not None:
            scale, bias = scale[i], bias[i]
        sd[f"{name}.weight"] = scale
        sd[f"{name}.bias"] = bias

    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        layer = fe[f"conv_layers_{i}"]
        pre = f"wav2vec2.feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = f32(layer["conv_kernel"]).transpose(2, 1, 0)  # WIO → (O, I, K)
        if cfg.conv_bias:
            sd[f"{pre}.conv.bias"] = f32(layer["conv_bias"])
        if "layer_norm" in layer:
            norm(f"{pre}.layer_norm", layer["layer_norm"])

    fp = params["feature_projection"]
    norm("wav2vec2.feature_projection.layer_norm", fp["layer_norm"])
    linear("wav2vec2.feature_projection.projection", fp["projection"])

    enc = params["encoder"]
    pce = "wav2vec2.encoder.pos_conv_embed.conv"
    sd[f"{pce}.parametrizations.weight.original0"] = f32(enc["pos_conv_embed"]["weight_g"])
    sd[f"{pce}.parametrizations.weight.original1"] = f32(
        enc["pos_conv_embed"]["weight_v"]
    ).transpose(2, 1, 0)
    sd[f"{pce}.bias"] = f32(enc["pos_conv_embed"]["bias"])
    norm("wav2vec2.encoder.layer_norm", enc["layer_norm"])

    layers = enc["layers"]
    for i in range(cfg.num_hidden_layers):
        pre = f"wav2vec2.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{pre}.attention.{name}", layers["attention"][name], i)
        norm(f"{pre}.layer_norm", layers["layer_norm"], i)
        norm(f"{pre}.final_layer_norm", layers["final_layer_norm"], i)
        for name in ("intermediate_dense", "output_dense"):
            linear(f"{pre}.feed_forward.{name}", layers["feed_forward"][name], i)

    linear("lm_head", params["lm_head"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def sharded_params_from_jax(params: dict, cfg: Wav2Vec2Config, rank: int,
                            n_model: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s slice, on an ``n_model``-way model axis, of the Flax
    tree ``params``: the full conversion, then ``tp.shard_params``; loads
    into ``Wav2Vec2ForCTC(cfg, model_axis=...)``."""
    return tp.shard_params(params_from_jax(params, cfg), rank, n_model)


def export_hf_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A ``Wav2Vec2ForCTC`` state dict → ``{HF name: float32 numpy}``, the
    layout ``paa_tpu.models.convert.export_hf_state_dict`` writes: the
    modern weight-norm names (``parametrizations.weight.original0/1``), no
    ``masked_spec_embed``. Every array is a copy on the host."""
    return {k: v.detach().to("cpu", torch.float32, copy=True).numpy()
            for k, v in state_dict.items() if not k.endswith("masked_spec_embed")}
