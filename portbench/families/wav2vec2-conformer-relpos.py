"""The wav2vec2-conformer-relpos family on the program's side: the
Wav2Vec2-Conformer with Transformer-XL relative positions
(``paa_tpu_torch.models.wav2vec2_conformer``'s ``Wav2Vec2ConformerForCTC``
with ``position_embeddings_type="relative"``), the modules the traced run
scopes, and the work of a batch counted from the widths (never read from
the program).

The rotary conformer's file (``families/wav2vec2-conformer.py``) refuses
anything but rotary positions, so this family has its own pair of files.
FLOPs as the rotary conformer counts them, but attention is three products
a block: ``q·kᵀ``, the positional term ``(q + v)·Pᵀ`` at the T × T entries
it fills, and ``p·v``. The projected table P is made once a frame count
and is not counted. Its bounded parts are attention (kernel K8:
``6·B·H·T²·d`` operations forward and ``14·B·H·T²·d`` backward, the scores
and the term computed again; the bytes of K1/K2's calls and P's once a call)
and the depthwise conv, as the rotary conformer's.

The program is imported only inside the functions that build it.
"""

from __future__ import annotations

from portbench import counts, family

_ROTARY = family.program({"family": "wav2vec2-conformer"})

# the configuration file's keys the program's ConformerConfig takes as they are
_MODEL_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "intermediate_size", "conv_dim", "conv_kernel", "conv_stride", "conv_bias",
               "feat_extract_norm", "layer_norm_eps", "do_normalize",
               "conv_depthwise_kernel_size", "position_embeddings_type",
               "max_source_positions")
# the published keys the program implements one value of
_FIXED = {"hidden_act": "swish", "position_embeddings_type": "relative"}

# the program's module class → the traced run's label of its layer
SCOPES = {**_ROTARY.SCOPES, "RelativePositions": "relpos"}
# the program modules whose ``attention`` (the call into kernel K8) the
# traced run wraps
ATTENTION_MODULES = ("paa_tpu_torch.models.wav2vec2_conformer",)
preset_config = _ROTARY.preset_config


def model_config(cfg: dict):
    """The program's ``ConformerConfig`` of the configuration file."""
    from paa_tpu_torch.models import wav2vec2_conformer

    for key, value in _FIXED.items():
        if cfg[key] != value:
            raise ValueError(f"{key}={cfg[key]!r}: the program runs {value!r} only")
    kw = {k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]) for k in _MODEL_KEYS}
    return wav2vec2_conformer.ConformerConfig(compute_dtype=cfg["assumed"]["compute_dtype"], **kw)


def build_model(cfg: dict, weights: dict, dev):
    """The program's model on ``dev``, its matmul and conv weights stored as
    the configuration serves them, loaded with ``weights``, frozen."""
    import torch

    from paa_tpu_torch.models import presets

    with torch.device(dev):
        model = presets.build(model_config(cfg))
    model.cast_param_storage(getattr(torch, cfg["assumed"]["param_storage"]))
    model.load_state_dict(weights)
    return model.requires_grad_(False).eval()


def forward_flops(cfg: dict, batch: int, samples: int) -> dict:
    """The rotary conformer's parts, with ``attention`` three products of
    ``2·B·T²·H`` in every block."""
    parts = _ROTARY.forward_flops(cfg, batch, samples)
    parts["attention"] = parts["attention"] // 2 * 3
    return parts


def attention_call(batch: int, frames: int, heads: int, head_dim: int) -> dict:
    """Operations and bytes of one K8 forward and one backward call: K1/K2's
    bytes and P's ``(2T − 1)·H·d`` bf16 values once a call."""
    c = counts.attention_call(batch, frames, heads, head_dim)
    table = (2 * frames - 1) * heads * head_dim * 2
    flops = 2 * batch * heads * frames * frames * head_dim
    return {"fwd_flops": 3 * flops, "fwd_bytes": c["fwd_bytes"] + table,
            "bwd_flops": 7 * flops, "bwd_bytes": c["bwd_bytes"] + table}


def attention_seconds(cfg: dict, batch: int, samples: int, mode: str,
                      accum_steps: int = 1) -> float:
    """The least time of a batch's K8 calls: one forward a layer (eval), or
    one forward and one backward a layer and microbatch (attack)."""
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    T = counts.frames(cfg, samples)
    L = cfg["num_hidden_layers"]
    if mode == "eval":
        c = attention_call(batch, T, heads, d)
        return L * counts.least_seconds(c["fwd_flops"], c["fwd_bytes"])
    c = attention_call(batch // accum_steps, T, heads, d)
    per_call = counts.least_seconds(c["fwd_flops"], c["fwd_bytes"]) + counts.least_seconds(
        c["bwd_flops"], c["bwd_bytes"])
    return accum_steps * L * per_call


def bounds(cfg: dict, traffic: dict, mode: str) -> dict:
    """The least seconds a batch of the traffic of each bounded part: K8's
    calls and the depthwise conv's calls of every block (and microbatch)."""
    args = (cfg, traffic["batch_size"], traffic["samples"], mode, traffic.get("accum_steps", 1))
    return {"attention": attention_seconds(*args), "dwconv": _ROTARY.dwconv_seconds(*args)}
