"""The wav2vec2-conformer family on the program's side:
``paa_tpu_torch.models.wav2vec2_conformer``'s ``Wav2Vec2ConformerForCTC`` of a
configuration's widths, the modules the traced run scopes, and the work of a
batch counted from the widths (never read from the program).

The model's FLOPs count its convolutions and matrix products at 2 FLOPs a
multiply-add: the seven feature-extractor convs, the feature projection,
and in every block q, k, v and o, both FFNs, the two pointwise convs
(``H → 2H`` and ``H → H``), the depthwise conv (``2·B·T·H·k``) and
attention's two products (``2·B·T²·H`` each); then the CTC head. There is
no positional conv. Its bounded parts are attention, by the flash algorithm
(:func:`portbench.counts.batch_attention_seconds`), and the depthwise conv
(:func:`dwconv_seconds`).

The program is imported only inside the functions that build it.
"""

from __future__ import annotations

from portbench import counts

# the configuration file's keys the program's ConformerConfig takes as they are
_MODEL_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "intermediate_size", "conv_dim", "conv_kernel", "conv_stride", "conv_bias",
               "feat_extract_norm", "layer_norm_eps", "do_normalize",
               "conv_depthwise_kernel_size", "rotary_embedding_base")
# the published keys the program implements one value of
_FIXED = {"hidden_act": "swish", "position_embeddings_type": "rotary"}

# the program's module class → the traced run's label of its layer
SCOPES = {"FeatureExtractor": "fe", "ConformerEncoder": "encoder",
          "ConvolutionModule": "conv_module", "DepthwiseConv": "dwconv"}
# the program modules whose ``attention`` (the call into kernels K1/K2) the
# traced run wraps: the conformer calls wav2vec2's ``attend``
ATTENTION_MODULES = ("paa_tpu_torch.models.wav2vec2",)


def model_config(cfg: dict):
    """The program's ``ConformerConfig`` of the configuration file."""
    from paa_tpu_torch.models import wav2vec2_conformer

    for key, value in _FIXED.items():
        if cfg[key] != value:
            raise ValueError(f"{key}={cfg[key]!r}: the program runs {value!r} only")
    kw = {k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]) for k in _MODEL_KEYS}
    return wav2vec2_conformer.ConformerConfig(compute_dtype=cfg["assumed"]["compute_dtype"], **kw)


def preset_config(name: str):
    """The program's own preset ``name``, which ``run_attack`` builds."""
    from paa_tpu_torch.models import presets

    return presets.get_config(name)


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
    """FLOPs of one forward pass by part: ``fe``, ``projection``,
    ``linears`` (q, k, v, o, both FFNs and both pointwise convs of every
    block), ``dwconv``, ``attention`` (its two products in every block) and
    ``head``."""
    B = batch
    fe, n, c_in = 0, samples, 1
    for c, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        fe += 2 * B * n * c * c_in * k
        c_in = c
    T, H, I = n, cfg["hidden_size"], cfg["intermediate_size"]
    L = cfg["num_hidden_layers"]
    return {
        "fe": fe,
        "projection": 2 * B * T * c_in * H,
        "linears": L * (2 * B * T * H * H * 4 + 2 * (2 * B * T * H * I * 2)
                        + 2 * B * T * H * 2 * H + 2 * B * T * H * H),
        "dwconv": L * 2 * B * T * H * cfg["conv_depthwise_kernel_size"],
        "attention": L * 2 * (2 * B * T * T * H),
        "head": 2 * B * T * H * cfg["vocab_size"],
    }


def dwconv_call(batch: int, frames: int, channels: int, kernel: int, itemsize: int = 2) -> dict:
    """Operations and bytes of one depthwise-conv call, forward or input
    gradient alike: ``2·B·T·C·k`` operations; its input and output read
    and written once at ``itemsize`` bytes (the taps are a few KiB)."""
    return {"flops": 2 * batch * frames * channels * kernel,
            "bytes": 2 * batch * frames * channels * itemsize}


def dwconv_seconds(cfg: dict, batch: int, samples: int, mode: str, accum_steps: int = 1) -> float:
    """The least time of a batch's depthwise-conv calls: one forward a block
    (eval), or one forward and one input gradient a block and microbatch
    (attack)."""
    T = counts.frames(cfg, samples)
    L, H, K = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["conv_depthwise_kernel_size"]
    calls, micro = (L, batch) if mode == "eval" else (2 * accum_steps * L, batch // accum_steps)
    c = dwconv_call(micro, T, H, K)
    return calls * counts.least_seconds(c["flops"], c["bytes"])


def bounds(cfg: dict, traffic: dict, mode: str) -> dict:
    """The least seconds a batch of the traffic of each bounded part: the
    attention calls and the depthwise-conv calls of every block (and
    microbatch)."""
    args = (cfg, traffic["batch_size"], traffic["samples"], mode, traffic.get("accum_steps", 1))
    return {"attention": counts.batch_attention_seconds(*args), "dwconv": dwconv_seconds(*args)}
