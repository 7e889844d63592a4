"""The wav2vec2 family on the program's side: ``paa_tpu_torch.models.wav2vec2``'s
``Wav2Vec2ForCTC`` of a configuration's widths, the modules the traced run
scopes, and the work of a batch counted from the widths (never read from
the program).

The model's FLOPs count its convolutions and matrix products at 2 FLOPs a
multiply-add: the seven feature-extractor convs (``2·B·T_out·C_out·C_in·k``
each), the feature projection, the grouped positional conv over the
encoder's frames, q, k, v and o, the FFN, attention's two products
(``2·B·T²·H`` each) and the CTC head. Its one bounded part is attention,
by the flash algorithm (:func:`portbench.counts.batch_attention_seconds`).

The program is imported only inside the functions that build it.
"""

from __future__ import annotations

from portbench import counts

# the configuration file's keys the program's Wav2Vec2Config takes as they are
_MODEL_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "intermediate_size", "conv_dim", "conv_kernel", "conv_stride", "conv_bias",
               "feat_extract_norm", "do_stable_layer_norm", "num_conv_pos_embeddings",
               "num_conv_pos_embedding_groups", "layer_norm_eps", "do_normalize")

# the program's module class → the traced run's label of its layer
SCOPES = {"FeatureExtractor": "fe", "PositionalConvEmbedding": "pos_conv",
          "Encoder": "encoder"}
# the program modules whose ``attention`` (the call into kernels K1/K2) the traced run wraps
ATTENTION_MODULES = ("paa_tpu_torch.models.wav2vec2",)


def model_config(cfg: dict):
    """The program's ``Wav2Vec2Config`` of the configuration file."""
    from paa_tpu_torch.models import wav2vec2

    kw = {k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]) for k in _MODEL_KEYS}
    return wav2vec2.Wav2Vec2Config(compute_dtype=cfg["assumed"]["compute_dtype"], **kw)


def preset_config(name: str):
    """The program's own preset ``name``, which ``run_attack`` builds."""
    from paa_tpu_torch.models import wav2vec2

    return wav2vec2.get_config(name)


def build_model(cfg: dict, weights: dict, dev):
    """The program's model on ``dev``, its matmul and conv weights stored as
    the configuration serves them, loaded with ``weights``, frozen."""
    import torch

    from paa_tpu_torch.models import wav2vec2

    # built where it runs: on "meta" the weight norm's set-up would go
    # through torch's reference decompositions and import torch._dynamo,
    # seconds of set-up that no run of the program pays
    with torch.device(dev):
        model = wav2vec2.Wav2Vec2ForCTC(model_config(cfg))
    model.cast_param_storage(getattr(torch, cfg["assumed"]["param_storage"]))
    model.load_state_dict(weights)
    return model.requires_grad_(False).eval()


def forward_flops(cfg: dict, batch: int, samples: int) -> dict:
    """FLOPs of one forward pass by part: ``fe``, ``projection``,
    ``pos_conv``, ``linears`` (q, k, v, o and the FFN of every layer),
    ``attention`` (its two products in every layer) and ``head``."""
    B = batch
    fe, n, c_in = 0, samples, 1
    for c, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        fe += 2 * B * n * c * c_in * k
        c_in = c
    T, H, I = n, cfg["hidden_size"], cfg["intermediate_size"]
    L, K = cfg["num_hidden_layers"], cfg["num_conv_pos_embeddings"]
    G = cfg["num_conv_pos_embedding_groups"]
    return {
        "fe": fe,
        "projection": 2 * B * T * c_in * H,
        "pos_conv": 2 * B * T * H * (H // G) * K,
        "linears": L * (2 * B * T * H * H * 4 + 2 * B * T * H * I * 2),
        "attention": L * 2 * (2 * B * T * T * H),
        "head": 2 * B * T * H * cfg["vocab_size"],
    }


def bounds(cfg: dict, traffic: dict, mode: str) -> dict:
    """The least seconds a batch of the traffic of each bounded part: the
    attention calls of every layer (and microbatch)."""
    return {"attention": counts.batch_attention_seconds(
        cfg, traffic["batch_size"], traffic["samples"], mode, traffic.get("accum_steps", 1))}
