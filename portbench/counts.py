"""Operations and bytes of the work, counted from a configuration's widths
and a cell's shapes: never read from the program.

The model's FLOPs count its convolutions and matrix products at 2 FLOPs a
multiply-add: the seven feature-extractor convs (``2·B·T_out·C_out·C_in·k``
each), the feature projection, the grouped positional conv over the
encoder's frames, q, k, v and o, the FFN, attention's two products
(``2·B·T²·H`` each) and the CTC head. An attack step adds the input
gradients that ∂loss/∂p needs: as much again for every conv and linear,
layer 0 included, and twice the forward for attention's two products; the
victim is frozen, so no weight gradient is counted, and nothing recomputed
is counted.

The attention bound follows the flash algorithm (one call a layer and
microbatch): the forward's ``4·B·H·T²·d`` operations, reading q, k and v
and writing o and the log-sum-exp; the backward's five T×T×d products
(``10·B·H·T²·d``, the scores computed again), reading q, k, v, o, do and
the log-sum-exp and writing dq, dk and dv. Its least time is the larger of
the operations at the bf16 peak and the bytes at the memory's rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def frames(cfg: dict, samples: int) -> int:
    n = samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


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


def batch_flops(cfg: dict, batch: int, samples: int, mode: str) -> int:
    """FLOPs of one batch: a forward pass (``eval``) or an attack step."""
    parts = forward_flops(cfg, batch, samples)
    total = sum(parts.values())
    if mode == "eval":
        return total
    if mode == "attack":
        return 2 * total + parts["attention"]
    raise ValueError(f"mode {mode!r}")


def attention_call(batch: int, frames_: int, heads: int, head_dim: int,
                   itemsize: int = 2) -> dict:
    """Operations and bytes of one forward and one backward call."""
    B, T, H, d = batch, frames_, heads, head_dim
    n = B * T * H * d * itemsize
    stats = B * H * T * 4
    return {"fwd_flops": 4 * B * H * T * T * d, "fwd_bytes": 4 * n + stats,
            "bwd_flops": 10 * B * H * T * T * d, "bwd_bytes": 8 * n + stats}


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def batch_attention_seconds(cfg: dict, batch: int, samples: int, mode: str,
                            accum_steps: int = 1) -> float:
    """The least time of a batch's attention calls: one forward call a layer
    (eval), or one forward and one backward call a layer and microbatch
    (attack)."""
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    T = frames(cfg, samples)
    L = cfg["num_hidden_layers"]
    if mode == "eval":
        c = attention_call(batch, T, heads, d)
        return L * least_seconds(c["fwd_flops"], c["fwd_bytes"])
    micro = batch // accum_steps
    c = attention_call(micro, T, heads, d)
    per_call = least_seconds(c["fwd_flops"], c["fwd_bytes"]) + least_seconds(
        c["bwd_flops"], c["bwd_bytes"])
    return accum_steps * L * per_call
