"""Operations and bytes of the work, counted from a configuration's widths
and a cell's shapes: never read from the program.

A forward pass's FLOPs by part are the family's to count
(``families/<family>.py``'s ``forward_flops``, at 2 FLOPs a multiply-add,
with ``attention`` one of the parts). An attack step adds the input
gradients that ∂loss/∂p needs: as much again for every part, layer 0
included, and twice the forward for attention's two products; the victim
is frozen, so no weight gradient is counted, and nothing recomputed is
counted.

The attention bound follows the flash algorithm (one call a layer and
microbatch) on the encoder's widths (``num_attention_heads`` heads of
``hidden_size / num_attention_heads``): the forward's ``4·B·H·T²·d``
operations, reading q, k and v and writing o and the log-sum-exp; the
backward's five T×T×d products (``10·B·H·T²·d``, the scores computed
again), reading q, k, v, o, do and the log-sum-exp and writing dq, dk and
dv. Its least time is the larger of the operations at the bf16 peak and the
bytes at the memory's rate.
"""

from __future__ import annotations

from portbench import family

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def frames(cfg: dict, samples: int) -> int:
    n = samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


def batch_flops(cfg: dict, batch: int, samples: int, mode: str) -> int:
    """FLOPs of one batch: a forward pass (``eval``) or an attack step, from
    the forward's parts as the configuration's family counts them."""
    parts = family.program(cfg).forward_flops(cfg, batch, samples)
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
