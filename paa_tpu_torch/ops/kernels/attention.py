"""Attention kernels K1 (forward) and K2 (backward), and their plain versions.

Port of ``paa_tpu/ops/pallas/attention.py``: ``softmax(q·kᵀ)·v`` with q
pre-scaled, read in the model's ``(B, T, H·d)`` layout. The forward stores
the output and the per-(head, row) logsumexp; the backward recomputes the
probabilities from them. The CUDA sources are ``csrc/attention_fwd.cu`` and
``csrc/attention_bwd.cu``.

Each wrapper runs the kernel on a CUDA tensor and the plain PyTorch version
on a CPU tensor; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from paa_tpu_torch.ops.kernels import _lib

HEAD_DIMS = (16, 64)  # tiny; base (and lv60)
DTYPES = (torch.float32, torch.bfloat16)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """``(B, T, H·d)`` → ``(B, H, T, d)`` float32."""
    B, T, HD = x.shape
    return x.reshape(B, T, H, HD // H).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype) -> torch.Tensor:
    """``(B, H, T, d)`` → ``(B, T, H·d)`` in ``dtype``."""
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d).to(dtype)


def attention_fwd_plain(q, k, v, H: int):
    """Plain version of K1: ``(o, lse)`` with ``o`` in the input dtype and
    ``lse`` float32 ``(B, H, T)``. Scores and softmax in float32; the
    probabilities are rounded to the input dtype before ``p·v``, as the TPU
    kernel rounds them. Differentiable by autograd."""
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    s = qh @ kh.transpose(-1, -2)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return _merge(p @ vh, q.dtype), lse


def attention_bwd_plain(q, k, v, o, lse, do, H: int):
    """Plain version of K2: ``(dq, dk, dv)`` in the input dtype.

    ``p = exp(s − lse)``, ``D = rowsum(do ∘ o)``, ``ds = p·(do·vᵀ − D)``;
    ``p`` and ``ds`` are rounded to the input dtype before the products."""
    dt = q.dtype
    qh, kh, vh, oh, doh = (_heads(t, H) for t in (q, k, v, o, do))
    p = torch.exp(qh @ kh.transpose(-1, -2) - lse[..., None])
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = (p * (doh @ vh.transpose(-1, -2) - delta)).to(dt).float()
    pc = p.to(dt).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dv = pc.transpose(-1, -2) @ doh
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def _check(name: str, H: int, *ts: torch.Tensor) -> tuple[int, int, int, int]:
    x = ts[0]
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (B, T, H·d), got {tuple(x.shape)}")
    B, T, HD = x.shape
    if T < 1 or HD % H:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)} for H={H}")
    d = HD // H
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in {DTYPES}")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: q/k/v/o/do must share shape, dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    return B, T, H, d


def attention_fwd(q, k, v, H: int):
    """K1: ``(o, lse)`` for ``(B, T, H·d)`` inputs (plain version on CPU)."""
    if not q.is_cuda:
        return attention_fwd_plain(q, k, v, H)
    B, T, H, d = _check("attention_fwd", H, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _lib.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.paa_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, T, H, d, int(q.dtype == torch.bfloat16), stream,
        )
    _lib.check(status, "attention_fwd")
    _lib.launches["attention_fwd"] += 1
    return o, lse


def attention_bwd(q, k, v, o, lse, do, H: int):
    """K2: ``(dq, dk, dv)`` (plain version on CPU)."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, H)
    B, T, H, d = _check("attention_bwd", H, q, k, v, o, do)
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("attention_bwd: lse must be contiguous float32 (B, H, T)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _lib.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.paa_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, T, H, d, int(q.dtype == torch.bfloat16), stream,
        )
    _lib.check(status, "attention_bwd")
    _lib.launches["attention_bwd"] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K1 forward, K2 backward; saves ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, H: int):
        o, lse = attention_fwd(q, k, v, H)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads = H
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.heads)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ)·v`` with q pre-scaled; inputs and output
    ``(B, T, heads, d)``, as ``paa_tpu``'s ``fused_attention``.
    Differentiable with respect to q, k and v."""
    B, T, H, d = q.shape
    flat = lambda t: t.reshape(B, T, H * d).contiguous()
    return _Attention.apply(flat(q), flat(k), flat(v), H).reshape(B, T, H, d)
