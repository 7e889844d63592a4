"""Attention kernels K1 (forward) and K2 (backward), and their plain versions.

Port of ``paa_tpu/ops/pallas/attention.py``: ``softmax(q·kᵀ)·v`` with q
pre-scaled, read in the model's ``(B, T, H·d)`` layout. The forward stores
the output and the per-(head, row) logsumexp; the backward recomputes the
probabilities from them.

Each wrapper runs a kernel on a CUDA tensor and the plain PyTorch version
on a CPU tensor; on a CUDA tensor it launches a kernel or raises. Which
kernel is fixed by dtype and head dim, the same function either way:

- bfloat16 with head dim 64 (base, lv60): the Hopper kernels, wgmma with
  register accumulators fed by TMA through an mbarrier ring
  (``csrc/attention_fwd_sm90.cu``, ``csrc/attention_bwd_sm90.cu``);
- float32, and head dim 16 (the tiny preset): the register-route kernels
  (``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``), each row's operands
  and accumulators in registers: exact float32 on the FMA units, and bf16
  with head dim 16 on the tensor cores through ``mma.sync``; the backward is
  one launch, key-owning blocks writing dk and dv and query-owning blocks dq.

K8 (``attention_relpos``) is the relative-position attention of the
Wav2Vec2-Conformer (Transformer-XL's, arXiv 1901.02860 §3.3): the scores
gain ``qv[i]·P[T − 1 − i + j]``, a term of ``i − j``, from the biased
queries ``qu = (q + u)·c`` and ``qv = (q + v)·c`` and the layer's projected
table ``P`` (2T − 1 rows, row r at relative position T − 1 − r). On the card
it is bfloat16 with head dim 64 only (``csrc/attention_relpos_sm90.cu``); its
plain version writes HF's pad-and-reshape shift literally.
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


def _sm90(x: torch.Tensor, d: int) -> bool:
    """The Hopper route: bfloat16 with head dim 64."""
    return x.dtype == torch.bfloat16 and d == 64


def attention_fwd(q, k, v, H: int):
    """K1: ``(o, lse)`` for ``(B, T, H·d)`` inputs (plain version on CPU)."""
    if not q.is_cuda:
        return attention_fwd_plain(q, k, v, H)
    B, T, H, d = _check("attention_fwd", H, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _lib.library()
    sm90 = _sm90(q, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
        if sm90:
            status = lib.paa_attention_fwd_sm90(*ptrs, B, T, H, stream)
        else:
            status = lib.paa_attention_fwd(*ptrs, B, T, H, d, int(q.dtype == torch.bfloat16),
                                           stream)
    _lib.check(status, "attention_fwd")
    _lib.launches["attention_fwd_sm90" if sm90 else "attention_fwd"] += 1
    return o, lse


def attention_bwd(q, k, v, o, lse, do, H: int):
    """K2: ``(dq, dk, dv)`` (plain version on CPU)."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, H)
    B, T, H, d = _check("attention_bwd", H, q, k, v, o, do)
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("attention_bwd: lse must be contiguous float32 (B, H, T)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sm90 = _sm90(q, d)
    lib = _lib.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        if sm90:
            # scratch of the Hopper route: D = rowsum(do∘o) and lse·log2 e,
            # over rows padded as that kernel asks
            scratch = torch.empty((2, B, H, lib.paa_attention_bwd_sm90_rows(T)),
                                  dtype=torch.float32, device=q.device)
            status = lib.paa_attention_bwd_sm90(*ptrs, scratch.data_ptr(), B, T, H, stream)
        else:  # the register route computes D itself and needs no scratch
            status = lib.paa_attention_bwd(*ptrs, B, T, H, d, int(q.dtype == torch.bfloat16),
                                           stream)
    _lib.check(status, "attention_bwd")
    _lib.launches["attention_bwd_sm90" if sm90 else "attention_bwd"] += 1
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


# ---- K8: relative-position attention ------------------------------------------


def _rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """Transformer-XL's shift of ``bd`` (B, H, T, 2T − 1) to (B, H, T, T),
    ``out[i, j] = bd[i, T − 1 − i + j]``, as ``transformers``'
    ``_apply_relative_embeddings`` writes it: a zero column in front, the
    rows read again with one more column, the first dropped."""
    B, H, T, R = bd.shape
    padded = torch.cat([bd.new_zeros((B, H, T, 1)), bd], dim=-1).view(B, H, R + 1, T)
    return padded[:, :, 1:].view(B, H, T, R)[..., :T]


def _rel_unshift(ds: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_rel_shift`: ``ds`` (B, H, T, T) placed at
    column ``T − 1 − i + j`` of a zero (B, H, T, 2T − 1)."""
    B, H, T, _ = ds.shape
    i = torch.arange(T, device=ds.device)
    cols = (T - 1 - i[:, None] + i[None, :]).expand(B, H, T, T)
    return ds.new_zeros((B, H, T, 2 * T - 1)).scatter_(-1, cols, ds)


def _pos_heads(pos: torch.Tensor, H: int) -> torch.Tensor:
    """``(2T − 1, H·d)`` → ``(H, 2T − 1, d)`` float32."""
    R, HD = pos.shape
    return pos.reshape(R, H, HD // H).transpose(0, 1).float()


def attention_relpos_fwd_plain(qu, qv, k, v, pos, H: int):
    """Plain version of K8's forward: ``(o, lse)``. ``s = qu·kᵀ +
    rel_shift(qv·Pᵀ)`` in float32, softmax in float32, the probabilities
    rounded to the input dtype before ``p·v``, as K1's plain version.
    Differentiable by autograd."""
    quh, qvh, kh, vh = _heads(qu, H), _heads(qv, H), _heads(k, H), _heads(v, H)
    s = quh @ kh.transpose(-1, -2) + _rel_shift(qvh @ _pos_heads(pos, H).transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(qu.dtype).float()
    return _merge(p @ vh, qu.dtype), lse


def attention_relpos_bwd_plain(qu, qv, k, v, pos, o, lse, do, H: int):
    """Plain version of K8's backward: ``(dqu, dqv, dk, dv)`` in the input
    dtype. ``ds = p·(do·vᵀ − D)`` rounded to the input dtype, ``dqu =
    ds·k``, ``dqv[i] = Σ_j ds[i, j]·P[T − 1 − i + j]``, ``dk = dsᵀ·qu``,
    ``dv = pᵀ·do``; no gradient for P."""
    dt = qu.dtype
    quh, qvh, kh, vh, oh, doh = (_heads(t, H) for t in (qu, qv, k, v, o, do))
    ph = _pos_heads(pos, H)
    s = quh @ kh.transpose(-1, -2) + _rel_shift(qvh @ ph.transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = (p * (doh @ vh.transpose(-1, -2) - delta)).to(dt).float()
    dqu = ds @ kh
    dqv = _rel_unshift(ds) @ ph
    dk = ds.transpose(-1, -2) @ quh
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    return _merge(dqu, dt), _merge(dqv, dt), _merge(dk, dt), _merge(dv, dt)


def _check_relpos(name: str, H: int, pos: torch.Tensor, *ts: torch.Tensor) -> tuple:
    B, T, H, d = _check(name, H, *ts)
    if not _sm90(ts[0], d):
        raise ValueError(f"{name}: K8 runs bfloat16 with head dim 64, got {ts[0].dtype}, d={d}")
    if (pos.shape != (2 * T - 1, H * d) or pos.dtype != ts[0].dtype
            or pos.device != ts[0].device):
        raise ValueError(f"{name}: pos must be ({2 * T - 1}, {H * d}) {ts[0].dtype}, "
                         f"got {tuple(pos.shape)} {pos.dtype}")
    if not pos.is_contiguous() or pos.data_ptr() % 16:
        raise ValueError(f"{name}: pos must be contiguous and 16-byte aligned")
    return B, T, H, d


def attention_relpos_fwd(qu, qv, k, v, pos, H: int):
    """K8's forward: ``(o, lse)`` for ``(B, T, H·d)`` inputs and the table
    ``pos`` ``(2T − 1, H·d)`` (plain version on CPU)."""
    if not qu.is_cuda:
        return attention_relpos_fwd_plain(qu, qv, k, v, pos, H)
    B, T, H, d = _check_relpos("attention_relpos_fwd", H, pos, qu, qv, k, v)
    o = torch.empty_like(qu)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qu.device)
    lib = _lib.library()
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream(qu.device).cuda_stream
        status = lib.paa_attention_relpos_fwd_sm90(
            qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, T, H, stream)
    _lib.check(status, "attention_relpos_fwd")
    _lib.launches["attention_relpos_fwd"] += 1
    return o, lse


def attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H: int):
    """K8's backward: ``(dqu, dqv, dk, dv)`` (plain version on CPU)."""
    if not qu.is_cuda:
        return attention_relpos_bwd_plain(qu, qv, k, v, pos, o, lse, do, H)
    B, T, H, d = _check_relpos("attention_relpos_bwd", H, pos, qu, qv, k, v, o, do)
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("attention_relpos_bwd: lse must be contiguous float32 (B, H, T)")
    dqu, dqv, dk, dv = (torch.empty_like(qu) for _ in range(4))
    lib = _lib.library()
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream(qu.device).cuda_stream
        # D = rowsum(do∘o) and lse·log2 e, over rows padded as K2's
        scratch = torch.empty((2, B, H, lib.paa_attention_bwd_sm90_rows(T)),
                              dtype=torch.float32, device=qu.device)
        status = lib.paa_attention_relpos_bwd_sm90(
            qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), dqu.data_ptr(), dqv.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, T, H, stream)
    _lib.check(status, "attention_relpos_bwd")
    _lib.launches["attention_relpos_bwd"] += 1
    return dqu, dqv, dk, dv


class _RelPosAttention(torch.autograd.Function):
    """K8 both ways; saves ``(qu, qv, k, v, pos, o, lse)``. The table is
    frozen: a ``pos`` that needs a gradient raises."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, pos, H: int):
        if ctx.needs_input_grad[4]:
            raise ValueError("attention_relpos: the positional table takes no gradient")
        o, lse = attention_relpos_fwd(qu, qv, k, v, pos, H)
        ctx.save_for_backward(qu, qv, k, v, pos, o, lse)
        ctx.heads = H
        return o

    @staticmethod
    def backward(ctx, do):
        qu, qv, k, v, pos, o, lse = ctx.saved_tensors
        dqu, dqv, dk, dv = attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do.contiguous(),
                                                ctx.heads)
        return dqu, dqv, dk, dv, None, None


def attention_relpos(qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, heads: int) -> torch.Tensor:
    """K8: ``softmax(qu·kᵀ + rel_shift(qv·Pᵀ))·v`` for ``(B, T, heads·d)``
    inputs (the biased queries pre-scaled) and ``pos`` ``(2T − 1,
    heads·d)``; ``(B, T, heads·d)``. Differentiable with respect to qu, qv,
    k and v."""
    return _RelPosAttention.apply(qu.contiguous(), qv.contiguous(), k.contiguous(),
                                  v.contiguous(), pos.contiguous(), heads)
