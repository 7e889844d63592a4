"""Positional conv kernel K5 (forward and input gradient), and its plain
version.

wav2vec2's positional embedding: ``gelu(conv1d(x))`` over ``(B, T, H)`` with
``G`` groups of ``Cg = H / G`` channels, ``K`` taps, padding ``P = K // 2``
and, for even ``K``, the last frame trimmed (SamePad). The JAX package has no
kernel here (``lax.conv_general_dilated``); the CUDA source is
``csrc/pos_conv.cu``, one implicit-GEMM design for both directions.

The route is fixed by device and dtype, the same function either way:

- bfloat16 on CUDA: the kernel, through :class:`_PosConv`, for ``Cg`` a
  multiple of 16 up to 128 and ``K`` up to 128; any other such shape raises.
  The forward writes ``pre`` (kept for the backward) and ``gelu(pre)``; the
  backward forms ``dpre = dout · gelu'(pre)`` and runs the kernel on it with
  the flipped, group-transposed taps (:func:`dgrad_taps`). The weight
  gradient, only when the weight needs one (pretraining), is the library's
  ``conv1d_weight`` on the saved input;
- float32 on CUDA, and every CPU tensor: the stock ``F.conv1d`` on a
  ``(B, C, T)`` view, the trim and ``F.gelu``, through autograd
  (:func:`pos_conv_fwd_plain`).

``_PosConv`` itself runs on a CPU tensor too, through the plain versions of
the two directions, :func:`pos_conv_fwd_plain` and
:func:`pos_conv_dgrad_plain`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paa_tpu_torch.ops.kernels import _lib

MAX_TAPS = 128
MAX_GROUP = 128  # channels a group


def pos_conv_fwd_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Plain version of the kernel's forward, and the layer's stock path:
    ``(pre, gelu(pre))`` of ``(B, T, H)``, weight ``(H, Cg, K)``, by the
    grouped ``F.conv1d`` on the ``(B, H, T)`` view, padded ``K // 2`` each
    side, the trailing frame trimmed for even ``K``. Differentiable by
    autograd."""
    K = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w, bias, padding=K // 2, groups=x.shape[-1] // w.shape[1])
    if K % 2 == 0:
        y = y[:, :, :-1]
    pre = y.transpose(1, 2)
    return pre, F.gelu(pre)


def dgrad_taps(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's weight: each group's ``(Cg_out, Cg_in)`` block
    transposed and the taps flipped, ``(H, Cg, K)`` like ``w``."""
    H, Cg, K = w.shape
    return w.reshape(H // Cg, Cg, Cg, K).transpose(1, 2).flip(-1).reshape(H, Cg, K)


def pos_conv_dgrad_plain(dpre: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's input gradient, the sum the kernel
    runs: ``dx[b, s] = Σ_k dpre[b, s + k − (K − 1 − K // 2)] · W'_k`` with
    ``W' =`` :func:`dgrad_taps` ``(w)``, rows outside ``[0, T)`` read as 0."""
    K = w.shape[-1]
    dt = F.pad(dpre.transpose(1, 2), (K - 1 - K // 2, K // 2))
    return F.conv1d(dt, dgrad_taps(w), groups=dpre.shape[-1] // w.shape[1]).transpose(1, 2)


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """``(H, Cg, K)`` → ``(G, K, Cg/8, M, 8)``, ``M = 64·⌈Cg/64⌉``: tap k of
    group g as the kernel's A operand, ``W[g·Cg + co, ci, k]`` at
    ``[g, k, ci // 8, co, ci % 8]`` and zeros in rows ``co ≥ Cg``
    (``csrc/pos_conv.cu``, "The weight")."""
    H, Cg, K = w.shape
    G, M = H // Cg, 64 * math.ceil(Cg / 64)
    packed = w.new_zeros((G, K, Cg // 8, M, 8))
    packed[:, :, :, :Cg] = w.reshape(G, Cg, Cg // 8, 8, K).permute(0, 4, 2, 1, 3)
    return packed


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> tuple[int, ...]:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: expected (B, T, H) and (H, Cg, K), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    B, T, H = x.shape
    _, Cg, K = w.shape
    if w.shape[0] != H or H % Cg or T < 1:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit {tuple(x.shape)}")
    if Cg % 16 or Cg > MAX_GROUP or not 1 <= K <= MAX_TAPS:
        raise ValueError(f"{name}: the kernel takes groups of 16·n ≤ {MAX_GROUP} channels and "
                         f"≤ {MAX_TAPS} taps, got {Cg} and {K}")
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: expected bfloat16 input and weight on one device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: the input must be contiguous and 16-byte aligned")
    return B, T, H, Cg, K


def pos_conv_fwd(x, w, bias):
    """K5's forward: ``(pre, gelu(pre))``, each ``(B, T, H)`` (plain version
    on CPU)."""
    if not x.is_cuda:
        return pos_conv_fwd_plain(x, w, bias)
    B, T, H, Cg, K = _check("pos_conv_fwd", x, w)
    if bias.shape != (H,) or bias.dtype != x.dtype or not bias.is_contiguous():
        raise ValueError("pos_conv_fwd: the bias must be contiguous bfloat16 (H,)")
    pre, out = torch.empty_like(x), torch.empty_like(x)
    taps = pack_taps(w)
    with torch.cuda.device(x.device):
        status = _lib.library().paa_pos_conv_fwd(
            x.data_ptr(), taps.data_ptr(), bias.data_ptr(), pre.data_ptr(), out.data_ptr(),
            B, T, H, Cg, K, torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(status, "pos_conv_fwd")
    _lib.launches["pos_conv"] += 1
    return pre, out


def pos_conv_dgrad(dpre, w):
    """K5's input gradient: ``∂loss/∂x`` from ``∂loss/∂pre`` (plain version
    on CPU)."""
    if not dpre.is_cuda:
        return pos_conv_dgrad_plain(dpre, w)
    B, T, H, Cg, K = _check("pos_conv_dgrad", dpre, w)
    dx = torch.empty_like(dpre)
    taps = pack_taps(dgrad_taps(w))
    with torch.cuda.device(dpre.device):
        status = _lib.library().paa_pos_conv_dgrad(
            dpre.data_ptr(), taps.data_ptr(), dx.data_ptr(), B, T, H, Cg, K,
            torch.cuda.current_stream(dpre.device).cuda_stream)
    _lib.check(status, "pos_conv_dgrad")
    _lib.launches["pos_conv_dgrad"] += 1
    return dx


class _PosConv(torch.autograd.Function):
    """K5 forward and input gradient; saves ``pre``, the weight and, only
    when the weight needs a gradient, the input."""

    @staticmethod
    def forward(ctx, x, w, bias):
        pre, out = pos_conv_fwd(x, w, bias)
        ctx.save_for_backward(pre, w, x if ctx.needs_input_grad[1] else None)
        return out

    @staticmethod
    def backward(ctx, dout):
        pre, w, x = ctx.saved_tensors
        dpre = torch.ops.aten.gelu_backward(dout.contiguous(), pre)
        dx = pos_conv_dgrad(dpre, w) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1]:
            K = w.shape[-1]
            # the conv's full output has one more frame for even K, trimmed
            # in the forward: its gradient is 0
            dy = F.pad(dpre.transpose(1, 2), (0, 1 - K % 2))
            dw = torch.nn.grad.conv1d_weight(x.transpose(1, 2), w.shape, dy, padding=K // 2,
                                             groups=x.shape[-1] // w.shape[1])
        if ctx.needs_input_grad[2]:
            db = dpre.sum((0, 1))
        return dx, dw, db


def positional_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(conv)`` of the positional embedding, ``(B, T, H)`` in and out,
    weight ``(H, Cg, K)`` and bias ``(H,)`` in ``x``'s dtype: K5 for
    bfloat16 on CUDA, else the stock path of :func:`pos_conv_fwd_plain`.
    Differentiable with respect to all three."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _PosConv.apply(x.contiguous(), w, bias)
    return pos_conv_fwd_plain(x, w, bias)[1]
