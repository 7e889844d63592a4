"""Feature-extractor norm kernel K6 (conv bias + LayerNorm over channels +
GELU, forward and backward), and its plain version.

Every layer of lv60's feature extractor (and the conformer's, which shares
it) ends in ``gelu(LayerNorm_C(y + bias))`` over the conv's output ``y``.
The JAX package has no kernel here (jnp operations that XLA fuses); the CUDA
source is ``csrc/fe_norm.cu``, one pass each way with float32 statistics.

The route is fixed by the device, the same function either way:

- every CUDA tensor: the kernel, in bfloat16 or float32, on cuDNN's
  ``(B, C, T)`` layout (``dim=1``) or the ``(B, T, C)`` of the conv
  lowerings (``dim=2``), for any ``C`` that is a multiple of 8 up to 1024;
  any other input raises. With grad on, :class:`_FeNormGelu` saves ``y`` and
  the per-frame mean and 1/std only; its backward is the kernel's, and when
  a weight needs a gradient (pretraining) the kernel also writes one row of
  the weight gradients' sums a block (:func:`wgrad_blocks`), summed here;
- every CPU tensor: the plain version, :func:`fe_norm_gelu_plain`, through
  autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paa_tpu_torch.ops.kernels import _lib

MAX_CHANNELS = 1024
DTYPES = (torch.bfloat16, torch.float32)
FRAMES = 32  # frames a block of the (B, C, T) kernels (csrc/fe_norm.cu, kFrames)
ROW_FRAMES = 8  # frames a block of the (B, T, C) kernels (kRowWarps)


class _FeNorm(torch.autograd.Function):
    """The feature extractor's LayerNorm over the channel axis ``dim`` (1 of
    a ``(B, C, T)`` activation, 2 of a ``(B, T, C)`` one): float32
    statistics, output in the input's dtype (reference: ``_FeNorm``). The
    backward keeps the input (in its own dtype) and the per-frame mean and
    1/std, and recomputes the normalised value from them; stock autograd of
    a float32 LayerNorm would keep a float32 copy of every
    feature-extractor layer (the reference keeps it out of HBM the same
    way)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, dim: int):
        shape = [1] * x.dim()
        shape[dim] = -1
        xf = x.to(torch.float32, copy=True)
        var, mu = torch.var_mean(xf, dim=dim, correction=0, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        y = xf.sub_(mu).mul_(rstd).mul_(weight.view(shape)).add_(bias.view(shape)).to(x.dtype)
        ctx.save_for_backward(x, mu, rstd, weight)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        # in place where it can be: at 20 s and B=32 one float32 copy of
        # layer 0 is 4.2 GB, and this keeps three of them alive at a time
        x, mu, rstd, weight = ctx.saved_tensors
        dim = ctx.dim
        shape = [1] * x.dim()
        shape[dim] = -1
        others = tuple(d for d in range(x.dim()) if d != dim)
        xhat = x.to(torch.float32, copy=True).sub_(mu).mul_(rstd)
        gf = g.to(torch.float32, copy=True)
        dw = (gf * xhat).sum(others) if ctx.needs_input_grad[1] else None
        db = gf.sum(others) if ctx.needs_input_grad[2] else None
        dxhat = gf.mul_(weight.view(shape))
        m1 = dxhat.mean(dim, keepdim=True)
        m2 = (dxhat * xhat).mean(dim, keepdim=True)
        dx = dxhat.sub_(m1).sub_(xhat.mul_(m2)).mul_(rstd).to(x.dtype)
        return dx, dw, db, None, None


def bias_norm_gelu(y, bias, norm, tanh: bool, dim: int = 1):
    """A feature-extractor layer after its conv, off the kernel: the conv
    ``bias`` (or None) added in ``y``'s dtype along the channel axis ``dim``
    (1 of ``(B, C, T)``, 2 of ``(B, T, C)``), ``norm`` (a callable, or None)
    and ``F.gelu`` (tanh or erf), through autograd."""
    if bias is not None:
        b = bias.to(y.dtype)
        y = y + (b[:, None] if dim == 1 else b)
    if norm is not None:
        y = norm(y)
    return F.gelu(y, approximate="tanh" if tanh else "none")


def fe_norm_gelu_plain(y, bias, weight, bias_ln, eps: float, tanh: bool, dim: int = 1):
    """Plain version of K6, and the layer's path on the CPU:
    :func:`bias_norm_gelu` with :class:`_FeNorm` over ``dim``."""
    return bias_norm_gelu(y, bias, lambda x: _FeNorm.apply(x, weight, bias_ln, eps, dim), tanh,
                          dim)


def _check(name: str, y: torch.Tensor, dim: int) -> tuple[int, int, int]:
    """(B, C, T) of a conv output the kernel takes, with its channels on
    ``dim``; raises on any other."""
    if y.dim() != 3 or y.dtype not in DTYPES or not y.is_cuda or dim not in (1, 2):
        raise ValueError(f"{name}: expected a bfloat16 or float32 CUDA (B, C, T) or (B, T, C), "
                         f"got {y.dtype} {tuple(y.shape)} on {y.device}, channels on {dim}")
    B, C, T = y.shape if dim == 1 else (y.shape[0], y.shape[2], y.shape[1])
    if C % 8 or not 8 <= C <= MAX_CHANNELS or T < 1 or not 1 <= B <= 65535 or B * T >= 2**31:
        raise ValueError(f"{name}: the kernel takes 8·n ≤ {MAX_CHANNELS} channels, T ≥ 1 and "
                         f"1 ≤ B ≤ 65535, got {tuple(y.shape)} with channels on {dim}")
    return B, C, T


def _params(y: torch.Tensor, C: int, bias, weight, bias_ln) -> list[torch.Tensor]:
    """The conv bias (zeros when the conv has none), γ and β as aligned
    contiguous float32 (C,) on ``y``'s device."""
    out = []
    for t in (bias, weight, bias_ln):
        if t is None:
            t = y.new_zeros(C, dtype=torch.float32)
        if t.shape != (C,):
            raise ValueError(f"fe_norm: parameter of shape {tuple(t.shape)} for {C} channels")
        out.append(_lib.aligned(t.detach().to(device=y.device, dtype=torch.float32)))
    return out


def wgrad_blocks(y: torch.Tensor, dim: int) -> int:
    """Blocks of the backward when it also writes the weight gradients'
    rows: twice the SMs, or fewer where the layer has fewer units of work
    (32-frame tiles in ``(B, C, T)``, 8-frame row groups in ``(B, T, C)``)."""
    B, C, T = _check("wgrad_blocks", y, dim)
    units = B * -(-T // FRAMES) if dim == 1 else -(-(B * T) // ROW_FRAMES)
    return min(units, 2 * torch.cuda.get_device_properties(y.device).multi_processor_count)


def fe_norm_fwd(y, bias, weight, bias_ln, eps: float, tanh: bool, stats: bool, dim: int = 1):
    """K6's forward: ``(gelu(LayerNorm_C(y + bias)), mean, rstd)`` of a
    bfloat16 or float32 CUDA conv output with its channels on ``dim``;
    ``mean`` and ``rstd`` are float32 ``(B, T)`` with ``stats``, else None."""
    B, C, T = _check("fe_norm_fwd", y, dim)
    y = _lib.aligned(y)
    prm = _params(y, C, bias, weight, bias_ln)
    out = torch.empty_like(y)
    mean = rstd = None
    if stats:
        mean = y.new_empty((B, T), dtype=torch.float32)
        rstd = torch.empty_like(mean)
    with torch.cuda.device(y.device):
        status = _lib.library().paa_fe_norm_fwd(
            y.data_ptr(), *(p.data_ptr() for p in prm), out.data_ptr(),
            mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
            B, C, T, float(eps), int(tanh), int(dim == 2), int(y.dtype == torch.bfloat16),
            torch.cuda.current_stream(y.device).cuda_stream)
    _lib.check(status, "fe_norm_fwd")
    _lib.launches["fe_norm"] += 1
    return out, mean, rstd


def fe_norm_bwd(g, y, bias, weight, bias_ln, mean, rstd, tanh: bool, wgrad: bool, dim: int = 1):
    """K6's backward: ``(dy, dbias, dγ, dβ)`` from the gradient ``g`` of the
    output, the forward's input and its ``mean`` and ``rstd``; ``dy`` in
    ``y``'s dtype, the weight gradients float32 (C,) with ``wgrad``, else
    None. The weight gradients come as one row a block of
    :func:`wgrad_blocks`, summed here."""
    B, C, T = _check("fe_norm_bwd", y, dim)
    if g.shape != y.shape or g.dtype != y.dtype:
        raise ValueError(f"fe_norm_bwd: the gradient must be {y.dtype} {tuple(y.shape)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    y, g = _lib.aligned(y), _lib.aligned(g)
    prm = _params(y, C, bias, weight, bias_ln)
    dx = torch.empty_like(y)
    blocks = wgrad_blocks(y, dim) if wgrad else 0
    partial = y.new_empty((blocks, 3, C), dtype=torch.float32) if wgrad else None
    with torch.cuda.device(y.device):
        status = _lib.library().paa_fe_norm_bwd(
            g.data_ptr(), y.data_ptr(), *(p.data_ptr() for p in prm), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), partial.data_ptr() if wgrad else None, blocks,
            B, C, T, int(tanh), int(dim == 2), int(y.dtype == torch.bfloat16),
            torch.cuda.current_stream(y.device).cuda_stream)
    _lib.check(status, "fe_norm_bwd")
    _lib.launches["fe_norm_bwd"] += 1
    if not wgrad:
        return dx, None, None, None
    dw, db, dbias = partial.sum(0)
    return dx, dbias, dw, db


class _FeNormGelu(torch.autograd.Function):
    """K6 forward and backward; saves ``y``, the per-frame mean and 1/std
    and the (C,) parameters, never ``y + bias`` or the LayerNorm's output."""

    @staticmethod
    def forward(ctx, y, bias, weight, bias_ln, eps: float, tanh: bool, dim: int):
        out, mean, rstd = fe_norm_fwd(y, bias, weight, bias_ln, eps, tanh, stats=True, dim=dim)
        ctx.save_for_backward(y, mean, rstd, bias, weight, bias_ln)
        ctx.tanh, ctx.dim = tanh, dim
        return out

    @staticmethod
    def backward(ctx, g):
        y, mean, rstd, bias, weight, bias_ln = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy, *dp = fe_norm_bwd(g, y, bias, weight, bias_ln, mean, rstd, ctx.tanh,
                              wgrad=any(need[1:4]), dim=ctx.dim)
        grads = [d.to(p.dtype) if n and p is not None else None
                 for d, p, n in zip(dp, (bias, weight, bias_ln), need[1:4])]
        return (dy if need[0] else None, *grads, None, None, None)


def fe_norm_gelu(y: torch.Tensor, bias, weight, bias_ln, eps: float, tanh: bool,
                 dim: int = 1) -> torch.Tensor:
    """``gelu(LayerNorm(y + bias))`` over the channel axis ``dim`` of the
    conv output ``y`` (1: ``(B, C, T)``, 2: ``(B, T, C)``), with the conv
    bias (or None), the LayerNorm's ``weight`` and ``bias_ln``, ``eps`` and
    the tanh (or erf) GELU: K6 for a CUDA tensor (which raises on one it does
    not take), :func:`fe_norm_gelu_plain` for a CPU one. Differentiable with
    respect to ``y`` and the three parameters."""
    if not y.is_cuda:
        return fe_norm_gelu_plain(y, bias, weight, bias_ln, eps, tanh, dim)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (y, bias, weight, bias_ln)):
        return _FeNormGelu.apply(y, bias, weight, bias_ln, eps, tanh, dim)
    return fe_norm_fwd(y, bias, weight, bias_ln, eps, tanh, stats=False, dim=dim)[0]
