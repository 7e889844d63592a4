"""The encoder's LayerNorm kernel K7 (the LayerNorm over the last axis,
forward and backward).

Every LayerNorm of the encoder, of the conformer's blocks and conv module,
and of the feature projection goes through ``models/wav2vec2.py``'s
``_layer_norm``. The JAX package has no kernel here (its ``_layernorm``
custom VJP is plain jnp, which XLA fuses); the CUDA source is
``csrc/layer_norm.cu``, one pass each way over rows of C values with
float32 statistics and the reference's fast variance.

The route is fixed by the device, the same function either way:

- every CUDA tensor: :func:`layer_norm`, the kernel, in bfloat16 or
  float32, for any ``C`` that is a multiple of 8 up to 1024; any other
  input raises. It takes rows whose last axis has unit stride and copies
  any other input to rows once (the feature projection's under
  ``conv_impl="conv"``, whose input is the feature extractor's transposed
  ``(B, C, T)``). With grad on, :class:`_LayerNormK7` saves x̂ in the
  input's dtype, 1/std and γ, as the plain version does; its backward is
  the kernel's, and when γ or β needs a gradient (pretraining) the kernel
  also writes one row of their sums a block (:func:`wgrad_blocks`), summed
  here. With grad off, x̂ and 1/std are not written;
- every CPU tensor: the plain version, ``models/wav2vec2.py``'s
  ``_LayerNormFn``.
"""

from __future__ import annotations

import torch

from paa_tpu_torch.ops.kernels import _lib

MAX_C = 1024
DTYPES = (torch.bfloat16, torch.float32)
ROWS = 8  # rows a block (csrc/layer_norm.cu, kWarps)


def _check(name: str, x: torch.Tensor) -> tuple[int, int]:
    """(rows, C) of an input the kernel takes; raises on any other."""
    if x.dim() < 1 or x.dtype not in DTYPES or not x.is_cuda:
        raise ValueError(f"{name}: expected a bfloat16 or float32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    if C % 8 or not 8 <= C <= MAX_C or not 1 <= rows < 2**31:
        raise ValueError(f"{name}: the kernel takes a last axis of 8·n ≤ {MAX_C} and at least "
                         f"one row, got {tuple(x.shape)}")
    return rows, C


def _params(x: torch.Tensor, C: int, *params) -> list[torch.Tensor]:
    """γ (and β) as aligned contiguous float32 (C,) on ``x``'s device."""
    out = []
    for t in params:
        if t.shape != (C,):
            raise ValueError(f"layer_norm: parameter of shape {tuple(t.shape)} for C = {C}")
        out.append(_lib.aligned(t.detach().to(device=x.device, dtype=torch.float32)))
    return out


def wgrad_blocks(x: torch.Tensor) -> int:
    """Blocks of the backward when it also writes the weight gradients'
    rows: twice the SMs, or fewer where there are fewer groups of 8 rows."""
    rows, _ = _check("wgrad_blocks", x)
    return min(-(-rows // ROWS), 2 * torch.cuda.get_device_properties(x.device)
               .multi_processor_count)


def layer_norm_fwd(x, weight, bias, eps: float, save: bool):
    """K7's forward: ``(out, xhat, rstd)`` of a bfloat16 or float32 CUDA
    ``x`` over its last axis; ``out`` and ``xhat`` in ``x``'s dtype and
    shape, ``rstd`` float32 of shape ``x.shape[:-1] + (1,)``, the last two
    written with ``save``, else None."""
    rows, C = _check("layer_norm_fwd", x)
    x = _lib.aligned(x)
    gamma, beta = _params(x, C, weight, bias)
    out = torch.empty_like(x)
    xhat = torch.empty_like(x) if save else None
    rstd = x.new_empty((*x.shape[:-1], 1), dtype=torch.float32) if save else None
    with torch.cuda.device(x.device):
        status = _lib.library().paa_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            xhat.data_ptr() if save else None, rstd.data_ptr() if save else None, rows, C,
            float(eps), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(status, "layer_norm_fwd")
    _lib.launches["layer_norm"] += 1
    return out, xhat, rstd


def layer_norm_bwd(g, xhat, rstd, weight, wgrad: bool):
    """K7's backward: ``(dx, dγ, dβ)`` from the gradient ``g`` of the output
    and the forward's ``xhat`` and ``rstd``; ``dx`` in ``xhat``'s dtype, the
    weight gradients float32 (C,) with ``wgrad``, else None. They come as
    one row a block of :func:`wgrad_blocks`, summed here."""
    rows, C = _check("layer_norm_bwd", xhat)
    if g.shape != xhat.shape or g.dtype != xhat.dtype:
        raise ValueError(f"layer_norm_bwd: the gradient must be {xhat.dtype} "
                         f"{tuple(xhat.shape)}, got {g.dtype} {tuple(g.shape)}")
    g, xhat = _lib.aligned(g), _lib.aligned(xhat)
    (gamma,) = _params(xhat, C, weight)
    dx = torch.empty_like(xhat)
    blocks = wgrad_blocks(xhat) if wgrad else 0
    partial = xhat.new_empty((blocks, 2, C), dtype=torch.float32) if wgrad else None
    with torch.cuda.device(xhat.device):
        status = _lib.library().paa_layer_norm_bwd(
            g.data_ptr(), xhat.data_ptr(), rstd.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            partial.data_ptr() if wgrad else None, blocks, rows, C,
            int(xhat.dtype == torch.bfloat16), torch.cuda.current_stream(xhat.device).cuda_stream)
    _lib.check(status, "layer_norm_bwd")
    _lib.launches["layer_norm_bwd"] += 1
    if not wgrad:
        return dx, None, None
    dw, db = partial.sum(0)
    return dx, dw, db


class _LayerNormK7(torch.autograd.Function):
    """K7 forward and backward; saves x̂ in the input's dtype, 1/std and γ,
    what the plain version saves."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        out, xhat, rstd = layer_norm_fwd(x, weight, bias, eps, save=True)
        ctx.save_for_backward(xhat, rstd, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        # autograd casts the float32 dγ, dβ to the parameters' dtype
        xhat, rstd, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = layer_norm_bwd(g.to(xhat.dtype), xhat, rstd, weight, wgrad=need[1] or need[2])
        return (dx if need[0] else None, dw if need[1] else None, db if need[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The LayerNorm of a CUDA ``x`` over its last axis with ``weight`` (γ),
    ``bias`` (β) and ``eps``, through K7, which raises on an input it does
    not take. Differentiable with respect to all three; x̂ and 1/std are
    written only while a gradient will be asked."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return _LayerNormK7.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps, save=False)[0]
