"""Wav2Vec2-CTC in PyTorch — the frozen ASR target of the attack.

Port of ``paa_tpu/models/wav2vec2.py`` for its three presets:
``wav2vec2-tiny`` and ``wav2vec2-base`` (group-norm feature extractor,
post-LN encoder) and ``wav2vec2-large-lv60`` (conv bias and a LayerNorm in
every feature-extractor layer, pre-LN "stable layer norm" encoder with the
final LayerNorm after the stack, and the input waveform normalised inside
the forward). The module tree uses HF's state-dict names, so the committed
tiny checkpoint and an HF ``Wav2Vec2ForCTC`` state dict load with
``load_state_dict``.

Numerics follow the reference's placement:
  * matmuls and convs run in ``compute_dtype`` (bf16 for base, f32 for tiny);
  * the layer-0 GroupNorm and every LayerNorm take float32 statistics and
    return the compute dtype; the feature extractor's per-layer LayerNorm
    (``_FeNorm``) keeps only its compute-dtype input for the backward, never
    a float32 copy of the layer;
  * the feature extractor's convs run under one of five lowerings
    (``conv_impl``): cuDNN's conv on (B, C, T), or pairdot, im2col, tapdot
    or hybrid (cuDNN forward, ``_HybridConvFn``'s phase-matmul backward)
    on the reference's (B, T, C);
  * ``fused_qkv`` computes q, k and v in one product a layer;
  * the encoder's and the feature projection's LayerNorms (``_LayerNormFn``)
    take the reference's fast variance, ``max(E[x²] − E[x]², 0)``, and keep
    only x̂ in the input's dtype and 1/std for the backward; the FFN's GELU
    (``_GeluFn``) keeps only its input, and with ``remat_ffn`` the whole FFN
    (``_FFNFn``) keeps its input and weights and recomputes the hidden;
  * ``remat`` checkpoints the encoder layers under one of four policies, and
    ``remat_feature_extractor`` the conv stack (``torch.utils.checkpoint``,
    only while grad is on);
  * the feature extractor's GELU is the tanh approximation under bf16 and
    exact erf under f32 (``fe_gelu="auto"``; "exact" and "tanh" force one);
  * the positional conv is weight-normed per tap (dim=2), grouped, with
    the SamePad trim of one frame for an even kernel; it goes through
    ``ops/kernels/pos_conv.py`` (K5 for bf16 on a CUDA tensor, the stock
    ``F.conv1d`` otherwise);
  * the ``lm_head`` runs in float32;
  * attention goes through ``ops/kernels/attention.py`` (K1/K2 on a CUDA
    tensor, their plain version on a CPU tensor);
  * under tensor parallelism (a ``model_axis``) each rank's attention and FFN
    hold its slice of the Megatron layout and reduce their branches over the
    ``model`` axis (``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from paa_tpu_torch.ops.kernels.attention import attention
from paa_tpu_torch.ops.kernels.pos_conv import positional_conv
from paa_tpu_torch.parallel import tp
from paa_tpu_torch.spans import span


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (HF field meanings)."""

    # the model family the preset belongs to (``models/presets.py`` builds by it)
    family: ClassVar[str] = "wav2vec2"

    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (layer 0 only) | "layer" (every layer)
    do_stable_layer_norm: bool = False  # pre-LN encoder layers
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # zero-mean, unit-variance input waveform per row, inside the
    # differentiable forward (HF's processor does it for lv60)
    do_normalize: bool = False
    compute_dtype: str = "bfloat16"
    # Encoder remat, only while grad is on. The policies keep what the
    # reference's keep when attention runs through K1/K2, where scores and
    # probabilities never exist: "full" keeps each layer's input and
    # recomputes the whole layer, K1 included; "save_cheap" keeps everything
    # but the FFN's (B, T, intermediate) hidden, recomputed with one matmul;
    # "no_probs" drops only scores and probabilities, so it keeps what no
    # remat keeps; "save_resid" keeps the layer input, the attention's q, k,
    # v, o and lse and its output, and recomputes both LayerNorms and the FFN.
    remat: bool = False
    remat_policy: str = "full"  # "full" | "save_cheap" | "no_probs" | "save_resid"
    # Feature-extractor remat: one checkpoint over the conv stack keeps only
    # the waveform; with remat_fe_save_layers = k > 0 each of the first k
    # conv layers is a checkpoint of its own (keeping its input) and the
    # rest one more. Off by default here, on in the reference: the reference
    # turns it on to fit B=64 × 10 s on a 16 GB chip, and the H100's 80 GB
    # hold lv60's 20 s batch in two microbatches without it (30.9 GiB), so
    # nothing asks for the recompute until a measurement of its cost does.
    remat_feature_extractor: bool = False
    remat_fe_save_layers: int = 0
    # The FFN through _FFNFn: it keeps its input and weights and recomputes
    # the hidden in the backward, under any remat policy or none.
    remat_ffn: bool = False
    fe_gelu: str = "auto"  # "auto" | "exact" | "tanh"
    # The feature extractor's conv lowering. Every lowering computes the same
    # VALID strided conv from the one nn.Conv1d weight (C_out, C_in, k), so
    # checkpoints and the HF names do not depend on it:
    #   "conv": F.conv1d (cuDNN) on the (B, C, T) layout;
    #   "pairdot": time reshaped into stride-sized phases, (B, T/s, s·C), and
    #     the conv as ceil(k/s) unit-stride products over contiguous time
    #     (the last block's missing taps are zero rows of the weight);
    #   "im2col": the (B, T_out, C·k) patches (Tensor.unfold) and one product;
    #   "tapdot": Σ_r x[:, r::s] @ W_r, one product a tap and no patch buffer
    #     (layer 0, with one input channel, runs im2col);
    #   "hybrid": F.conv1d forward, pairdot's transpose as the backward
    #     (_HybridConvFn).
    # Every lowering but "conv" runs the stack on the reference's (B, T, C)
    # layout, norms included, and accumulates its taps and blocks in float32.
    conv_impl: str = "conv"
    # q, k and v as one (3·H, H) product a layer, the q scale folded into q's
    # weight and bias; the three HF parameter pairs stay as they are.
    fused_qkv: bool = False

    def __post_init__(self):
        for name, allowed in (("feat_extract_norm", ("group", "layer")),
                              ("remat_policy", ("full", "save_cheap", "no_probs", "save_resid")),
                              ("fe_gelu", ("auto", "exact", "tanh")),
                              ("conv_impl", ("conv", "pairdot", "im2col", "tapdot", "hybrid"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}; expected one of {allowed}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def feat_extract_output_length(self, input_length: int) -> int:
        L = input_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            L = (L - k) // s + 1
        return L


PRESETS = {
    # facebook/wav2vec2-base-960h
    "wav2vec2-base": Wav2Vec2Config(),
    # facebook/wav2vec2-large-960h-lv60-self
    "wav2vec2-large-lv60": Wav2Vec2Config(
        hidden_size=1024,
        num_hidden_layers=24,
        num_attention_heads=16,
        intermediate_size=4096,
        conv_bias=True,
        feat_extract_norm="layer",
        do_stable_layer_norm=True,
        do_normalize=True,
    ),
    "wav2vec2-tiny": Wav2Vec2Config(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        conv_dim=(32,) * 7,
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        compute_dtype="float32",
    ),
}


def get_config(name: str, **overrides) -> Wav2Vec2Config:
    if name not in PRESETS:
        raise ValueError(f"Unknown model preset {name!r}; have {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward from
    ``args``. ``preserve_rng_state=False``: nothing in the model draws random
    numbers, so saving and restoring the CUDA RNG state around every region
    (the default) is work, and a host-side read of the generator, that the
    recompute does not need."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm over the last axis in float32, output in the input's dtype
    (reference: ``_layernorm``, ``_LayerNorm``). The variance is the
    reference's fast one, ``max(E[x²] − E[x]², 0)``, which loses digits
    where |mean| ≫ std as Welford's would not: the port follows the
    reference's formula. The backward keeps exactly x̂ in the input's dtype
    and 1/std, never a float32 tensor of the input's size."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        # float32 values from bf16 reads where an op takes them: the mean
        # accumulates in float32, x − mean promotes to it, and the affine is
        # written in the input's dtype from its float32 value
        mean = x.mean(-1, keepdim=True, dtype=torch.float32)
        msq = x.to(torch.float32, copy=True).square_().mean(-1, keepdim=True)
        rstd = torch.rsqrt((msq - mean * mean).clamp_min_(0.0) + eps)
        xhat = torch.sub(x, mean).mul_(rstd)
        out = torch.addcmul(bias, xhat, weight, out=torch.empty_like(x))
        ctx.save_for_backward(xhat.to(x.dtype), rstd, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        # dx = rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)), dx̂ = g·γ. aten's fused
        # LayerNorm backward with x̂ as its input, mean 0 and 1/std 1 is the
        # bracket in one pass, and dγ = Σ g·x̂, dβ = Σ g as they stand; the
        # true 1/std scales dx as it is written in the input's dtype. The
        # same formula in plain elementwise passes took twice the time at
        # lv60's and base's shapes (tools/layernorm_ab.py, PERF.md §6).
        xhat, rstd, weight = ctx.saved_tensors
        need = [bool(n) for n in ctx.needs_input_grad[:3]]
        # its bias argument only shapes dβ, which has γ's shape
        dxhat, dw, db = torch.ops.aten.native_layer_norm_backward(
            g.float(), xhat.float(), [xhat.shape[-1]], torch.zeros_like(rstd),
            torch.ones_like(rstd), weight, weight, need)
        dx = torch.mul(dxhat, rstd, out=torch.empty_like(xhat)) if need[0] else None
        return dx, dw, db, None


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """float32 statistics, output in the input's dtype, lean backward."""
    return _LayerNormFn.apply(x, norm.weight, norm.bias, norm.eps)


class _GeluFn(torch.autograd.Function):
    """The FFN's erf GELU, whose only residual is its input, the hidden that
    ``save_cheap`` recomputes (reference: ``_gelu``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.gelu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x)


class _FFNFn(torch.autograd.Function):
    """``gelu(y·ikᵀ + ib)·okᵀ (+ ob)`` in the compute dtype whose residuals
    are ``(y, ik, ib, ok)``: the backward recomputes the (…, intermediate)
    hidden with one matmul (reference: ``_ffn``). Weights in ``nn.Linear``'s
    (out, in) layout; ``ob`` may be None, as under tensor parallelism, where
    the caller adds the bias once after the reduce."""

    @staticmethod
    def forward(ctx, y, ik, ib, ok, ob):
        ctx.save_for_backward(y, ik, ib, ok)
        ctx.has_ob = ob is not None
        return F.linear(F.gelu(F.linear(y, ik, ib)), ok, ob)

    @staticmethod
    def backward(ctx, g):
        y, ik, ib, ok = ctx.saved_tensors
        need = ctx.needs_input_grad
        h = F.linear(y, ik, ib)
        dh = torch.ops.aten.gelu_backward(g.matmul(ok), h)
        rows = lambda t: t.reshape(-1, t.shape[-1])
        dy = dh.matmul(ik) if need[0] else None
        dik = rows(dh).t().mm(rows(y)) if need[1] else None
        dib = rows(dh).sum(0) if need[2] else None
        dok = rows(g).t().mm(rows(F.gelu(h))) if need[3] else None
        dob = rows(g).sum(0) if ctx.has_ob and need[4] else None
        return dy, dik, dib, dok, dob


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


# ---------------------------------------------------------------------------
# The conv lowerings (``Wav2Vec2Config.conv_impl``). Each takes x (B, T, C),
# the nn.Conv1d weight (O, C, k) and the stride, and gives (B, T_out, O) of a
# VALID strided conv. The products are plain torch.matmul/bmm, as the
# reference's are plain XLA dots.
# ---------------------------------------------------------------------------


def _rows_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for ``a`` (B, M, K) with rows of unit stride at any row
    and batch strides (a strided slice of time), ``w`` (K, N): one batched
    product over ``w`` broadcast. torch.matmul would fold the batch into the
    rows, which copies ``a`` unless it is contiguous."""
    return torch.bmm(a, w.expand(a.shape[0], *w.shape))


def _im2col(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Patches ``(B, T, C) → (B, T_out, C·kernel)`` by ``Tensor.unfold``:
    column ``c·kernel + r`` holds ``x[:, t·stride + r, c]``. That (C, k) order
    is the flattened nn.Conv1d weight's, ``w.reshape(O, C·k)`` (the
    reference's patches are in (k, C) order against its (k, C, O) kernel).
    The backward of unfold is one scatter-add into the input's gradient."""
    B, _, C = x.shape
    return x.unfold(1, kernel, stride).reshape(B, -1, C * kernel)


def _im2col_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """im2col: the patches and one product, accumulated in float32 by the
    matmul and rounded once to the compute dtype."""
    O, C, k = w.shape
    return torch.matmul(_im2col(x, k, stride), w.reshape(O, C * k).t())


def _pairdot_blocks(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The (O, C, k) weight as pairdot's ``(nb, s·C, O)`` phase blocks,
    ``nb = ceil(k/s)``: row ``r·C + c`` of block ``j`` is tap ``j·s + r`` of
    input channel ``c``; the last block's missing taps are zero rows."""
    O, C, k = w.shape
    nb = -(-k // stride)
    wb = F.pad(w, (0, nb * stride - k)).view(O, C, nb, stride)
    return wb.permute(2, 3, 1, 0).reshape(nb, stride * C, O)


def _pairdot_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """pairdot, float32 ``(B, L, O)``: with ``z = x.reshape(B, T/s, s·C)``
    the conv is ``y[t] = Σ_j z[t + j] @ Wb[j]``, ``nb`` products over
    contiguous time. x is zero-padded when the phase grid is longer than T
    and sliced when it is shorter (those samples meet only zero rows or no
    output). Each product is rounded to the compute dtype before the float32
    sum (the reference keeps its products in float32)."""
    B, T, C = x.shape
    k = w.shape[2]
    s = stride
    L = (T - k) // s + 1
    nb = -(-k // s)
    need = (L - 1 + nb) * s
    if need > T:
        x = F.pad(x, (0, 0, 0, need - T))
    z = x[:, :need].reshape(B, L - 1 + nb, s * C)
    wb = _pairdot_blocks(w, s)
    y = _rows_dot(z[:, :L], wb[0]).float()
    for j in range(1, nb):
        y += _rows_dot(z[:, j:j + L], wb[j])
    return y


def _tapdot_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """tapdot, float32 ``(B, L, O)``: ``Σ_r x[:, r : r+span : s] @ W_r``, one
    product a tap over a strided view of x with the whole C_in contracted
    and no patch buffer. Each product is rounded to the compute dtype before
    the float32 sum. The backward of each strided slice writes a
    zero-filled gradient of x's full size."""
    T = x.shape[1]
    k = w.shape[2]
    L = (T - k) // stride + 1
    span = (L - 1) * stride + 1
    taps = w.permute(2, 1, 0).contiguous()  # (k, C, O)
    y = _rows_dot(x[:, :span:stride], taps[0]).float()
    for r in range(1, k):
        y += _rows_dot(x[:, r:r + span:stride], taps[r])
    return y


class _HybridConvFn(torch.autograd.Function):
    """hybrid: ``F.conv1d`` forward and pairdot's transpose as the backward
    (reference: ``_hybrid_conv``). x (B, T, C), w (O, C, k) → (B, L, O). The
    backward's input gradient is ``nb`` products over the (B, lz, s·C)
    phase grid, overlap-added and un-reshaped into time; its weight
    gradient, when asked for, ``nb`` contractions over B·L. It keeps only
    ``(x, w)``, as the reference's residuals."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        # F.conv1d of the (B, C, T) view: torch copies it into cuDNN's
        # layout, and .contiguous() copies the output back to (B, T, C)
        return F.conv1d(x.transpose(1, 2), w, None, stride).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        s = ctx.stride
        B, T, C = x.shape
        O, _, k = w.shape
        L = dy.shape[1]
        nb = -(-k // s)
        lz = L - 1 + nb
        need = lz * s
        wb = _pairdot_blocks(w, s)  # (nb, s·C, O)
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dz[u] = Σ_j dy[u − j] @ wb[j]ᵀ, summed in float32; each product
            # is rounded to the compute dtype first (the reference's are
            # float32)
            dz = dy.new_zeros((B, lz, s * C), dtype=torch.float32)
            for j in range(nb):
                dz[:, j:j + L] += torch.matmul(dy, wb[j].t())
            dz = dz.view(B, need, C)
            # the forward's geometry: samples past the grid never enter the
            # conv (zero gradient), grid rows past T are dropped
            dx = (dz[:, :T] if need >= T else F.pad(dz, (0, 0, 0, T - need))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            z = x if need <= T else F.pad(x, (0, 0, 0, need - T))
            z = z[:, :need].reshape(B, lz, s * C)
            rows = dy.reshape(B * L, O)
            dwb = torch.stack([z[:, j:j + L].reshape(B * L, s * C).t() @ rows
                               for j in range(nb)])
            dw = dwb.view(nb * s, C, O)[:k].permute(2, 1, 0).contiguous()
        return dx, dw, None


def feature_conv(impl: str, x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """One feature-extractor conv, without its bias, in ``x``'s dtype, under
    the lowering ``impl``: ``conv`` maps (B, C_in, T) to (B, C_out, T_out),
    every other lowering (B, T, C_in) to (B, T_out, C_out)."""
    if impl == "conv":
        return F.conv1d(x, w, None, stride)
    if impl == "hybrid":
        return _HybridConvFn.apply(x, w, stride)
    if impl == "pairdot":
        return _pairdot_conv(x, w, stride).to(x.dtype)
    if impl == "tapdot" and x.shape[-1] > 1:
        return _tapdot_conv(x, w, stride).to(x.dtype)
    # im2col, and tapdot on layer 0, where one input channel leaves no
    # contraction to split (the reference falls through the same way)
    return _im2col_conv(x, w, stride)


class ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, layer_id: int):
        super().__init__()
        in_ch = 1 if layer_id == 0 else cfg.conv_dim[layer_id - 1]
        out_ch = cfg.conv_dim[layer_id]
        self.stride = cfg.conv_stride[layer_id]
        self.conv = nn.Conv1d(in_ch, out_ch, cfg.conv_kernel[layer_id],
                              stride=self.stride, bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":  # every layer, over channels (lv60)
            self.layer_norm = nn.LayerNorm(out_ch, eps=cfg.layer_norm_eps)
        elif layer_id == 0:  # per-channel GroupNorm over time (base)
            self.layer_norm = nn.GroupNorm(out_ch, out_ch, eps=cfg.layer_norm_eps, affine=True)
        else:
            self.layer_norm = None
        self.gelu = cfg.fe_gelu
        self.impl = cfg.conv_impl
        # the channel axis: (B, C, T) under "conv", (B, T, C) otherwise
        self.channel_dim = 1 if cfg.conv_impl == "conv" else 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        c = self.channel_dim
        x = feature_conv(self.impl, x, self.conv.weight.to(dt), self.stride)
        if self.conv.bias is not None:  # added in the compute dtype after the conv
            bias = self.conv.bias.to(dt)
            x = x + (bias[:, None] if c == 1 else bias)
        n = self.layer_norm
        if isinstance(n, nn.LayerNorm):
            x = _FeNorm.apply(x, n.weight, n.bias, n.eps, c)
        elif n is not None and c == 1:
            x = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps).to(dt)
        elif n is not None:
            # torch's GroupNorm on the (B, C, T) view: the float32 cast
            # writes that layout, one more copy writes the result back in
            # (B, T, C); eager passes over time (as _FeNorm's) would cost
            # several times that at layer 0's size
            xt = x.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)
            x = F.group_norm(xt, n.num_groups, n.weight, n.bias, n.eps).to(dt)
            x = x.transpose(1, 2).contiguous()
        # "auto": tanh GELU under bf16, where its error is below the cast's
        # own; exact erf under f32
        tanh = self.gelu == "tanh" or (self.gelu == "auto" and dt == torch.bfloat16)
        return F.gelu(x, approximate="tanh" if tanh else "none")


class FeatureExtractor(nn.Module):
    """The conv stack: the waveform (B, T) in the compute dtype → (B,
    frames, C). ``conv`` runs it on (B, C, T), cuDNN's layout, and hands the
    transposed view on; the other lowerings run it on (B, T, C), where a
    phase reshape of time is a view and no conv needs a transpose (base's
    layer-0 GroupNorm copies its layer once each way)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))
        self.remat = cfg.remat_feature_extractor
        self.save_layers = cfg.remat_fe_save_layers
        self.channels_last = cfg.conv_impl != "conv"

    def _layers(self, x: torch.Tensor, start: int) -> torch.Tensor:
        for layer in self.conv_layers[start:]:
            x = layer(x)
        return x

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self._layers(x, 0)
        # the first k layers one checkpoint each, keeping their inputs (the
        # reference's "fe_out"); the rest one checkpoint
        k = min(self.save_layers, len(self.conv_layers))
        for layer in self.conv_layers[:k]:
            x = _checkpoint(layer, x)
        return _checkpoint(self._layers, x, k) if k < len(self.conv_layers) else x

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        with span("paa.fe"):
            if self.channels_last:
                return self._stack(audio[:, :, None])
            return self._stack(audio[:, None, :]).transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(_layer_norm(x, self.layer_norm), self.projection, x.dtype)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        K = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, K, padding=K // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        # weight = g · v / ‖v‖ with one gain per kernel tap
        nn.utils.parametrizations.weight_norm(self.conv, name="weight", dim=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        with span("paa.pos_conv"):
            dt = x.dtype
            c = self.conv
            return positional_conv(x, c.weight.to(dt), c.bias.to(dt))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention of ``(B, T, heads·d)`` q (scaled), k and v through
    the attention kernels (K1/K2 on a CUDA tensor), ``(B, T, heads·d)``."""
    B, T, width = q.shape
    split = lambda t: t.view(B, T, heads, width // heads)
    with span("paa.attention"):
        ctx = attention(split(q), split(k), split(v))
    return ctx.reshape(B, T, width)


class SelfAttention(nn.Module):
    """Self-attention; under tensor parallelism (``axis``) this rank's
    ``heads / tp`` heads, with the branch's collectives of ``parallel/tp.py``
    (the reference's ``_manual_shard``: K1/K2 on the local heads)."""

    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        H = cfg.hidden_size
        n = axis.size if axis is not None else 1
        self.axis = axis
        self.heads = cfg.num_attention_heads // n
        self.head_dim = H // cfg.num_attention_heads
        self.scale = self.head_dim ** -0.5
        local = self.heads * self.head_dim
        self.q_proj = nn.Linear(H, local)
        self.k_proj = nn.Linear(H, local)
        self.v_proj = nn.Linear(H, local)
        self.out_proj = nn.Linear(local, H)
        self.fused = cfg.fused_qkv

    def _fused_qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """q, k and v from one (3·local, H) product (reference: the
        ``fused_qkv`` branch): this rank's q, k and v slices concatenated,
        the q scale folded into q's weight and bias in float32, then cast."""
        dt = x.dtype
        q, k, v = self.q_proj, self.k_proj, self.v_proj
        w = torch.cat([q.weight.float() * self.scale, k.weight.float(), v.weight.float()])
        b = torch.cat([q.bias.float() * self.scale, k.bias.float(), v.bias.float()])
        return F.linear(x, w.to(dt), b.to(dt)).split(self.heads * self.head_dim, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        dt = x.dtype
        if self.axis is not None:
            x = tp.copy_to_model(x, self.axis)
        if self.fused:
            q, k, v = self._fused_qkv(x)
        else:
            q = _linear(x, self.q_proj, dt) * self.scale
            k = _linear(x, self.k_proj, dt)
            v = _linear(x, self.v_proj, dt)
        ctx = attend(q, k, v, self.heads)
        if self.axis is not None:
            return tp.row_parallel(ctx, self.out_proj, self.axis, dt)
        return _linear(ctx, self.out_proj, dt)


class FeedForward(nn.Module):
    """The FFN, its activation ``act`` the erf GELU (wav2vec2) or SiLU (the
    conformer, whose config refuses remat); under tensor parallelism this
    rank's ``intermediate_size / tp`` columns. With ``remat_ffn`` it runs as
    ``_FFNFn``; under the ``save_cheap`` policy the hidden and its GELU are
    one checkpoint, which keeps the FFN's input in place of the hidden."""

    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None,
                 act: str = "gelu"):
        super().__init__()
        n = axis.size if axis is not None else 1
        self.axis = axis
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size // n)
        self.output_dense = nn.Linear(cfg.intermediate_size // n, cfg.hidden_size)
        self.lean = cfg.remat_ffn
        self.recompute_hidden = cfg.remat and cfg.remat_policy == "save_cheap"
        self.silu = act == "silu"

    def _hidden(self, y: torch.Tensor) -> torch.Tensor:
        h = _linear(y, self.intermediate_dense, y.dtype)
        # torch's SiLU keeps only its input for the backward, as _GeluFn does
        return F.silu(h) if self.silu else _GeluFn.apply(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.axis is not None:
            x = tp.copy_to_model(x, self.axis)
        if self.lean:
            inner, outer = self.intermediate_dense, self.output_dense
            ob = outer.bias.to(dt)
            if self.axis is None:
                return _FFNFn.apply(x, inner.weight.to(dt), inner.bias.to(dt),
                                    outer.weight.to(dt), ob)
            partial = _FFNFn.apply(x, inner.weight.to(dt), inner.bias.to(dt),
                                   outer.weight.to(dt), None)
            return tp.reduce_from_model(partial, self.axis) + ob
        if self.recompute_hidden and torch.is_grad_enabled():
            h = _checkpoint(self._hidden, x)
        else:
            h = self._hidden(x)
        if self.axis is None:
            return _linear(h, self.output_dense, dt)
        return tp.row_parallel(h, self.output_dense, self.axis, dt)


class EncoderLayer(nn.Module):
    """One transformer layer: post-LN (base) or pre-LN (lv60), checkpointed
    as ``cfg.remat_policy`` says while grad is on (``Wav2Vec2Config``)."""

    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg, axis)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, axis)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        # "save_cheap" lives in FeedForward; "no_probs" keeps what no remat keeps
        self.remat = cfg.remat_policy if cfg.remat and cfg.remat_policy in ("full",
                                                                         "save_resid") else None

    def _tail(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Everything after the attention's output ``a``."""
        if self.pre_ln:
            x = x + a
            return x + self.feed_forward(_layer_norm(x, self.final_layer_norm))
        x = _layer_norm(x + a, self.layer_norm)
        return _layer_norm(x + self.feed_forward(x), self.final_layer_norm)

    def _layer(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(x, self.layer_norm) if self.pre_ln else x
        return self._tail(x, self.attention(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat is None or not torch.is_grad_enabled():
            return self._layer(x)
        if self.remat == "full":
            return _checkpoint(self._layer, x)
        # save_resid: the attention block runs outside the checkpoints and
        # keeps its q, k, v, o and lse; the LayerNorms and the FFN are
        # recomputed from the layer input and the attention's output
        h = _checkpoint(_layer_norm, x, self.layer_norm) if self.pre_ln else x
        return _checkpoint(self._tail, x, self.attention(h))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        # before the stack (post-LN), or after it (pre-LN); one HF name
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, axis) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("paa.encoder"):
            x = x + self.pos_conv_embed(x)
            if not self.pre_ln:
                x = _layer_norm(x, self.layer_norm)
            for layer in self.layers:
                x = layer(x)
            return _layer_norm(x, self.layer_norm) if self.pre_ln else x


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg, axis)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, T) float32
        x = self.feature_projection(self.feature_extractor(audio.to(self.cfg.dtype)))
        return self.encoder(x)


def normalize_audio(audio: torch.Tensor) -> torch.Tensor:
    """Each row at zero mean and unit (population) variance, in float32."""
    var, mu = torch.var_mean(audio, dim=-1, correction=0, keepdim=True)
    return (audio - mu) * torch.rsqrt(var + 1e-7)


class Wav2Vec2ForCTC(nn.Module):
    """Raw waveform ``(B, T)`` → CTC logits ``(B, frames, vocab)`` float32.

    With ``model_axis`` (``parallel/tp.py``) the encoder's attention and FFN
    hold this rank's slice of the Megatron layout (``tp.shard_model`` builds
    it from the full model); everything else is the full model's."""

    def __init__(self, cfg: Wav2Vec2Config, model_axis: tp.ModelAxis | None = None):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg, model_axis)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self._register_load_state_dict_pre_hook(_hf_compat)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if self.cfg.do_normalize:
            audio = normalize_audio(audio)
        x = self.wav2vec2(audio)
        return F.linear(x.float(), self.lm_head.weight, self.lm_head.bias)

    def cast_param_storage(self, dtype: torch.dtype) -> "Wav2Vec2ForCTC":
        """Store the matmul and feature-extractor conv weights in ``dtype``;
        the ``lm_head``, biases, norms and the weight-normed positional conv
        keep float32 (reference: ``cast_param_storage``). Under a bf16
        compute dtype the outputs are unchanged: every weight is cast to
        the compute dtype before use."""
        for module in self.modules():
            if module is self.lm_head:
                continue
            if isinstance(module, nn.Linear) or isinstance(module, ConvLayer):
                layer = module.conv if isinstance(module, ConvLayer) else module
                layer.weight.data = layer.weight.data.to(dtype)
        return self


_LEGACY_WEIGHT_NORM = {"weight_g": "parametrizations.weight.original0",
                       "weight_v": "parametrizations.weight.original1"}


def _hf_compat(state_dict, prefix, *_args):
    """HF checkpoints carry the spec-augment mask embedding, which only
    training uses: drop it. Older dumps name the positional conv's weight
    norm ``weight_g``/``weight_v``: rename them."""
    state_dict.pop(prefix + "wav2vec2.masked_spec_embed", None)
    pce = prefix + "wav2vec2.encoder.pos_conv_embed.conv."
    for old, new in _LEGACY_WEIGHT_NORM.items():
        if pce + old in state_dict:
            state_dict[pce + new] = state_dict.pop(pce + old)


def init_model(cfg: Wav2Vec2Config, seed: int = 0) -> Wav2Vec2ForCTC:
    """Random-init model from an explicit generator, on the CPU
    (:func:`init_weights`)."""
    return init_weights(Wav2Vec2ForCTC(cfg), seed)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """``model``'s parameters drawn from an explicit generator, in the order
    of ``named_parameters``: matmul and conv weights lecun-normal (std =
    fan_in^-½), biases 0, norms 1/0, the positional conv's direction N(0,
    0.02) and its gains 1 (the reference's initializers, untruncated);
    buffers (a BatchNorm's running mean 0 and variance 1) as built. The
    model frozen, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("original0"):  # weight-norm gain per tap
                p.fill_(1.0)
            elif name.endswith("original1"):  # weight-norm direction
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in**-0.5)
    return model.requires_grad_(False).eval()
