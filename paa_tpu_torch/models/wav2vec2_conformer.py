"""Wav2Vec2-Conformer-CTC with rotary positions in PyTorch.

The preset ``wav2vec2-conformer-rope-large`` is
facebook/wav2vec2-conformer-rope-large-960h-ft: lv60's feature extractor and
feature projection (``models/wav2vec2.py``'s own modules), then a stack of
Conformer blocks (arXiv 2005.08100) and one LayerNorm after it. The module
tree uses the state-dict names of ``transformers``'
``Wav2Vec2ConformerForCTC``, so an HF state dict loads with
``load_state_dict``; its positional conv (built there, never called), its
spec-augment embedding and its rotary ``inv_freq`` buffer are dropped at load.
Each block, as ``modeling_wav2vec2_conformer.py`` writes it:

    x = x + ½·FFN₁(LN(x))       SiLU FFN
    x = x + Attn(LN(x))          rotary on the normed state before the q and
                                 k products; v takes the unrotated state
    x = x + Conv(x)              LN → pointwise H→2H → GLU → depthwise conv
                                 (k taps, H groups, no bias) → BatchNorm on
                                 its running statistics → SiLU → pointwise H→H
    x = LN(x + ½·FFN₂(LN(x)))

Numerics as lv60's: products in the compute dtype with float32 sums, every
LayerNorm through ``_LayerNormFn`` (float32 statistics), the head in
float32. The BatchNorm's scale ``γ/√(var + ε)`` and shift ``β − mean·scale``
are folded in float32 into the depthwise conv's weight and bias, which
``F.conv1d`` (cuDNN on the card) runs with its input gradient. The rotary
table (HF's: ``cos`` and ``sin`` of ``t·base^(−2i/d)``, each head's two
halves rotated together) is built once per frame count in float32 and
applied in the compute dtype, as HF applies it.

The wav2vec2 encoder's knobs are refused here: ``remat``, a ``remat_policy``,
``remat_ffn`` and ``fused_qkv`` raise in the config, tensor parallelism in
``parallel/tp.py``. ``counts`` counts depthwise-conv calls and rotary tables
(``reset_counts()`` zeroes them).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from paa_tpu_torch.models.wav2vec2 import (FeatureExtractor, FeatureProjection, FeedForward,
                                           Wav2Vec2Config, _layer_norm, _linear, attend,
                                           normalize_audio)
from paa_tpu_torch.spans import span

# dwconv / dwconv_dgrad: the depthwise conv's forward and input-gradient
# calls (one of each a layer and microbatch of an attack step);
# rotary_tables: cos/sin tables built (one a frame count and model)
counts = {"dwconv": 0, "dwconv_dgrad": 0, "rotary_tables": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


@dataclasses.dataclass(frozen=True)
class ConformerConfig(Wav2Vec2Config):
    """The feature extractor's and the encoder's widths as in
    ``Wav2Vec2Config``, with the conformer's own two fields. The positional
    conv's fields and ``do_stable_layer_norm`` are not read."""

    family: ClassVar[str] = "wav2vec2-conformer"

    conv_depthwise_kernel_size: int = 31
    rotary_embedding_base: int = 10000

    def __post_init__(self):
        super().__post_init__()
        refused = {"remat": self.remat, "remat_policy": self.remat_policy != "full",
                   "remat_ffn": self.remat_ffn, "fused_qkv": self.fused_qkv}
        for knob, on in refused.items():
            if on:
                raise ValueError(f"{knob}={getattr(self, knob)!r}: the wav2vec2-conformer "
                                 "family does not take it")
        if self.conv_depthwise_kernel_size % 2 == 0:
            raise ValueError("conv_depthwise_kernel_size must be odd for 'same' padding")


PRESETS = {
    # facebook/wav2vec2-conformer-rope-large-960h-ft
    "wav2vec2-conformer-rope-large": ConformerConfig(
        hidden_size=1024,
        num_hidden_layers=24,
        num_attention_heads=16,
        intermediate_size=4096,
        conv_bias=True,
        feat_extract_norm="layer",
        do_normalize=True,
    ),
}


def _rotate(h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> torch.Tensor:
    """HF's rotary on ``h`` (B, T, heads·d) with ``cos``, ``sin`` (T, 1, d):
    ``h·cos + [−h₂, h₁]·sin`` per head, h₁ and h₂ its two halves."""
    B, T, width = h.shape
    x = h.view(B, T, heads, width // heads)
    x1, x2 = x.chunk(2, dim=-1)
    return (x * cos + torch.cat((-x2, x1), dim=-1) * sin).view(B, T, width)


class ConformerSelfAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        H = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.scale = (H // self.heads) ** -0.5
        self.linear_q = nn.Linear(H, H)
        self.linear_k = nn.Linear(H, H)
        self.linear_v = nn.Linear(H, H)
        self.linear_out = nn.Linear(H, H)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        r = _rotate(h, cos, sin, self.heads)
        q = _linear(r, self.linear_q, dt) * self.scale
        k = _linear(r, self.linear_k, dt)
        v = _linear(h, self.linear_v, dt)
        return _linear(attend(q, k, v, self.heads), self.linear_out, dt)


class _DepthwiseConvFn(torch.autograd.Function):
    """``F.conv1d`` with one group a channel on ``x`` (B, T, C) read as (B,
    C, T), bias ``b``; the backward is cuDNN's input gradient
    (``conv1d_input``), and the input is kept only where the weight needs a
    gradient."""

    @staticmethod
    def forward(ctx, x, w, b, pad: int):
        counts["dwconv"] += 1
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        ctx.pad, ctx.x_shape = pad, x.shape
        return F.conv1d(x.transpose(1, 2), w, b, padding=pad, groups=w.shape[0]).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        B, T, C = ctx.x_shape
        gt = g.transpose(1, 2)
        dx = dw = db = None
        if need[0]:
            counts["dwconv_dgrad"] += 1
            dx = torch.nn.grad.conv1d_input((B, C, T), w, gt, padding=ctx.pad,
                                            groups=C).transpose(1, 2)
        if need[1]:
            dw = torch.nn.grad.conv1d_weight(x.transpose(1, 2), w.shape, gt, padding=ctx.pad,
                                             groups=C)
        if need[2]:
            db = g.sum((0, 1))
        return dx, dw, db, None


class DepthwiseConv(nn.Conv1d):
    """The conv module's depthwise conv, with the BatchNorm that follows it
    folded in: ``forward(x, scale, shift)`` on (B, T, C)."""

    def __init__(self, channels: int, kernel: int):
        super().__init__(channels, channels, kernel, padding=(kernel - 1) // 2,
                         groups=channels, bias=False)

    def forward(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        w = (self.weight.float() * scale[:, None, None]).to(dt)
        with span("paa.dwconv"):
            return _DepthwiseConvFn.apply(x, w, shift.to(dt), self.padding[0])


def _pointwise(conv: nn.Conv1d, dt) -> torch.Tensor:
    """A kernel-1 conv's (O, C, 1) weight as a linear layer's (O, C)."""
    return conv.weight.to(dt)[:, :, 0]


class ConvolutionModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        H = cfg.hidden_size
        self.layer_norm = nn.LayerNorm(H)  # HF's default eps, not layer_norm_eps
        self.pointwise_conv1 = nn.Conv1d(H, 2 * H, 1, bias=False)
        self.depthwise_conv = DepthwiseConv(H, cfg.conv_depthwise_kernel_size)
        self.batch_norm = nn.BatchNorm1d(H)
        self.pointwise_conv2 = nn.Conv1d(H, H, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        with span("paa.conv_module"):
            dt = x.dtype
            y = F.linear(_layer_norm(x, self.layer_norm), _pointwise(self.pointwise_conv1, dt))
            y = F.glu(y, dim=-1)
            bn = self.batch_norm
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            y = self.depthwise_conv(y, scale, bn.bias - bn.running_mean * scale)
            return F.linear(F.silu(y), _pointwise(self.pointwise_conv2, dt))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        H = cfg.hidden_size
        self.ffn1_layer_norm = nn.LayerNorm(H)
        self.ffn1 = FeedForward(cfg, act="silu")
        self.self_attn_layer_norm = nn.LayerNorm(H)
        self.self_attn = ConformerSelfAttention(cfg)
        self.conv_module = ConvolutionModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(H)
        self.ffn2 = FeedForward(cfg, act="silu")
        self.final_layer_norm = nn.LayerNorm(H)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        # x + ½·f in one pass; ½·f is exact, so it rounds as HF's f·½ + x
        x = torch.add(x, self.ffn1(_layer_norm(x, self.ffn1_layer_norm)), alpha=0.5)
        x = x + self.self_attn(_layer_norm(x, self.self_attn_layer_norm), cos, sin)
        x = x + self.conv_module(x)
        x = torch.add(x, self.ffn2(_layer_norm(x, self.ffn2_layer_norm)), alpha=0.5)
        return _layer_norm(x, self.final_layer_norm)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.base = cfg.rotary_embedding_base
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self._tables: dict = {}

    def rotary(self, frames: int, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """``(cos, sin)``, each (frames, 1, head_dim) in ``dtype``, built once
        a frame count (and device and dtype) for the life of the module."""
        key = (frames, device, dtype)
        if key not in self._tables:
            counts["rotary_tables"] += 1
            d = self.head_dim
            inv_freq = 1.0 / (self.base ** (torch.arange(0, d, 2, device=device).float() / d))
            freqs = torch.outer(torch.arange(frames, device=device).float(), inv_freq)
            emb = torch.cat((freqs, freqs), dim=-1)[:, None, :]
            self._tables[key] = (emb.cos().to(dtype), emb.sin().to(dtype))
        return self._tables[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("paa.encoder"):
            cos, sin = self.rotary(x.shape[1], x.device, x.dtype)
            for layer in self.layers:
                x = layer(x, cos, sin)
            return _layer_norm(x, self.layer_norm)


class Wav2Vec2ConformerModel(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = ConformerEncoder(cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, T) float32
        x = self.feature_projection(self.feature_extractor(audio.to(self.cfg.dtype)))
        return self.encoder(x)


class Wav2Vec2ConformerForCTC(nn.Module):
    """Raw waveform ``(B, T)`` → CTC logits ``(B, frames, vocab)`` float32."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2_conformer = Wav2Vec2ConformerModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self._register_load_state_dict_pre_hook(_hf_compat)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if self.cfg.do_normalize:
            audio = normalize_audio(audio)
        x = self.wav2vec2_conformer(audio)
        return F.linear(x.float(), self.lm_head.weight, self.lm_head.bias)

    def cast_param_storage(self, dtype: torch.dtype) -> "Wav2Vec2ConformerForCTC":
        """Store every matmul and conv weight in ``dtype``; the ``lm_head``,
        biases, norms and the BatchNorm keep float32. Under a compute dtype
        of ``dtype`` the outputs are unchanged."""
        for module in self.modules():
            if module is not self.lm_head and isinstance(module, (nn.Linear, nn.Conv1d)):
                module.weight.data = module.weight.data.to(dtype)
        return self


def _hf_compat(state_dict, prefix, *_args):
    """Drop what an HF checkpoint holds and the forward never reads: the
    spec-augment embedding, the positional conv and the rotary ``inv_freq``
    (a function of the config)."""
    root = prefix + "wav2vec2_conformer."
    state_dict.pop(root + "masked_spec_embed", None)
    state_dict.pop(root + "encoder.embed_positions.inv_freq", None)
    for key in [k for k in state_dict if k.startswith(root + "encoder.pos_conv_embed.")]:
        del state_dict[key]
