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
    keeps only its compute-dtype input for the backward, never a float32
    copy of the layer;
  * the feature extractor's GELU is the tanh approximation under bf16 and
    exact erf under f32 (``fe_gelu="auto"``; "exact" and "tanh" force one);
  * the positional conv is weight-normed per tap (dim=2), grouped, with
    the SamePad trim of one frame for an even kernel;
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
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from paa_tpu_torch.ops.kernels.attention import attention
from paa_tpu_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (HF field meanings)."""

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
    fe_gelu: str = "auto"  # "auto" | "exact" | "tanh"

    def __post_init__(self):
        for name, allowed in (("feat_extract_norm", ("group", "layer")),
                              ("fe_gelu", ("auto", "exact", "tanh"))):
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


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """float32 statistics, output in the input's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(x.dtype)


class _ChannelLayerNorm(torch.autograd.Function):
    """LayerNorm over the channels of a ``(B, C, T)`` activation: float32
    statistics, output in the input's dtype. The backward keeps the input
    (in its own dtype) and the per-frame mean and 1/std, and recomputes the
    normalised value from them; stock autograd of a float32 LayerNorm would
    keep a float32 copy of every feature-extractor layer (the reference
    keeps it out of HBM the same way, ``_FeNorm``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        xf = x.to(torch.float32, copy=True)
        var, mu = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        y = xf.sub_(mu).mul_(rstd).mul_(weight[:, None]).add_(bias[:, None]).to(x.dtype)
        ctx.save_for_backward(x, mu, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        # in place where it can be: at 20 s and B=32 one float32 copy of
        # layer 0 is 4.2 GB, and this keeps three of them alive at a time
        x, mu, rstd, weight = ctx.saved_tensors
        xhat = x.to(torch.float32, copy=True).sub_(mu).mul_(rstd)
        gf = g.to(torch.float32, copy=True)
        dw = (gf * xhat).sum((0, 2)) if ctx.needs_input_grad[1] else None
        db = gf.sum((0, 2)) if ctx.needs_input_grad[2] else None
        dxhat = gf.mul_(weight[:, None])
        m1 = dxhat.mean(1, keepdim=True)
        m2 = (dxhat * xhat).mean(1, keepdim=True)
        dx = dxhat.sub_(m1).sub_(xhat.mul_(m2)).mul_(rstd).to(x.dtype)
        return dx, dw, db, None


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C_in, T)
        dt = x.dtype
        x = F.conv1d(x, self.conv.weight.to(dt), None, self.stride)
        if self.conv.bias is not None:  # added in the compute dtype after the conv
            x = x + self.conv.bias.to(dt)[:, None]
        n = self.layer_norm
        if isinstance(n, nn.LayerNorm):
            x = _ChannelLayerNorm.apply(x, n.weight, n.bias, n.eps)
        elif n is not None:
            x = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps).to(dt)
        # "auto": tanh GELU under bf16, where its error is below the cast's
        # own; exact erf under f32
        tanh = self.gelu == "tanh" or (self.gelu == "auto" and dt == torch.bfloat16)
        return F.gelu(x, approximate="tanh" if tanh else "none")


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x)
        return x


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
        self.trim = 1 if K % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        dt = x.dtype
        c = self.conv
        y = F.conv1d(x.transpose(1, 2), c.weight.to(dt), c.bias.to(dt), padding=c.padding,
                     groups=c.groups)
        if self.trim:
            y = y[:, :, : -self.trim]
        return F.gelu(y.transpose(1, 2))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        B, T, _ = x.shape
        dt = x.dtype
        if self.axis is not None:
            x = tp.copy_to_model(x, self.axis)
        split = lambda t: t.view(B, T, self.heads, self.head_dim)
        q = _linear(x, self.q_proj, dt) * self.scale
        k = _linear(x, self.k_proj, dt)
        v = _linear(x, self.v_proj, dt)
        ctx = attention(split(q), split(k), split(v)).reshape(B, T, self.heads * self.head_dim)
        if self.axis is not None:
            return tp.row_parallel(ctx, self.out_proj, self.axis, dt)
        return _linear(ctx, self.out_proj, dt)


class FeedForward(nn.Module):
    """The FFN; under tensor parallelism this rank's ``intermediate_size /
    tp`` columns."""

    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        n = axis.size if axis is not None else 1
        self.axis = axis
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size // n)
        self.output_dense = nn.Linear(cfg.intermediate_size // n, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.axis is None:
            return _linear(F.gelu(_linear(x, self.intermediate_dense, dt)), self.output_dense, dt)
        h = F.gelu(_linear(tp.copy_to_model(x, self.axis), self.intermediate_dense, dt))
        return tp.row_parallel(h, self.output_dense, self.axis, dt)


class EncoderLayer(nn.Module):
    """One transformer layer: post-LN (base) or pre-LN (lv60)."""

    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg, axis)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, axis)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.attention(_layer_norm(x, self.layer_norm))
            return x + self.feed_forward(_layer_norm(x, self.final_layer_norm))
        x = _layer_norm(x + self.attention(x), self.layer_norm)
        return _layer_norm(x + self.feed_forward(x), self.final_layer_norm)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, axis: tp.ModelAxis | None = None):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        # before the stack (post-LN), or after it (pre-LN); one HF name
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, axis) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        x = self.feature_extractor(audio[:, None, :].to(self.cfg.dtype))
        x = self.feature_projection(x.transpose(1, 2))
        return self.encoder(x)


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
        if self.cfg.do_normalize:  # per row, population variance, in f32
            var, mu = torch.var_mean(audio, dim=-1, correction=0, keepdim=True)
            audio = (audio - mu) * torch.rsqrt(var + 1e-7)
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
    """Random-init model from an explicit generator, on the CPU: matmul and
    conv weights lecun-normal (std = fan_in^-½), biases 0, norms 1/0, the
    positional conv's direction N(0, 0.02) and its gains 1 (the reference's
    initializers, untruncated)."""
    model = Wav2Vec2ForCTC(cfg)
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
