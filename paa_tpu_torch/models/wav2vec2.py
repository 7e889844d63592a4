"""Wav2Vec2-CTC in PyTorch — the frozen ASR target of the attack.

Port of ``paa_tpu/models/wav2vec2.py`` for the presets ``wav2vec2-tiny``
and ``wav2vec2-base`` (group-norm feature extractor, post-LN encoder). The
module tree uses HF's state-dict names, so the committed tiny checkpoint
and an HF ``Wav2Vec2ForCTC`` state dict load with ``load_state_dict``.

Numerics follow the reference's placement:
  * matmuls and convs run in ``compute_dtype`` (bf16 for base, f32 for tiny);
  * the layer-0 GroupNorm and every LayerNorm take float32 statistics and
    return the compute dtype;
  * the feature extractor's GELU is the tanh approximation under bf16 and
    exact erf under f32 (the reference's ``fe_gelu="auto"``);
  * the positional conv is weight-normed per tap (dim=2), grouped, with
    the SamePad trim of one frame for an even kernel;
  * the ``lm_head`` runs in float32;
  * attention goes through ``ops/kernels/attention.py`` (K1/K2 on a CUDA
    tensor, their plain version on a CPU tensor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from paa_tpu_torch.ops.kernels.attention import attention


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
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"

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


class ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, layer_id: int):
        super().__init__()
        in_ch = 1 if layer_id == 0 else cfg.conv_dim[layer_id - 1]
        out_ch = cfg.conv_dim[layer_id]
        self.stride = cfg.conv_stride[layer_id]
        self.conv = nn.Conv1d(in_ch, out_ch, cfg.conv_kernel[layer_id],
                              stride=self.stride, bias=False)
        # per-channel GroupNorm over time on layer 0 only (base checkpoint)
        self.layer_norm = (
            nn.GroupNorm(out_ch, out_ch, eps=cfg.layer_norm_eps, affine=True)
            if layer_id == 0 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C_in, T)
        dt = x.dtype
        x = F.conv1d(x, self.conv.weight.to(dt), None, self.stride)
        if self.layer_norm is not None:
            n = self.layer_norm
            x = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps).to(dt)
        # tanh GELU under bf16, where its error is below the cast's own;
        # exact erf under f32
        return F.gelu(x, approximate="tanh" if dt == torch.bfloat16 else "none")


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
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        H = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.scale = (H // self.heads) ** -0.5
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H)
        B, T, H = x.shape
        dt = x.dtype
        split = lambda t: t.view(B, T, self.heads, H // self.heads)
        q = _linear(x, self.q_proj, dt) * self.scale
        k = _linear(x, self.k_proj, dt)
        v = _linear(x, self.v_proj, dt)
        ctx = attention(split(q), split(k), split(v))
        return _linear(ctx.reshape(B, T, H), self.out_proj, dt)


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return _linear(F.gelu(_linear(x, self.intermediate_dense, dt)), self.output_dense, dt)


class EncoderLayer(nn.Module):
    """One post-LN transformer layer (base)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(x + self.attention(x), self.layer_norm)
        return _layer_norm(x + self.feed_forward(x), self.final_layer_norm)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(x + self.pos_conv_embed(x), self.layer_norm)
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, T) float32
        x = self.feature_extractor(audio[:, None, :].to(self.cfg.dtype))
        x = self.feature_projection(x.transpose(1, 2))
        return self.encoder(x)


class Wav2Vec2ForCTC(nn.Module):
    """Raw waveform ``(B, T)`` → CTC logits ``(B, frames, vocab)`` float32."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        # HF checkpoints carry the spec-augment mask embedding, which only
        # training uses; drop it so their state dicts load as they are
        self._register_load_state_dict_pre_hook(_drop_spec_augment)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
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


def _drop_spec_augment(state_dict, prefix, *_args):
    state_dict.pop(prefix + "wav2vec2.masked_spec_embed", None)


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
