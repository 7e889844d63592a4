"""A plain Wav2Vec2-Conformer with relative positions for CTC, in float32, on
HF's parameter names.

It follows the published model (``transformers``' ``Wav2Vec2ConformerForCTC``
with ``position_embeddings_type="relative"``, in eval mode): the rotary
conformer's feature extractor, feature projection, SiLU FFNs, conv module and
final LayerNorm (``reference/wav2vec2-conformer.py``, whose functions it
calls), and Transformer-XL's attention (arXiv 1901.02860 §3.3) as HF's
``_apply_relative_embeddings`` writes it:

    scores = ((q + u)·kᵀ + rel_shift((q + v)·Pᵀ)) / √d

with ``P = linear_pos(pe)``, ``pe`` HF's sinusoid table of 2T − 1 rows (row r
at relative position T − 1 − r; ``Wav2Vec2ConformerRelPositionalEmbedding``),
and ``rel_shift`` its pad-and-reshape, written literally, a group of heads at
a time so that a 30 s clip's (T, 2T − 1) scores fit. There is no rotary and
no positional conv. With ``do_normalize`` each row of audio is brought to
zero mean and unit variance first.

Precision as ``reference/wav2vec2.py`` sets it (its ``Precision``: the fp8
control rounds the operands of every convolution and matrix product,
``linear_pos`` and attention's three products included); TF32 is turned off
here; its ``ctc_losses``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import family
from portbench.reference.wav2vec2 import Precision, _conv, _layer_norm, _linear, ctc_losses

__all__ = ["KINDS", "Precision", "ctc_losses", "forward", "param_specs"]

_ROTARY = family.reference({"family": "wav2vec2-conformer"})
ROOT, FE, ENC = _ROTARY.ROOT, _ROTARY.FE, _ROTARY.ENC
HEADS_AT_ONCE = 4  # heads whose (T, 2T − 1) scores are made together

POS_STD = 4.0  # the standard deviation of each entry of P = linear_pos(pe)


def _pos_columns(width: int, device) -> torch.Tensor:
    """The scale of each input column of ``linear_pos``: channel c of the
    sinusoid (frequency ω = 10000^(−2⌊c/2⌋/width) radians a frame) weighted
    by ω, so that neighbouring rows of P differ (their difference has 0.24
    of the variance of two unrelated rows', 0.026 with equal columns), and
    every entry of P is N(0, POS_STD²) at every row."""
    omega = torch.exp(torch.arange(0, width, 2, device=device).float()
                      * -(math.log(10000.0) / width))
    return (omega * POS_STD / torch.linalg.vector_norm(omega)).repeat_interleave(2)


# the rotary conformer's kinds; pos_bias_u / pos_bias_v N(0, 1), about the
# size of q's entries, so that a dropped or swapped bias shows (HF makes them
# zeros before its init); linear_pos by frequency (``_pos_columns``), so that
# the positional term is sharp and a relative shift one row off shows (with
# N(0, 1/fan_in) P's neighbouring rows nearly agree and attention spreads
# over hundreds of frames)
KINDS = {**_ROTARY.KINDS, "pos_bias": lambda x, shape, cfg: x.clone(),
         "linear_pos": lambda x, shape, cfg: (
             x * _pos_columns(shape[1], x.device)).to(torch.bfloat16)}


def param_specs(cfg: dict) -> dict:
    """The rotary conformer's table with each attention's ``linear_pos``
    (served in bfloat16 as a matrix product's weight), ``pos_bias_u`` and
    ``pos_bias_v`` after its ``linear_out``."""
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    specs = {}
    for name, spec in _ROTARY.param_specs(cfg).items():
        specs[name] = spec
        if name.endswith(".self_attn.linear_out.bias"):
            pre = name[: -len("linear_out.bias")]
            specs[pre + "linear_pos.weight"] = ((H, H), "linear_pos")
            specs[pre + "pos_bias_u"] = ((heads, H // heads), "pos_bias")
            specs[pre + "pos_bias_v"] = ((heads, H // heads), "pos_bias")
    return specs


def sinusoids(frames: int, width: int, device) -> torch.Tensor:
    """HF's table for ``frames`` (2·frames − 1, width), float32: the rows of
    positions frames − 1 … 0 (flipped), then −1 … −(frames − 1)."""
    position = torch.arange(frames, dtype=torch.int64, device=device).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, width, 2, dtype=torch.int64, device=device).float()
                         * -(math.log(10000.0) / width))
    pe_positive = torch.zeros(frames, width, device=device)
    pe_negative = torch.zeros(frames, width, device=device)
    pe_positive[:, 0::2] = torch.sin(position * div_term)
    pe_positive[:, 1::2] = torch.cos(position * div_term)
    pe_negative[:, 0::2] = torch.sin(-1 * position * div_term)
    pe_negative[:, 1::2] = torch.cos(-1 * position * div_term)
    return torch.cat([torch.flip(pe_positive, [0]), pe_negative[1:]])


def rel_shift(scores_bd: torch.Tensor) -> torch.Tensor:
    """HF's shift of (B, h, T, 2T − 1) scores to (B, h, T, T), line for line."""
    zero_pad = torch.zeros((*scores_bd.size()[:3], 1), device=scores_bd.device,
                           dtype=scores_bd.dtype)
    scores_bd_padded = torch.cat([zero_pad, scores_bd], dim=-1)
    scores_bd_padded_shape = scores_bd.size()[:2] + (scores_bd.shape[3] + 1, scores_bd.shape[2])
    scores_bd_padded = scores_bd_padded.view(*scores_bd_padded_shape)
    scores_bd = scores_bd_padded[:, :, 1:].view_as(scores_bd)
    return scores_bd[:, :, :, : scores_bd.size(-1) // 2 + 1]


def _attention(x, params, pre, heads, pe, prec: Precision):
    B, T, H = x.shape
    d = H // heads
    q = _linear(x, params, f"{pre}.linear_q", prec).view(B, T, heads, d)
    k = _linear(x, params, f"{pre}.linear_k", prec).view(B, T, heads, d).transpose(1, 2)
    v = _linear(x, params, f"{pre}.linear_v", prec).view(B, T, heads, d).transpose(1, 2)
    pos = prec.product(F.linear(prec.operand(pe), prec.operand(params[f"{pre}.linear_pos.weight"])))
    pos = pos.view(2 * T - 1, heads, d).transpose(0, 1)  # (heads, 2T − 1, d)
    qu = (q + params[f"{pre}.pos_bias_u"]).transpose(1, 2)
    qv = (q + params[f"{pre}.pos_bias_v"]).transpose(1, 2)
    qu, qv, k, v, pos = (prec.operand(t) for t in (qu, qv, k, v, pos))
    out = []
    for h0 in range(0, heads, HEADS_AT_ONCE):
        hs = slice(h0, h0 + HEADS_AT_ONCE)
        ac = prec.product(qu[:, hs] @ k[:, hs].transpose(-1, -2))
        bd = rel_shift(prec.product(qv[:, hs] @ pos[hs].transpose(-1, -2)))
        probs = torch.softmax((ac + bd) / math.sqrt(d), dim=-1)
        out.append(prec.product(prec.operand(probs) @ v[:, hs]))
    o = torch.cat(out, dim=1).transpose(1, 2).reshape(B, T, H)
    return _linear(o, params, f"{pre}.linear_out", prec)


def forward(params: dict, cfg: dict, audio: torch.Tensor,
            prec: Precision | None = None) -> torch.Tensor:
    """Logits ``(B, frames, vocab)`` of ``audio`` ``(B, T)``, all float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = prec or Precision()
    eps, ln_eps = cfg["layer_norm_eps"], _ROTARY.LN_EPS
    if cfg["do_normalize"]:
        var, mean = torch.var_mean(audio, dim=-1, correction=0, keepdim=True)
        audio = (audio - mean) / torch.sqrt(var + 1e-7)
    x = audio[:, None, :]
    for i, stride in enumerate(cfg["conv_stride"]):
        x = _conv(x, params[f"{FE}.{i}.conv.weight"], params.get(f"{FE}.{i}.conv.bias"),
                  prec, stride=stride)
        if cfg["feat_extract_norm"] == "layer":
            x = _layer_norm(x.transpose(1, 2), params, f"{FE}.{i}.layer_norm",
                            eps).transpose(1, 2)
        elif i == 0:
            x = F.group_norm(x, x.shape[1], params[f"{FE}.0.layer_norm.weight"],
                             params[f"{FE}.0.layer_norm.bias"], eps)
        x = F.gelu(x)
    fp = f"{ROOT}.feature_projection"
    x = _linear(_layer_norm(x.transpose(1, 2), params, f"{fp}.layer_norm", eps), params,
                f"{fp}.projection", prec)
    pe = sinusoids(x.shape[1], cfg["hidden_size"], x.device)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{ENC}.layers.{i}"
        ln = lambda t, name: _layer_norm(t, params, f"{pre}.{name}", ln_eps)
        x = x + 0.5 * _ROTARY._feed_forward(ln(x, "ffn1_layer_norm"), params, f"{pre}.ffn1",
                                            prec)
        x = x + _attention(ln(x, "self_attn_layer_norm"), params, f"{pre}.self_attn",
                           cfg["num_attention_heads"], pe, prec)
        x = x + _ROTARY._conv_module(x, params, f"{pre}.conv_module", cfg, prec)
        x = x + 0.5 * _ROTARY._feed_forward(ln(x, "ffn2_layer_norm"), params, f"{pre}.ffn2",
                                            prec)
        x = ln(x, "final_layer_norm")
    x = _layer_norm(x, params, f"{ENC}.layer_norm", eps)
    return F.linear(x, params["lm_head.weight"], params["lm_head.bias"])
