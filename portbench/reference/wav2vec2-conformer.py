"""A plain Wav2Vec2-Conformer with rotary positions for CTC, in float32, on
HF's parameter names.

It follows the published model (``transformers``' ``Wav2Vec2ConformerForCTC``
with ``position_embeddings_type="rotary"``, in eval mode): the feature
extractor of seven convs (a GroupNorm on layer 0, or a LayerNorm after every
layer) with exact erf GELUs, the feature projection, then Conformer blocks

    x = x + ½·FFN₁(LN(x));  x = x + Attn(LN(x));  x = x + Conv(x);
    x = LN(x + ½·FFN₂(LN(x)))

with SiLU FFNs; attention written out, its input rotated (the rotary table
of HF's ``Wav2Vec2ConformerRotaryPositionalEmbedding``) before the q and k
products and v taken from the unrotated input; the conv module LayerNorm →
pointwise conv to 2H → GLU → depthwise conv → BatchNorm on its running
statistics → SiLU → pointwise conv; one LayerNorm after the stack and the
CTC head. The positional conv the published model builds is never called
there, and has no parameters here. With ``do_normalize`` each row of audio
is brought to zero mean and unit variance first, as the model's feature
extractor does before the forward.

Precision as ``reference/wav2vec2.py`` sets it (its ``Precision``, whose
fp8 control rounds the operands of every convolution and matrix product,
the depthwise conv and attention's two included); its ``ctc_losses``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.wav2vec2 import Precision, _conv, _layer_norm, _linear, ctc_losses

__all__ = ["KINDS", "Precision", "ctc_losses", "forward", "param_specs"]

ROOT = "wav2vec2_conformer"
FE = f"{ROOT}.feature_extractor.conv_layers"
ENC = f"{ROOT}.encoder"
BN_EPS = 1e-5  # nn.BatchNorm1d's default, as the published module builds it
LN_EPS = 1e-5  # the block's LayerNorms take nn.LayerNorm's default eps

# weight kinds that portbench/inputs.py does not draw: the BatchNorm's
# running statistics, and the last product of each of a block's four
# branches scaled by 1/sqrt(4·layers), which keeps the random encoder's
# frames apart (inputs.weights, on rank collapse)
KINDS = {
    "bn_running_mean": lambda x, shape, cfg: x * 0.1,
    "bn_running_var": lambda x, shape, cfg: 1.0 + 0.1 * x.abs(),
    "bn_count": lambda x, shape, cfg: torch.zeros(shape, dtype=torch.long, device=x.device),
    "conformer_branch_out": lambda x, shape, cfg: (
        x * (math.prod(shape[1:]) * 4 * cfg["num_hidden_layers"]) ** -0.5).to(torch.bfloat16),
}


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, kind)}`` of every parameter and BatchNorm buffer:
    the kinds of ``inputs.KINDS`` and :data:`KINDS`."""
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    K = cfg["conv_depthwise_kernel_size"]
    specs = {}
    norm = lambda name, n: specs.update({f"{name}.weight": ((n,), "norm_weight"),
                                         f"{name}.bias": ((n,), "norm_bias")})
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        specs[f"{FE}.{i}.conv.weight"] = ((c, c_in, k), "matmul")
        if cfg["conv_bias"]:
            specs[f"{FE}.{i}.conv.bias"] = ((c,), "bias")
        if cfg["feat_extract_norm"] == "layer" or i == 0:
            norm(f"{FE}.{i}.layer_norm", c)
        c_in = c
    fp = f"{ROOT}.feature_projection"
    norm(f"{fp}.layer_norm", c_in)
    specs[f"{fp}.projection.weight"] = ((H, c_in), "matmul")
    specs[f"{fp}.projection.bias"] = ((H,), "bias")
    norm(f"{ENC}.layer_norm", H)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{ENC}.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            norm(f"{pre}.{ffn}_layer_norm", H)
            specs[f"{pre}.{ffn}.intermediate_dense.weight"] = ((I, H), "matmul")
            specs[f"{pre}.{ffn}.intermediate_dense.bias"] = ((I,), "bias")
            specs[f"{pre}.{ffn}.output_dense.weight"] = ((H, I), "conformer_branch_out")
            specs[f"{pre}.{ffn}.output_dense.bias"] = ((H,), "bias")
        norm(f"{pre}.self_attn_layer_norm", H)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            kind = "conformer_branch_out" if proj == "linear_out" else "matmul"
            specs[f"{pre}.self_attn.{proj}.weight"] = ((H, H), kind)
            specs[f"{pre}.self_attn.{proj}.bias"] = ((H,), "bias")
        cm = f"{pre}.conv_module"
        norm(f"{cm}.layer_norm", H)
        specs[f"{cm}.pointwise_conv1.weight"] = ((2 * H, H, 1), "matmul")
        specs[f"{cm}.depthwise_conv.weight"] = ((H, 1, K), "matmul")
        norm(f"{cm}.batch_norm", H)
        specs[f"{cm}.batch_norm.running_mean"] = ((H,), "bn_running_mean")
        specs[f"{cm}.batch_norm.running_var"] = ((H,), "bn_running_var")
        specs[f"{cm}.batch_norm.num_batches_tracked"] = ((), "bn_count")
        specs[f"{cm}.pointwise_conv2.weight"] = ((H, H, 1), "conformer_branch_out")
        norm(f"{pre}.final_layer_norm", H)
    specs["lm_head.weight"] = ((V, H), "head")
    specs["lm_head.bias"] = ((V,), "bias")
    return specs


def rotary_table(frames: int, head_dim: int, base: float, device) -> tuple:
    """``(cos, sin)`` (frames, head_dim) in float32, as HF builds them."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim))
    freqs = torch.outer(torch.arange(frames, device=device).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` (B, heads, T, d) rotated: ``x·cos + [−x₂, x₁]·sin``."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., half:], x[..., :half]), dim=-1) * sin


def _attention(x, params, pre, heads, cos, sin, prec: Precision):
    B, T, H = x.shape
    d = H // heads
    split = lambda t: t.view(B, T, heads, d).transpose(1, 2)
    r = _rotate(split(x), cos, sin).transpose(1, 2).reshape(B, T, H)
    q = split(_linear(r, params, f"{pre}.linear_q", prec) * d ** -0.5)
    k = split(_linear(r, params, f"{pre}.linear_k", prec))
    v = split(_linear(x, params, f"{pre}.linear_v", prec))
    s = prec.product(prec.operand(q) @ prec.operand(k).transpose(-1, -2))
    o = prec.product(prec.operand(torch.softmax(s, dim=-1)) @ prec.operand(v))
    return _linear(o.transpose(1, 2).reshape(B, T, H), params, f"{pre}.linear_out", prec)


def _feed_forward(x, params, pre, prec: Precision):
    h = F.silu(_linear(x, params, f"{pre}.intermediate_dense", prec))
    return _linear(h, params, f"{pre}.output_dense", prec)


def _conv_module(x, params, pre, cfg, prec: Precision):
    H = x.shape[-1]
    K = cfg["conv_depthwise_kernel_size"]
    y = _layer_norm(x, params, f"{pre}.layer_norm", LN_EPS).transpose(1, 2)
    y = F.glu(_conv(y, params[f"{pre}.pointwise_conv1.weight"], None, prec), dim=1)
    y = _conv(y, params[f"{pre}.depthwise_conv.weight"], None, prec, padding=(K - 1) // 2,
              groups=H)
    bn = f"{pre}.batch_norm"
    y = F.batch_norm(y, params[f"{bn}.running_mean"], params[f"{bn}.running_var"],
                     params[f"{bn}.weight"], params[f"{bn}.bias"], training=False, eps=BN_EPS)
    y = _conv(F.silu(y), params[f"{pre}.pointwise_conv2.weight"], None, prec)
    return y.transpose(1, 2)


def forward(params: dict, cfg: dict, audio: torch.Tensor,
            prec: Precision | None = None) -> torch.Tensor:
    """Logits ``(B, frames, vocab)`` of ``audio`` ``(B, T)``, all float32."""
    prec = prec or Precision()
    eps = cfg["layer_norm_eps"]
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
    heads = cfg["num_attention_heads"]
    cos, sin = rotary_table(x.shape[1], cfg["hidden_size"] // heads,
                            cfg["rotary_embedding_base"], x.device)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{ENC}.layers.{i}"
        ln = lambda t, name: _layer_norm(t, params, f"{pre}.{name}", LN_EPS)
        x = x + 0.5 * _feed_forward(ln(x, "ffn1_layer_norm"), params, f"{pre}.ffn1", prec)
        x = x + _attention(ln(x, "self_attn_layer_norm"), params, f"{pre}.self_attn", heads,
                           cos, sin, prec)
        x = x + _conv_module(x, params, f"{pre}.conv_module", cfg, prec)
        x = x + 0.5 * _feed_forward(ln(x, "ffn2_layer_norm"), params, f"{pre}.ffn2", prec)
        x = ln(x, "final_layer_norm")
    x = _layer_norm(x, params, f"{ENC}.layer_norm", eps)
    return F.linear(x, params["lm_head.weight"], params["lm_head.bias"])
