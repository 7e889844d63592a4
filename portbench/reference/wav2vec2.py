"""A plain wav2vec2 for CTC, in float32, on HF's parameter names.

It follows the published model (``transformers``' ``Wav2Vec2ForCTC`` in
eval mode): seven feature-extractor convs (a GroupNorm on layer 0, or a
LayerNorm after every layer), exact erf GELUs, the feature projection, the
weight-normed grouped positional conv with the trim of one frame for an
even kernel, post-LN or pre-LN ("stable layer norm") encoder layers with a
softmax attention written out, and the CTC head. With ``do_normalize`` each
row of audio is brought to zero mean and unit variance first, as the
model's feature extractor does before the forward.

``Precision("float32")`` computes every product in float32; the caller
turns TF32 off. ``Precision("fp8")`` is the control: every convolution and
matrix product, the attention's two included, reads its operands rounded to
float8 e4m3 with one scale a tensor, and its backward reads the incoming
gradient rounded to float8 e5m2 the same way; the sums stay in float32 and
the head, the norms and the softmax stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FE = "wav2vec2.feature_extractor.conv_layers"
ENC = "wav2vec2.encoder"
POS = f"{ENC}.pos_conv_embed.conv"


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, kind)}`` of every parameter. ``kind``: ``matmul``
    (a convolution's or matrix product's weight, served in bfloat16),
    ``branch_out`` (the same for the last product of an encoder layer's
    attention or FFN branch), ``head``, ``bias``, ``norm_weight``,
    ``norm_bias``, ``pos_gain`` and ``pos_direction`` (served in float32)."""
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    specs = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        specs[f"{FE}.{i}.conv.weight"] = ((c, c_in, k), "matmul")
        if cfg["conv_bias"]:
            specs[f"{FE}.{i}.conv.bias"] = ((c,), "bias")
        if cfg["feat_extract_norm"] == "layer" or i == 0:
            specs[f"{FE}.{i}.layer_norm.weight"] = ((c,), "norm_weight")
            specs[f"{FE}.{i}.layer_norm.bias"] = ((c,), "norm_bias")
        c_in = c
    fp = "wav2vec2.feature_projection"
    specs[f"{fp}.layer_norm.weight"] = ((c_in,), "norm_weight")
    specs[f"{fp}.layer_norm.bias"] = ((c_in,), "norm_bias")
    specs[f"{fp}.projection.weight"] = ((H, c_in), "matmul")
    specs[f"{fp}.projection.bias"] = ((H,), "bias")
    K, G = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    specs[f"{POS}.bias"] = ((H,), "bias")
    specs[f"{POS}.parametrizations.weight.original0"] = ((1, 1, K), "pos_gain")
    specs[f"{POS}.parametrizations.weight.original1"] = ((H, H // G, K), "pos_direction")
    specs[f"{ENC}.layer_norm.weight"] = ((H,), "norm_weight")
    specs[f"{ENC}.layer_norm.bias"] = ((H,), "norm_bias")
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{ENC}.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            kind = "branch_out" if proj == "out_proj" else "matmul"
            specs[f"{pre}.attention.{proj}.weight"] = ((H, H), kind)
            specs[f"{pre}.attention.{proj}.bias"] = ((H,), "bias")
        for norm in ("layer_norm", "final_layer_norm"):
            specs[f"{pre}.{norm}.weight"] = ((H,), "norm_weight")
            specs[f"{pre}.{norm}.bias"] = ((H,), "norm_bias")
        specs[f"{pre}.feed_forward.intermediate_dense.weight"] = ((I, H), "matmul")
        specs[f"{pre}.feed_forward.intermediate_dense.bias"] = ((I,), "bias")
        specs[f"{pre}.feed_forward.output_dense.weight"] = ((H, I), "branch_out")
        specs[f"{pre}.feed_forward.output_dense.bias"] = ((H,), "bias")
    specs["lm_head.weight"] = ((V, H), "head")
    specs["lm_head.bias"] = ((V,), "bias")
    return specs


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor, as float32."""
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Operand(torch.autograd.Function):
    """Forward: the operand in e4m3; backward: the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """Forward: the product as it is; backward: its gradient in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """How products read their operands: ``float32`` or ``fp8`` (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.fp8 = name == "fp8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x) if self.fp8 else x

    def product(self, y: torch.Tensor) -> torch.Tensor:
        return _Product.apply(y) if self.fp8 else y


def _linear(x, params, name, prec: Precision):
    y = prec.product(F.linear(prec.operand(x), prec.operand(params[name + ".weight"])))
    return y + params[name + ".bias"]


def _conv(x, w, bias, prec: Precision, **kw):
    return prec.product(F.conv1d(prec.operand(x), prec.operand(w), None, **kw)) + (
        0.0 if bias is None else bias[:, None])


def _layer_norm(x, params, name, eps):
    return F.layer_norm(x, x.shape[-1:], params[name + ".weight"], params[name + ".bias"], eps)


def _attention(x, params, pre, heads, prec: Precision):
    B, T, H = x.shape
    d = H // heads
    split = lambda t: t.view(B, T, heads, d).transpose(1, 2)
    q = split(_linear(x, params, f"{pre}.q_proj", prec) * d ** -0.5)
    k = split(_linear(x, params, f"{pre}.k_proj", prec))
    v = split(_linear(x, params, f"{pre}.v_proj", prec))
    s = prec.product(prec.operand(q) @ prec.operand(k).transpose(-1, -2))
    o = prec.product(prec.operand(torch.softmax(s, dim=-1)) @ prec.operand(v))
    return _linear(o.transpose(1, 2).reshape(B, T, H), params, f"{pre}.out_proj", prec)


def _feed_forward(x, params, pre, prec: Precision):
    h = F.gelu(_linear(x, params, f"{pre}.intermediate_dense", prec))
    return _linear(h, params, f"{pre}.output_dense", prec)


def pos_conv_weight(params) -> torch.Tensor:
    """``g · v / ‖v‖`` with one gain and one norm per kernel tap."""
    g = params[f"{POS}.parametrizations.weight.original0"]
    v = params[f"{POS}.parametrizations.weight.original1"]
    return g * v / v.norm(dim=(0, 1), keepdim=True)


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
    x = x.transpose(1, 2)
    fp = "wav2vec2.feature_projection"
    x = _linear(_layer_norm(x, params, f"{fp}.layer_norm", eps), params, f"{fp}.projection",
                prec)
    K = cfg["num_conv_pos_embeddings"]
    pos = _conv(x.transpose(1, 2), pos_conv_weight(params), params[f"{POS}.bias"], prec,
                padding=K // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    stable = cfg["do_stable_layer_norm"]
    if not stable:
        x = _layer_norm(x, params, f"{ENC}.layer_norm", eps)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{ENC}.layers.{i}"
        if stable:
            x = x + _attention(_layer_norm(x, params, f"{pre}.layer_norm", eps), params,
                               f"{pre}.attention", cfg["num_attention_heads"], prec)
            x = x + _feed_forward(_layer_norm(x, params, f"{pre}.final_layer_norm", eps),
                                  params, f"{pre}.feed_forward", prec)
        else:
            x = _layer_norm(x + _attention(x, params, f"{pre}.attention",
                                           cfg["num_attention_heads"], prec),
                            params, f"{pre}.layer_norm", eps)
            x = _layer_norm(x + _feed_forward(x, params, f"{pre}.feed_forward", prec), params,
                            f"{pre}.final_layer_norm", eps)
    if stable:
        x = _layer_norm(x, params, f"{ENC}.layer_norm", eps)
    return F.linear(x, params["lm_head.weight"], params["lm_head.bias"])


def ctc_losses(logits: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row CTC negative log likelihood, blank 0, over every frame."""
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    B, T = logits.shape[:2]
    return F.ctc_loss(logp, labels.long(), torch.full((B,), T, dtype=torch.long),
                      lengths.long(), blank=0, reduction="none", zero_infinity=False)
