"""The feature extractor's bias + LayerNorm + GELU route (K6,
``ops/kernels/fe_norm.py``) on the CPU: the plain version against the stock
``F.layer_norm`` on the transposed view and ``F.gelu`` in float64, in values
and in the gradients of the input, the conv bias, γ and β, with the tanh and
the erf GELU, odd T and T = 1, in both layouts; the CPU route, which is the
plain version and launches nothing; the lv60 conv layer's numbers as the
composition it ran before K6; feature-extractor remat at equal bits. The
kernel itself runs only on a GPU (tests/test_torch_fe_norm_gpu.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.ops.kernels import _lib, fe_norm

EPS = 1e-5
# (B, C, T): odd T, as at every lv60 layer; T = 1; C other than 512
SHAPES = [(2, 24, 50), (3, 16, 37), (2, 40, 1)]


def _inputs(B, C, T, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    y = f(B, C, T) * 2 + 0.5
    bias, weight, bias_ln = f(C) * 0.3, 1 + f(C) * 0.2, f(C) * 0.2
    return y, bias, weight, bias_ln, f(B, C, T)


def _stock(y, bias, weight, bias_ln, tanh):
    """The layer as torch's own LayerNorm defines it, on (B, T, C)."""
    x = (y + bias[:, None]).transpose(1, 2)
    z = F.layer_norm(x, (y.shape[1],), weight, bias_ln, EPS).transpose(1, 2)
    return F.gelu(z, approximate="tanh" if tanh else "none")


def _value_and_grads(fn, tensors, ct):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, ct.to(out.dtype))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("B, C, T", SHAPES)
def test_plain_matches_stock_layer_norm(B, C, T, tanh, dim):
    """float32 through the plain version, against float64 through stock
    LayerNorm: within 1e-5 of each quantity's largest value (float32
    statistics and sums over 16–40 channels)."""
    y, bias, weight, bias_ln, ct = _inputs(B, C, T, seed=C + T)
    want, want_g = _value_and_grads(lambda *a: _stock(*a, tanh),
                                    [t.double() for t in (y, bias, weight, bias_ln)], ct)
    if dim == 1:
        plain = lambda y_, *p: fe_norm.fe_norm_gelu(y_, *p, EPS, tanh, dim)
    else:  # the (B, T, C) layout of the non-default conv lowerings
        plain = lambda y_, *p: fe_norm.fe_norm_gelu(
            y_.transpose(1, 2), *p, EPS, tanh, dim).transpose(1, 2)
    got, got_g = _value_and_grads(plain, (y, bias, weight, bias_ln), ct)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    for name, g, h in zip(("y", "bias", "weight", "bias_ln"), got_g, want_g):
        assert _rel(g, h) <= 1e-5, name


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_plain_version(dtype, grad):
    """On a CPU tensor, float32 or bf16, with grad or without: the plain
    version's bits, and no launch of K6."""
    y, bias, weight, bias_ln, ct = _inputs(2, 16, 33, seed=4)
    y = y.to(dtype).requires_grad_(grad)
    _lib.reset_launches()
    got = fe_norm.fe_norm_gelu(y, bias, weight, bias_ln, EPS, True)
    if grad:
        got.backward(ct.to(dtype))
    assert _lib.launches["fe_norm"] == _lib.launches["fe_norm_bwd"] == 0
    want = fe_norm.fe_norm_gelu_plain(y.detach(), bias, weight, bias_ln, EPS, True)
    assert got.dtype == dtype and torch.equal(got.detach(), want)


def test_plain_without_conv_bias():
    """A LayerNorm layer whose conv has no bias: the same as a zero bias."""
    y, _, weight, bias_ln, _ = _inputs(2, 16, 9, seed=6)
    got = fe_norm.fe_norm_gelu(y, None, weight, bias_ln, EPS, False)
    want = fe_norm.fe_norm_gelu(y, torch.zeros(16), weight, bias_ln, EPS, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lv60_conv_layer_keeps_its_numbers(dtype):
    """The lv60 conv layer off the card: the conv, the bias added in the
    compute dtype, ``_FeNorm`` and ``F.gelu`` (the GELU the config's
    ``fe_gelu="auto"`` names for the dtype), bit for bit, in values and in
    ∂x and the parameters' gradients."""
    cfg = wav2vec2.get_config("wav2vec2-large-lv60", conv_dim=(16, 16), conv_kernel=(10, 3),
                              conv_stride=(5, 2))
    layer = wav2vec2.ConvLayer(cfg, 1)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    x0 = torch.randn((2, 16, 41), generator=torch.Generator().manual_seed(1)).to(dtype)
    ct = torch.randn((2, 16, 20), generator=torch.Generator().manual_seed(2)).to(dtype)
    params = list(layer.parameters())

    def before(x):
        y = F.conv1d(x, layer.conv.weight.to(dtype), None, layer.stride)
        y = y + layer.conv.bias.to(dtype)[:, None]
        n = layer.layer_norm
        y = fe_norm._FeNorm.apply(y, n.weight, n.bias, n.eps, 1)
        return F.gelu(y, approximate="tanh" if dtype == torch.bfloat16 else "none")

    outs = []
    for fn in (layer, before):
        x = x0.clone().requires_grad_(True)
        out = fn(x)
        outs.append((out, *torch.autograd.grad(out, [x, *params], ct)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["conv", "im2col"])
@pytest.mark.parametrize("layer_id", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_base_conv_layer_keeps_its_numbers(dtype, layer_id, impl):
    """base's conv layers, which never reach K6 (layer 0's GroupNorm, layer
    1 with no norm), in both layouts: the conv, the bias added in the
    compute dtype, GroupNorm over the float32 (B, C, T) view and ``F.gelu``,
    as written out here, bit for bit, in values and in ∂x and the
    parameters' gradients."""
    cfg = wav2vec2.get_config("wav2vec2-base", conv_dim=(16, 16), conv_kernel=(10, 3),
                              conv_stride=(5, 2), conv_bias=True, conv_impl=impl)
    layer = wav2vec2.ConvLayer(cfg, layer_id)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    c_in = 1 if layer_id == 0 else 16
    shape = (2, c_in, 81) if impl == "conv" else (2, 81, c_in)
    x0 = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    params = list(layer.parameters())

    def before(x):
        y = wav2vec2.feature_conv(impl, x, layer.conv.weight.to(dtype), layer.stride)
        c = 1 if impl == "conv" else 2
        b = layer.conv.bias.to(dtype)
        y = y + (b[:, None] if c == 1 else b)
        n = layer.layer_norm
        if n is not None:
            yt = y.float() if c == 1 else y.transpose(1, 2).to(
                torch.float32, memory_format=torch.contiguous_format)
            y = F.group_norm(yt, n.num_groups, n.weight, n.bias, n.eps).to(dtype)
            if c == 2:
                y = y.transpose(1, 2).contiguous()
        return F.gelu(y, approximate="tanh" if dtype == torch.bfloat16 else "none")

    outs = []
    for fn in (layer, before):
        x = x0.clone().requires_grad_(True)
        out = fn(x)
        ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
        outs.append((out, *torch.autograd.grad(out, [x, *params], ct)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("save_layers", [0, 2])
def test_lv60_feature_extractor_remat_is_bit_equal(save_layers):
    """lv60's feature extractor (float32, CPU) under ``remat_feature_extractor``
    against it without: equal outputs and equal gradients of the audio and
    of every parameter."""
    fes = [wav2vec2.FeatureExtractor(wav2vec2.get_config("wav2vec2-large-lv60", **over))
           for over in ({}, dict(remat_feature_extractor=True, remat_fe_save_layers=save_layers))]
    fes[1].load_state_dict(fes[0].state_dict())
    g = torch.Generator().manual_seed(3)
    audio = torch.randn((2, 2400), generator=g) * 0.1
    ct = torch.randn((2, 7, 512), generator=g)
    results = []
    for fe in fes:
        a = audio.clone().requires_grad_(True)
        out = fe(a)
        results.append((out, *torch.autograd.grad(out, [a, *fe.parameters()], ct)))
    for got, want in zip(*results):
        assert torch.equal(got, want)
