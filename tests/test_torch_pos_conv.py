"""The positional conv's kernel route, K5, on the CPU: ``_PosConv``'s plain
route against the stock ``F.conv1d`` + trim + ``F.gelu`` autograd, the
input gradient as a forward conv with flipped, group-transposed taps against
``torch.nn.grad.conv1d_input``, and the weight layout the kernel reads. The
kernel itself runs only on a GPU (tests/test_torch_pos_conv_gpu.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.ops.kernels import pos_conv

# (B, T, H, Cg, K): the tiny preset's groups (Cg 16, K 16), base-like and
# lv60-like group widths with fewer groups and taps, odd K, T = 1, T < K
GEOMETRIES = [(2, 37, 64, 16, 16), (2, 40, 96, 48, 12), (1, 33, 128, 64, 9),
              (2, 1, 64, 16, 16), (3, 5, 32, 16, 7), (1, 20, 128, 128, 8)]


def _inputs(B, T, H, Cg, K, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((H, Cg, K)) / np.sqrt(Cg * K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(H).astype(np.float32) * 0.1)
    dout = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    return x, w, b, dout


def _stock(x, w, b):
    """Today's layer as nn.Conv1d defines it: padding K // 2, the SamePad
    trim for even K, then F.gelu."""
    K = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w, b, padding=K // 2, groups=x.shape[-1] // w.shape[1])
    if K % 2 == 0:
        y = y[:, :, :-1]
    return F.gelu(y.transpose(1, 2))


@pytest.mark.parametrize("B, T, H, Cg, K", GEOMETRIES)
def test_function_plain_route_matches_stock_autograd(B, T, H, Cg, K):
    x, w, b, dout = _inputs(B, T, H, Cg, K)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = _stock(*leaves)
    want_grads = torch.autograd.grad(want, leaves, dout)
    got_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = pos_conv._PosConv.apply(*got_leaves)
    got_grads = torch.autograd.grad(got, got_leaves, dout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, h in zip(got_grads, want_grads):
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B, T, H, Cg, K", GEOMETRIES)
def test_dgrad_taps_match_conv1d_input(B, T, H, Cg, K):
    """The input gradient as the kernel computes it: a forward conv with the
    flipped, group-transposed taps at offset K − 1 − K // 2, the trimmed
    frame's gradient 0."""
    x, w, _, dpre = _inputs(B, T, H, Cg, K, seed=1)
    dy = F.pad(dpre.transpose(1, 2), (0, 1 - K % 2))
    want = torch.nn.grad.conv1d_input(x.transpose(1, 2).shape, w, dy, padding=K // 2,
                                      groups=H // Cg).transpose(1, 2)
    torch.testing.assert_close(pos_conv.pos_conv_dgrad_plain(dpre, w), want, rtol=1e-5, atol=1e-5)
    # the weight of the input gradient is its own inverse: twice is the weight
    assert torch.equal(pos_conv.dgrad_taps(pos_conv.dgrad_taps(w)), w)


@pytest.mark.parametrize("H, Cg, K", [(64, 16, 16), (768, 48, 128), (1024, 64, 128),
                                      (256, 80, 5), (256, 128, 3)])
def test_pack_taps_layout(H, Cg, K):
    """W[g·Cg + co, ci, k] at element ((g·K + k)·Cg/8 + ci//8)·M·8 + co·8 +
    ci%8 of the packed taps, M = 64·⌈Cg/64⌉, and zero in the padding rows:
    the layout csrc/pos_conv.cu reads."""
    if H % Cg:
        H = Cg * 2
    w = torch.arange(H * Cg * K, dtype=torch.float32).reshape(H, Cg, K) + 1
    packed = pos_conv.pack_taps(w)
    G, M = H // Cg, 64 * ((Cg + 63) // 64)
    assert packed.shape == (G, K, Cg // 8, M, 8) and packed.is_contiguous()
    flat = packed.reshape(-1)
    g, co, ci, k = np.meshgrid(np.arange(G), np.arange(Cg), np.arange(Cg), np.arange(K),
                               indexing="ij")
    idx = ((g * K + k) * (Cg // 8) + ci // 8) * M * 8 + co * 8 + ci % 8
    assert torch.equal(flat[torch.from_numpy(idx.ravel())],
                       w.reshape(G, Cg, Cg, K)[g.ravel(), co.ravel(), ci.ravel(), k.ravel()])
    assert int((flat != 0).sum()) == w.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_module_runs_the_stock_path(dtype):
    """On a CPU tensor the model's layer is the stock path, in float32 and
    bf16 alike, bit for bit."""
    cfg = wav2vec2.get_config("wav2vec2-tiny")
    layer = wav2vec2.PositionalConvEmbedding(cfg)
    x, *_ = _inputs(2, 25, cfg.hidden_size, 16, 16, seed=2)
    x = x.to(dtype)
    c = layer.conv
    want = _stock(x, c.weight.to(dtype), c.bias.to(dtype))
    assert torch.equal(layer(x), want)


def test_kernel_wrapper_refuses_shapes_it_does_not_take():
    """Shapes outside the kernel's reach raise before anything launches
    (the check runs on any device)."""
    x = torch.zeros((1, 4, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16·n"):
        pos_conv._check("pos_conv_fwd", x, torch.zeros((96, 24, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="taps"):
        pos_conv._check("pos_conv_fwd", x, torch.zeros((96, 32, 129), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        pos_conv._check("pos_conv_fwd", x.float(), torch.zeros((96, 32, 8)))
    with pytest.raises(ValueError, match="does not fit"):
        pos_conv._check("pos_conv_fwd", x, torch.zeros((64, 32, 8), dtype=torch.bfloat16))
    assert pos_conv._check("pos_conv_fwd", x, torch.zeros((96, 32, 8), dtype=torch.bfloat16)) \
        == (1, 4, 96, 32, 8)
