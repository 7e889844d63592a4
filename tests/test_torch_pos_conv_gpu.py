"""The positional conv kernel K5 against its plain version on a GPU: the
forward's ``pre`` and ``gelu(pre)`` and the input gradient at base's and the
lv60 microbatch's shapes, the tiny preset's groups in bf16, ragged lengths
and the two-tile route (groups of more than 64 channels); the same bits on
a repeat; one launch of each direction a microbatch and no cuDNN conv on
the bf16 path; the weight gradient of pretraining. Every test needs a CUDA
device and skips without one (the kernel has no CPU mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_pos_conv_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.ops.kernels import _lib, pos_conv

# max |kernel − plain| / max(max |plain|, 0.1), as K1/K2's: outputs are
# stored in bf16 (relative step 2^-8)
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / max(b.abs().max(), 0.1))


def _inputs(B, T, H, Cg, K, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, T, H), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((H, Cg, K), generator=g, device=dev) / (Cg * K) ** 0.5).to(torch.bfloat16)
    b = (torch.randn(H, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    dpre = torch.randn((B, T, H), generator=g, device=dev).to(torch.bfloat16)
    return x, w, b, dpre


@pytest.mark.parametrize("B, T, H, Cg, K", [
    (64, 499, 768, 48, 128),   # base's batch
    (32, 999, 1024, 64, 128),  # an lv60 microbatch
    (32, 152, 64, 16, 16),     # the tiny preset's groups, the bf16 anchor's shape
    (4, 1, 768, 48, 128), (4, 130, 768, 48, 128), (4, 774, 1024, 64, 128),  # ragged T
    (2, 300, 256, 128, 128), (2, 77, 160, 80, 33),  # two 64-row tiles of channels
    (3, 50, 64, 32, 7),        # odd K
])
def test_pos_conv_kernel_matches_plain(cuda, B, T, H, Cg, K):
    x, w, b, dpre = _inputs(B, T, H, Cg, K, cuda, seed=T + Cg)
    _lib.reset_launches()
    pre, out = pos_conv.pos_conv_fwd(x, w, b)
    dx = pos_conv.pos_conv_dgrad(dpre, w)
    assert _lib.launches["pos_conv"] == 1 and _lib.launches["pos_conv_dgrad"] == 1
    pre_ref, out_ref = pos_conv.pos_conv_fwd_plain(x, w, b)
    assert _rel(pre, pre_ref) <= TOL
    assert _rel(out, out_ref) <= TOL
    assert _rel(dx, pos_conv.pos_conv_dgrad_plain(dpre, w)) <= TOL
    # deterministic: the same inputs give the same bits
    again = pos_conv.pos_conv_fwd(x, w, b)
    assert torch.equal(again[0], pre) and torch.equal(again[1], out)
    assert torch.equal(pos_conv.pos_conv_dgrad(dpre, w), dx)


def _layer(preset, dev, dtype):
    from paa_tpu_torch.models import wav2vec2

    layer = wav2vec2.PositionalConvEmbedding(wav2vec2.get_config(preset)).to(dev)
    with torch.no_grad():  # gains away from 1, so that every tap counts
        layer.conv.parametrizations.weight.original0.uniform_(0.5, 1.5)
    return layer.requires_grad_(False), dtype


@pytest.mark.parametrize("preset, B, T", [("wav2vec2-base", 8, 499),
                                          ("wav2vec2-large-lv60", 4, 999),
                                          ("wav2vec2-tiny", 8, 152)])
def test_bf16_layer_runs_only_the_kernel(cuda, preset, B, T):
    """The model's layer in bf16 with frozen weights, as in an attack step:
    one launch of each direction, no cuDNN conv (no aten convolution op),
    and the output and ∂x as the stock path's in float32 on the same bf16
    values. (The stock path in bf16 rounds pre, dpre and its own sums at
    other places, so the two bf16 paths lie further apart than either
    from float32.)"""
    layer, dt = _layer(preset, cuda, torch.bfloat16)
    H = layer.conv.in_channels
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, T, H), generator=g, device=cuda).to(dt).requires_grad_(True)
    dout = torch.randn((B, T, H), generator=g, device=cuda).to(dt)
    _lib.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y = layer(x)
        (dx,) = torch.autograd.grad(y, x, dout)
    assert _lib.launches["pos_conv"] == 1 and _lib.launches["pos_conv_dgrad"] == 1
    convs = [e.key for e in prof.key_averages() if "conv" in e.key and "aten::" in e.key]
    assert convs == [], convs
    c = layer.conv
    xr = x.detach().float().requires_grad_(True)
    want = pos_conv.pos_conv_fwd_plain(xr, c.weight.to(dt).float(), c.bias.to(dt).float())[1]
    (dx_ref,) = torch.autograd.grad(want, xr, dout.float())
    assert _rel(y, want) <= TOL
    assert _rel(dx, dx_ref) <= TOL


def test_float32_layer_keeps_the_library_conv(cuda):
    """float32 on the card (tiny's preset) is the stock F.conv1d path: no
    launch of K5."""
    layer, dt = _layer("wav2vec2-tiny", cuda, torch.float32)
    x = torch.randn((2, 40, 64), device=cuda, requires_grad=True)
    _lib.reset_launches()
    layer(x).sum().backward()
    assert _lib.launches["pos_conv"] == _lib.launches["pos_conv_dgrad"] == 0
    assert x.grad is not None


def test_weight_and_bias_gradients_in_pretraining(cuda):
    """Weights that need a gradient (pretraining): ∂w and ∂b through the
    library's conv1d_weight and a sum, ∂x through K5, each as the stock
    path's in float32 on the same bf16 values."""
    x, w, b, dout = _inputs(8, 499, 768, 48, 128, cuda, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    _lib.reset_launches()
    got = torch.autograd.grad(pos_conv.positional_conv(*leaves), leaves, dout)
    assert _lib.launches["pos_conv"] == 1 and _lib.launches["pos_conv_dgrad"] == 1
    ref = [t.float().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(pos_conv.pos_conv_fwd_plain(*ref)[1], ref, dout.float())
    for a, c in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert _rel(a, c) <= TOL


def test_bf16_accumulated_step_launches_k5_once_a_microbatch(cuda):
    """The tiny preset in bf16 with two microbatches: the train step launches
    each direction of K5 once a microbatch, beside K1/K2's register route,
    K3 and K7."""
    from paa_tpu_torch.attack import step
    from paa_tpu_torch.config import AttackConfig, ConstraintParams
    from paa_tpu_torch.models import wav2vec2
    from paa_tpu_torch.ops import psycho, text

    mcfg = wav2vec2.get_config("wav2vec2-tiny", compute_dtype="bfloat16")
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", accum_steps=2)
    g = torch.Generator().manual_seed(0)
    audio = (torch.randn((4, 16000), generator=g) * 0.1).to(cuda)
    p = (torch.randn((1, 16000), generator=g) * 1e-3).to(cuda)
    labels, pads = (torch.from_numpy(a).to(cuda) for a in
                    text.encode_batch(["hello world", "delete", "test tone", "open close"]))
    model = wav2vec2.init_model(mcfg, seed=1).to(cuda)
    train = step.make_train_step(cfg, model, psycho.build_tables(cfg, cuda))
    _lib.reset_launches()
    new_p, _, m = train(p, None, audio, labels, pads, torch.ones(4, device=cuda),
                        ConstraintParams.create(device=cuda), cfg.lr)
    L = mcfg.num_hidden_layers
    ln = 2 * (2 * L + 2)  # K7: two a post-LN layer, the one before the stack, the projection's
    assert _lib.launches == {"attention_fwd": 2 * L, "attention_bwd": 2 * L,
                             "attention_fwd_sm90": 0, "attention_bwd_sm90": 0, "fm_norm": 1,
                             "pos_conv": 2, "pos_conv_dgrad": 2, "fe_norm": 0, "fe_norm_bwd": 0,
                             "layer_norm": ln, "layer_norm_bwd": ln}
    assert bool(torch.isfinite(new_p).all()) and bool(torch.isfinite(m.ctc_loss))
