"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions on a
GPU (K1/K2 on both routes, wgmma for bf16 with head dim 64 and the register
route otherwise, also at the long-clip lengths where the JAX package runs
its flash kernel, K4), K2's determinism, and the step's launch counts. Every
test needs a CUDA device and skips without one (the kernels have no CPU
mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import psycho
from paa_tpu_torch.ops.kernels import _lib, attention, fm_norm

# max |kernel − plain| / max(max |plain|, 0.1): bf16 outputs are stored in
# bf16 (relative step 2^-8); at T=1, dq = dk = 0 exactly
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    return float((a - b).float().abs().max() / max(b.float().abs().max(), 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, heads, d", [(1, 12, 64), (130, 12, 64), (499, 12, 64),
                                         (640, 12, 64), (1, 4, 16), (130, 4, 16),
                                         (152, 4, 16), (499, 4, 16), (499, 16, 64),
                                         # the JAX package's flash-kernel lengths (K4):
                                         # 15.5 s, 20 s and 30 s, ragged last tiles
                                         (774, 16, 64), (999, 16, 64), (1499, 16, 64)])
def test_attention_kernels_match_plain(cuda, dtype, T, heads, d):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v, do = ((torch.randn((2, T, heads * d), generator=g, device=cuda) * 0.5).to(dtype)
                   for _ in range(4))
    o, lse = attention.attention_fwd(q, k, v, heads)
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, heads)
    assert _rel(o, o_ref) <= TOL[dtype]
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    got = attention.attention_bwd(q, k, v, o, lse, do, heads)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, heads)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= TOL[dtype]
    # deterministic: the same inputs give the same bits
    again = attention.attention_bwd(q, k, v, o, lse, do, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B, T, heads", [(64, 499, 12), (32, 999, 16)])
def test_attention_wgmma_route_at_the_main_shapes(cuda, B, T, heads):
    """bf16, head dim 64 at base's and the lv60 microbatch's shapes: the
    wgmma kernels launch, match the plain versions and repeat bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v, do = ((torch.randn((B, T, heads * 64), generator=g, device=cuda) * 0.5)
                   .to(torch.bfloat16) for _ in range(4))
    _lib.reset_launches()
    o, lse = attention.attention_fwd(q, k, v, heads)
    got = attention.attention_bwd(q, k, v, o, lse, do, heads)
    again = attention.attention_bwd(q, k, v, o, lse, do, heads)
    assert _lib.launches["attention_fwd_sm90"] == 1 and _lib.launches["attention_bwd_sm90"] == 2
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, heads)
    assert _rel(o, o_ref) <= TOL[torch.bfloat16]
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, heads)
    for a, b, c in zip(got, want, again):
        assert _rel(a, b) <= TOL[torch.bfloat16]
        assert torch.equal(a, c)


@pytest.mark.parametrize("B, T, heads, d, dtype", [
    (32, 152, 4, 16, torch.float32),   # the tiny recipe's pretraining batch
    (32, 152, 4, 16, torch.bfloat16),  # the tiny anchor
    (16, 152, 4, 16, torch.bfloat16),  # its dp=2 rank
    (32, 152, 2, 16, torch.bfloat16),  # its tp=2 rank
    (64, 499, 12, 64, torch.float32),  # base under --compute_dtype float32
])
def test_attention_register_route_at_the_main_shapes(cuda, B, T, heads, d, dtype):
    """The register route (float32, and bf16 with head dim 16) at the shapes
    the main paths give it: one launch a wrapper call, the plain versions'
    results, and K2's bits equal over two calls."""
    g = torch.Generator(device=cuda).manual_seed(T + heads)
    q, k, v, do = ((torch.randn((B, T, heads * d), generator=g, device=cuda) * 0.5).to(dtype)
                   for _ in range(4))
    _lib.reset_launches()
    o, lse = attention.attention_fwd(q, k, v, heads)
    got = attention.attention_bwd(q, k, v, o, lse, do, heads)
    again = attention.attention_bwd(q, k, v, o, lse, do, heads)
    assert _lib.launches["attention_fwd"] == 1 and _lib.launches["attention_bwd"] == 2
    assert _lib.launches["attention_fwd_sm90"] == _lib.launches["attention_bwd_sm90"] == 0
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, heads)
    assert _rel(o, o_ref) <= TOL[dtype]
    assert float((lse - lse_ref).abs().max()) <= (1e-4 if dtype == torch.float32 else 1e-3)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, heads)
    for a, b, c in zip(got, want, again):
        assert _rel(a, b) <= TOL[dtype]
        assert torch.equal(a, c)


def test_attention_function_runs_both_kernels(cuda):
    q, k, v = (torch.randn((2, 50, 4, 16), device=cuda, requires_grad=True) for _ in range(3))
    _lib.reset_launches()
    attention.attention(q, k, v).sum().backward()
    assert _lib.launches["attention_fwd"] == 1 and _lib.launches["attention_bwd"] == 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def _fm_check(spec, tables):
    """K3 against its plain version within 1e-5, one launch a call, and the
    same bits over 10 calls."""
    _lib.reset_launches()
    got = fm_norm.fm_weighted_power_sum(spec, tables)
    assert _lib.launches["fm_norm"] == 1
    want = fm_norm.fm_weighted_power_sum_plain(spec, tables)
    assert float((got - want).abs() / want) <= 1e-5
    # deterministic: the same input gives the same bits
    assert all(torch.equal(fm_norm.fm_weighted_power_sum(spec, tables), got) for _ in range(10))


@pytest.mark.parametrize("layout", ["frames_major", "contiguous"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 130, 626, 1251])
def test_fm_kernel_matches_plain(cuda, layout, B, T):
    """Both layouts K3 takes without a copy: ``torch.stft``'s, with bins
    innermost in memory (strides (F·T, 1, F)), and the contiguous one."""
    tables = psycho.build_tables(AttackConfig(), cuda)
    g = torch.Generator(device=cuda).manual_seed(B * 10_000 + T)
    shape = (B, T, 513) if layout == "frames_major" else (B, 513, T)
    spec = torch.complex(torch.randn(shape, generator=g, device=cuda) * 10,
                         torch.randn(shape, generator=g, device=cuda) * 10)
    if layout == "frames_major":
        spec = spec.transpose(1, 2)
        assert spec.stride() == (513 * T, 1, 513)
    _fm_check(spec, tables)


def test_fm_kernel_on_stft_output_and_other_strides(cuda):
    """``dsp.stft``'s own output at the main and lv60 shapes, a 4-D batch,
    an STFT not 16-byte aligned, and a layout that is not dense (every
    other frame), which the kernel walks through its strides."""
    from paa_tpu_torch.ops import dsp

    cfg = AttackConfig()
    tables = psycho.build_tables(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for n in (160_000, 320_000):
        spec = dsp.stft(torch.randn((1, n), generator=g, device=cuda) * 0.01, cfg.n_fft,
                        cfg.hop_length, cfg.win_length)
        assert spec.shape[-2] == 513 and spec.stride()[-2:] == (1, 513)
        _fm_check(spec, tables)
    spec4 = dsp.stft(torch.randn((3, 1, 16_000), generator=g, device=cuda) * 0.1, cfg.n_fft,
                     cfg.hop_length, cfg.win_length)
    _fm_check(spec4, tables)
    flat = torch.complex(torch.randn(1 + 513 * 130, generator=g, device=cuda),
                         torch.randn(1 + 513 * 130, generator=g, device=cuda))
    unaligned = flat[1:].view(1, 130, 513).transpose(1, 2)
    assert unaligned.data_ptr() % 16 == 8
    _fm_check(unaligned, tables)
    _fm_check(spec[..., ::2], tables)


def test_fm_kernel_edge_cells(cuda):
    """Cells at power 0, at SPL exactly 0 and 90, and off the bins' domain,
    as chip_smoke.py's edge STFT holds them, in both layouts."""
    tables = psycho.build_tables(AttackConfig(), cuda)
    x = torch.zeros((1, 513, 130, 2), dtype=torch.float32)
    x[0, 10:200, 5:60, 0] = 1.0
    x[0, 200:400, 60:120, 0] = 1200.0
    x[0, 200:400, 60:120, 1] = 31600.0
    x[0, 0, :, 0] = 1.0
    spec = torch.view_as_complex(x.to(cuda))
    _fm_check(spec, tables)
    _fm_check(spec.transpose(1, 2).contiguous().transpose(1, 2), tables)


def test_fm_projection_goes_through_the_kernel(cuda):
    """The fletcher_munson projection on the card launches K3 once and gives
    what the plain path gives on the CPU."""
    from paa_tpu_torch.ops import projections

    cfg = AttackConfig(norm_type="fletcher_munson")
    p = torch.randn((1, 16000), generator=torch.Generator().manual_seed(3)) * 0.05

    def project(x, dev):
        return projections.perturbation_constraint(
            x.to(dev), None, cfg, ConstraintParams.create(device=dev),
            psycho.build_tables(cfg, dev))

    _lib.reset_launches()
    got = project(p, cuda)
    assert _lib.launches["fm_norm"] == 1
    want = project(p, torch.device("cpu"))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((want - p).abs().max()) > 1e-3  # p lay outside the ball


def test_lv60_flags_accumulated_step_on_the_card(cuda):
    """The lv60 flags on tiny widths, float32, A=2: the card's train step
    launches K1/K2 once per layer in each microbatch, K3 once, K6 once
    each way a feature-extractor layer and K7 once each way a LayerNorm in
    each microbatch, and its loss and new p match the CPU's plain path."""
    from paa_tpu_torch.ops import text
    from paa_tpu_torch.attack import step
    from paa_tpu_torch.models import wav2vec2

    mcfg = wav2vec2.get_config("wav2vec2-tiny", conv_bias=True, feat_extract_norm="layer",
                               do_stable_layer_norm=True, do_normalize=True)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", accum_steps=2)
    g = torch.Generator().manual_seed(0)
    audio = torch.randn((4, 16000), generator=g) * 0.1
    p = torch.randn((1, 16000), generator=g) * 1e-3
    labels, pads = (torch.from_numpy(a) for a in
                    text.encode_batch(["hello world", "delete", "test tone", "open close"]))
    weights = torch.ones(4)

    def run(dev):
        model = wav2vec2.init_model(mcfg, seed=1).to(dev)
        train = step.make_train_step(cfg, model, psycho.build_tables(cfg, dev))
        args = [t.to(dev) for t in (p, audio, labels, pads, weights)]
        new_p, _, m = train(args[0], None, *args[1:], ConstraintParams.create(device=dev), cfg.lr)
        return new_p.cpu(), float(m.ctc_loss)

    _lib.reset_launches()
    got_p, got_loss = run(cuda)
    L = mcfg.num_hidden_layers
    # float32: the positional conv stays on the library's conv, K5 never runs;
    # the LayerNorm feature extractor runs K6 at each layer once each way a
    # microbatch; K7 runs each way at each of the pre-LN layer's two
    # LayerNorms, the final one and the feature projection's, a microbatch
    fe, ln = 2 * len(mcfg.conv_dim), 2 * (2 * L + 2)
    assert _lib.launches == {"attention_fwd": 2 * L, "attention_bwd": 2 * L,
                             "attention_fwd_sm90": 0, "attention_bwd_sm90": 0, "fm_norm": 1,
                             "pos_conv": 0, "pos_conv_dgrad": 0, "fe_norm": fe, "fe_norm_bwd": fe,
                             "layer_norm": ln, "layer_norm_bwd": ln,
                             "attention_relpos_fwd": 0, "attention_relpos_bwd": 0}
    want_p, want_loss = run(torch.device("cpu"))
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    # PGD takes the gradient's sign: a sign near 0 may flip (2·lr at most)
    diff = (got_p - want_p).abs()
    assert float((diff < 1e-2 * cfg.lr).float().mean()) >= 0.99
    assert float(diff.max()) <= 2 * cfg.lr * 1.01
