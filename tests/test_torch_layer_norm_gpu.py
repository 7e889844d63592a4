"""The encoder's LayerNorm kernel K7 against its plain version on a GPU: the
forward, x̂ and 1/std it saves, and the input gradient at the main path's
rows (an lv60 microbatch at 20 s and 30 s, an lv60 eval batch, a base
batch, the feature projection's C = 512) and odd row counts at every width
the port runs (32 and 64 tiny, 512, 768, 1024), in bf16 and float32; the
same bits on a repeat; the reference's fast variance exactly on rows whose
sums are exact; the weight gradients only when asked; what the backward
keeps; no x̂ stored with grad off; inputs the kernel refuses raise; only
the feature projection's transposed input is copied to rows; the launches
of a full lv60, base and conformer attack step and eval batch at tiny
widths; lv60's remat policies against remat off. Every test needs a CUDA device and skips without one (the
kernel has no CPU mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_layer_norm_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.models import presets, wav2vec2
from paa_tpu_torch.ops.kernels import _lib, layer_norm

EPS = 1e-5
# max |kernel − reference| / max |reference| against the plain version in
# float32 on the same values. bf16: the kernel rounds each output once to
# bf16, so it lies within one bf16 step (2^-8) of the output's scale.
# float32: the same float32 sums in another order, some 1e-7 of the scale
TOL = {torch.bfloat16: 2.0**-8, torch.float32: 1e-5}
RSTD_TOL = 1e-6  # relative, each row: sums of the same float32 terms in another order
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
LV60_TINY = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
                 do_normalize=True)
CONFORMER = "wav2vec2-conformer-rope-large"
CONFORMER_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, conv_dim=(32,) * 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _inputs(shape, dev, dtype, seed=0):
    """x (hidden states around 0.1 with std 1.5), γ, β and the gradient of
    the output."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    C = shape[-1]
    x = (f(*shape) * 1.5 + 0.1).to(dtype)
    return x, 1 + f(C) * 0.2, f(C) * 0.2, f(*shape).to(dtype)


def _plain(x, weight, bias, dout):
    """The plain version in float32 on x's values: (out, x̂, 1/std, dx)."""
    leaf = x.float().requires_grad_(True)
    out = wav2vec2._LayerNormFn.apply(leaf, weight, bias, EPS)
    xhat, rstd, _ = out.grad_fn.saved_tensors
    (dx,) = torch.autograd.grad(out, leaf, dout.float())
    return out.detach(), xhat, rstd, dx


@DTYPES
@pytest.mark.parametrize("shape", [
    (32, 999, 1024),   # an lv60 attack microbatch at 20 s
    (16, 1499, 1024),  # at 30 s
    (64, 999, 1024),   # an lv60 eval batch
    (64, 499, 768),    # a base batch
    (32, 999, 512),    # lv60's feature projection
    (3, 37, 1024), (3, 37, 768), (3, 37, 512), (5, 7, 64), (1, 13, 32),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, dtype):
    x, weight, bias, dout = _inputs(shape, cuda, dtype, seed=sum(shape))
    _lib.reset_launches()
    out, xhat, rstd = layer_norm.layer_norm_fwd(x, weight, bias, EPS, save=True)
    dx, dw, db = layer_norm.layer_norm_bwd(dout, xhat, rstd, weight, wgrad=False)
    assert _lib.launches["layer_norm"] == 1 and _lib.launches["layer_norm_bwd"] == 1
    assert dw is None and db is None
    out_ref, xhat_ref, rstd_ref, dx_ref = _plain(x, weight, bias, dout)
    assert out.dtype == xhat.dtype == dx.dtype == dtype and rstd.dtype == torch.float32
    assert rstd.shape == rstd_ref.shape == (*shape[:-1], 1)
    assert _rel(out, out_ref) <= TOL[dtype]
    assert _rel(dx, dx_ref) <= TOL[dtype]
    assert float(((rstd - rstd_ref).abs() / rstd_ref).max()) <= RSTD_TOL
    # x̂ as the plain version keeps it, up to one rounding: one bf16 step of
    # each value (2^-7 of it at most), or float32 sums in another order
    if dtype == torch.bfloat16:
        assert bool(((xhat.float() - xhat_ref).abs() <= 2.0**-7 * xhat_ref.abs() + 1e-5).all())
    else:
        assert _rel(xhat, xhat_ref) <= TOL[dtype]
    # deterministic: the same inputs give the same bits
    again = layer_norm.layer_norm_fwd(x, weight, bias, EPS, save=True)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, xhat, rstd)))
    assert torch.equal(layer_norm.layer_norm_bwd(dout, xhat, rstd, weight, False)[0], dx)


@pytest.mark.parametrize("C", [32, 64])
def test_fast_variance_exactly(cuda, C):
    """The ``test_layernorm_is_not_welford`` case: mean 10× the std, values
    on multiples of 1/16 in pairs around exactly 10, so that Σ x, Σ x²,
    their means and the difference are exact in float32 in any order. K7's
    1/std and output are the fast variance's, computed in float64, to a
    float32 rounding."""
    g = torch.Generator().manual_seed(C)
    k = torch.randint(-16, 17, (7, C // 2), generator=g).double() / 16
    x64 = torch.cat([10 + k, 10 - k], dim=1)
    assert float(x64.mean(1).abs().min()) > 10 * float(x64.std(1, correction=0).max())
    mean = x64.mean(1, keepdim=True)
    var = ((x64 * x64).mean(1, keepdim=True) - mean * mean).clamp_min(0)
    rstd64 = torch.rsqrt(var + EPS)
    want = (x64 - mean) * rstd64
    x = x64.float().to(cuda)
    ones, zeros = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
    out, _, rstd = layer_norm.layer_norm_fwd(x, ones, zeros, EPS, save=True)
    torch.testing.assert_close(rstd.cpu().double(), rstd64, rtol=RSTD_TOL, atol=0)
    torch.testing.assert_close(out.cpu().double(), want, rtol=1e-6, atol=1e-6)


def _spy(monkeypatch, name):
    """Record the arguments of every call of ``layer_norm.<name>``."""
    calls, inner = [], getattr(layer_norm, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(layer_norm, name, spy)
    return calls


@DTYPES
@pytest.mark.parametrize("shape", [(32, 999, 1024), (4, 37, 768), (2, 13, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_weight_gradients_only_when_asked(cuda, monkeypatch, shape, dtype):
    """γ and β that need gradients (pretraining): ∂x, ∂γ and ∂β through K7's
    backward and its rows (one a block, at most twice the SMs), each against
    the plain version in float32 on the same values, within the dtype's
    tolerance of each gradient's scale; the same ∂x without them, for which
    the kernel is not asked for the rows; the same bits on a repeat."""
    x, weight, bias, dout = _inputs(shape, cuda, dtype, seed=7)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= layer_norm.wgrad_blocks(x) <= 2 * sms
    calls = _spy(monkeypatch, "layer_norm_bwd")

    def grads(params_too: bool):
        leaves = [x.clone().requires_grad_(True), weight.clone().requires_grad_(params_too),
                  bias.clone().requires_grad_(params_too)]
        asked = leaves if params_too else leaves[:1]
        return torch.autograd.grad(layer_norm.layer_norm(*leaves, EPS), asked, dout)

    _lib.reset_launches()
    got = grads(True)
    assert _lib.launches["layer_norm"] == 1 and _lib.launches["layer_norm_bwd"] == 1
    assert calls[-1][1]["wgrad"] is True
    ref = [x.float().requires_grad_(True), weight.clone().requires_grad_(True),
           bias.clone().requires_grad_(True)]
    want = torch.autograd.grad(wav2vec2._LayerNormFn.apply(*ref, EPS), ref, dout.float())
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32]
    for name, a, b in zip(("x", "weight", "bias"), got, want):
        assert _rel(a, b) <= TOL[dtype], name
    assert all(torch.equal(a, b) for a, b in zip(grads(True), got))
    (dx,) = grads(False)
    assert calls[-1][1]["wgrad"] is False
    assert torch.equal(dx, got[0])


@DTYPES
def test_no_xhat_with_grad_off(cuda, monkeypatch, dtype):
    """Grad off, or nothing that needs a gradient: one forward launch that
    writes the output alone (no x̂, no 1/std), the same output as with grad
    on, and nothing held past it but the output."""
    x, weight, bias, _ = _inputs((8, 99, 1024), cuda, dtype)
    calls = _spy(monkeypatch, "layer_norm_fwd")
    _lib.reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        out = layer_norm.layer_norm(x, weight, bias, EPS)
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated(cuda) - before
    assert held <= out.nbytes + 2 * 1024 * 4  # the output and γ, β as float32
    frozen = layer_norm.layer_norm(x, weight, bias, EPS)  # grad on, nothing requires it
    assert [c[1]["save"] for c in calls] == [False, False]
    assert _lib.launches["layer_norm"] == 2 and _lib.launches["layer_norm_bwd"] == 0
    with_grad = layer_norm.layer_norm(x.clone().requires_grad_(True), weight, bias, EPS)
    assert calls[-1][1]["save"] is True
    assert torch.equal(out, frozen) and torch.equal(out, with_grad.detach())


@DTYPES
def test_saves_xhat_and_rstd_only(cuda, dtype):
    """What the backward keeps, as the plain version keeps it: x̂ in the
    input's dtype, 1/std in float32 (one a row) and the scale parameter
    itself; no float32 tensor of the input's size."""
    x, _, _, _ = _inputs((2, 6, 32), cuda, dtype)
    norm = torch.nn.LayerNorm(32, device=cuda)
    out = wav2vec2._layer_norm(x.requires_grad_(True), norm)
    xhat, rstd, weight = out.grad_fn.saved_tensors
    assert xhat.dtype == dtype and xhat.shape == x.shape
    assert rstd.dtype == torch.float32 and rstd.shape == (2, 6, 1)
    assert weight is norm.weight


def test_refused_inputs_raise(cuda):
    """A last axis that is not a multiple of 8, or above 1024, float16, and
    a CPU tensor: the route and the kernel's entry points raise, and
    nothing is launched."""
    _lib.reset_launches()
    for C in (12, 1032):
        x, weight, bias, _ = _inputs((2, 5, C), cuda, torch.bfloat16)
        with pytest.raises(ValueError):
            layer_norm.layer_norm(x, weight, bias, EPS)
    x, weight, bias, _ = _inputs((2, 5, 64), cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        layer_norm.layer_norm(x.half(), weight, bias, EPS)
    with pytest.raises(ValueError):
        layer_norm.layer_norm_fwd(x.cpu(), weight, bias, EPS, save=False)
    assert _lib.launches["layer_norm"] == 0


def _model(preset: str, dev, **overrides):
    cfg = presets.get_config(preset, **overrides)
    return presets.init_model(cfg, seed=0).to(dev).requires_grad_(False)


@pytest.mark.parametrize("conv_impl, copies", [("conv", 1), ("im2col", 0)])
def test_only_the_projection_copies_to_rows(cuda, monkeypatch, conv_impl, copies):
    """The lv60 flags at tiny widths: under cuDNN's conv the feature
    projection's input is the feature extractor's transposed (B, C, T), the
    one call whose rows are not contiguous; under a lowering none is."""
    model = _model("wav2vec2-tiny", cuda, conv_impl=conv_impl, **LV60_TINY)
    calls = _spy(monkeypatch, "layer_norm_fwd")
    audio = (torch.randn((2, 16_000), device=cuda) * 0.1).requires_grad_(True)
    torch.autograd.grad(model(audio).sum(), audio)
    strided = [args[0].shape[-1] for args, _ in calls if not args[0].is_contiguous()]
    assert strided == [model.cfg.conv_dim[-1]] * copies
    assert len(calls) == 2 * model.cfg.num_hidden_layers + 2


def _attack_and_eval(model, dev, accum: int = 1):
    """The launch counts of one attack step of ``accum`` microbatches of two
    1 s clips each, then of one eval batch."""
    from paa_tpu_torch.attack import step
    from paa_tpu_torch.config import AttackConfig, ConstraintParams
    from paa_tpu_torch.ops import psycho, text

    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", accum_steps=accum)
    rows = 2 * accum
    g = torch.Generator().manual_seed(0)
    audio = (torch.randn((rows, 16_000), generator=g) * 0.1).to(dev)
    p = torch.zeros((1, 16_000), device=dev)
    labels, pads = (torch.from_numpy(a).to(dev)
                    for a in text.encode_batch(["hello", "world"] * accum))
    weights = torch.ones(rows, device=dev)
    train = step.make_train_step(cfg, model, psycho.build_tables(cfg, dev))
    _lib.reset_launches()
    train(p, None, audio, labels, pads, weights, ConstraintParams.create(device=dev), cfg.lr)
    attack = dict(_lib.launches)
    _lib.reset_launches()
    step.make_eval_step(cfg, model)(p, audio, labels, pads, weights)
    return attack, dict(_lib.launches)


@pytest.mark.parametrize("preset, overrides, per_layer", [
    ("wav2vec2-tiny", LV60_TINY, 2),  # pre-LN: two a layer, the final one, the projection's
    ("wav2vec2-tiny", {}, 2),         # post-LN: two a layer, the one before the stack, ...
    (CONFORMER, CONFORMER_TINY, 5),   # four a block and the conv module's, ...
], ids=["lv60", "base", "conformer"])
def test_launches_a_microbatch(cuda, preset, overrides, per_layer):
    """K7 each way at every LayerNorm of a microbatch of an attack step
    (50 / 50 at lv60's depth, 26 / 26 at base's, 122 / 122 in the
    conformer), forward only in an eval batch; in bf16 and float32."""
    for dtype in ("bfloat16", "float32"):
        model = _model(preset, cuda, compute_dtype=dtype, **overrides)
        want = per_layer * model.cfg.num_hidden_layers + 2
        attack, evaluate = _attack_and_eval(model, cuda, accum=2)
        assert attack["layer_norm"] == attack["layer_norm_bwd"] == 2 * want, dtype
        assert evaluate["layer_norm"] == want and evaluate["layer_norm_bwd"] == 0, dtype


@pytest.mark.parametrize("policy, again", [("no_probs", 0), ("save_cheap", 0),
                                           ("save_resid", 2), ("full", 2)])
def test_lv60_remat_on_the_card(cuda, policy, again):
    """The lv60 flags at tiny widths, float32: ∂loss/∂audio under each remat
    policy equals remat off's; ``save_resid`` and ``full`` run each layer's
    two LayerNorms forward again in the backward."""
    audio = torch.randn((2, 16_000), generator=torch.Generator().manual_seed(3)) * 0.1

    def grad(**over):
        model = _model("wav2vec2-tiny", cuda, **LV60_TINY, **over)
        a = audio.to(cuda).requires_grad_(True)
        _lib.reset_launches()
        (g,) = torch.autograd.grad(model(a).square().mean(), a)
        return g, dict(_lib.launches), model.cfg.num_hidden_layers

    g0, n0, L = grad()
    g, n, _ = grad(remat=True, remat_policy=policy)
    assert n0["layer_norm"] == n0["layer_norm_bwd"] == 2 * L + 2
    assert n["layer_norm"] == 2 * L + 2 + again * L and n["layer_norm_bwd"] == 2 * L + 2
    assert _rel(g, g0) <= 1e-6
