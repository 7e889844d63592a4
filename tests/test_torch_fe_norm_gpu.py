"""The feature extractor's norm kernel K6 against its plain version on a
GPU: the forward, the input gradient and, with weights that need gradients,
the gradients of γ, β and the conv bias, at lv60's layer-0 and layer-6
lengths, T = 1 and a C other than 512, with the tanh and the erf GELU, in
bf16 and float32, on (B, C, T) and (B, T, C); the same bits on a repeat;
every CUDA input routed to the kernel; inputs the kernel refuses raise; one
launch each way a layer of an lv60 attack microbatch (under cuDNN's conv and
under a lowering), forward launches only in an eval batch, none at base. Every test needs a CUDA device and skips without one (the kernel
has no CPU mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_fe_norm_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.ops.kernels import _lib, fe_norm

EPS = 1e-5
# max |kernel − reference| / max |reference| against the plain version in
# float32 on the same values. bf16: the kernel rounds each output once to
# bf16, so it lies within one bf16 step (2^-8) of the output's scale.
# float32: the same float32 sums in another order and the device's own exp2
# and erf, some 1e-6 of the scale
TOL = {torch.bfloat16: 2.0**-8, torch.float32: 1e-5}
DTYPES = [torch.bfloat16, torch.float32]
# dim 1: cuDNN's (B, C, T); dim 2: the (B, T, C) of the conv lowerings
LAYOUTS = pytest.mark.parametrize("dim", [1, 2], ids=["bct", "btc"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _inputs(B, C, T, dev, seed=0, dtype=torch.bfloat16, dim=1):
    """y and the gradient of the output in the layout ``dim``, and the conv
    bias, γ and β."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev)
    lay = (lambda t: t) if dim == 1 else (lambda t: t.transpose(1, 2).contiguous())
    y = lay(f(B, C, T) * 2 + 0.3).to(dtype)
    params = [f(C) * 0.3, 1 + f(C) * 0.2, f(C) * 0.2]  # conv bias, γ, β
    return y, params, lay(f(B, C, T)).to(dtype)


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("B, C, T", [
    (2, 512, 63_999),  # lv60's layer 0 at 20 s
    (4, 512, 999),     # its layer 6
    (3, 512, 1),
    (2, 264, 777),     # C = 8·33
])
def test_kernel_matches_plain(cuda, B, C, T, tanh, dtype, dim):
    y, params, dout = _inputs(B, C, T, cuda, seed=T + C, dtype=dtype, dim=dim)
    _lib.reset_launches()
    out, mean, rstd = fe_norm.fe_norm_fwd(y, *params, EPS, tanh, stats=True, dim=dim)
    dy, *_ = fe_norm.fe_norm_bwd(dout, y, *params, mean, rstd, tanh, wgrad=False, dim=dim)
    assert _lib.launches["fe_norm"] == 1 and _lib.launches["fe_norm_bwd"] == 1
    yr = y.float().requires_grad_(True)
    want = fe_norm.fe_norm_gelu_plain(yr, *params, EPS, tanh, dim)
    (dy_ref,) = torch.autograd.grad(want, yr, dout.float())
    assert out.dtype == dy.dtype == dtype
    assert _rel(out, want) <= TOL[dtype]
    assert _rel(dy, dy_ref) <= TOL[dtype]
    # the statistics, float32 and two-pass: var_mean's of y + bias
    bias = params[0][:, None] if dim == 1 else params[0]
    var, mu = torch.var_mean(y.float() + bias, dim=dim, correction=0)
    assert _rel(mean, mu) <= 1e-5 and _rel(rstd, torch.rsqrt(var + EPS)) <= 1e-5
    # deterministic: the same inputs give the same bits
    assert torch.equal(fe_norm.fe_norm_fwd(y, *params, EPS, tanh, stats=False, dim=dim)[0], out)
    assert torch.equal(
        fe_norm.fe_norm_bwd(dout, y, *params, mean, rstd, tanh, False, dim=dim)[0], dy)


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("B, C, T", [(2, 512, 63_999), (4, 512, 999), (3, 264, 37)])
def test_weight_gradients(cuda, B, C, T, dtype, dim):
    """Weights that need gradients (pretraining): ∂y through K6's backward,
    ∂(conv bias), ∂γ and ∂β from its rows (one a block, at most twice the
    SMs), each against the plain version in float32 on the same values,
    within the dtype's tolerance of each gradient's scale (the weight
    gradients are float32 sums in another order); the same bits on a
    repeat."""
    y, params, dout = _inputs(B, C, T, cuda, seed=7, dtype=dtype, dim=dim)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= fe_norm.wgrad_blocks(y, dim) <= 2 * sms

    def grads():
        leaves = [y.clone().requires_grad_(True)] + [p.clone().requires_grad_(True)
                                                     for p in params]
        return torch.autograd.grad(fe_norm.fe_norm_gelu(leaves[0], *leaves[1:], EPS, True, dim),
                                   leaves, dout)

    _lib.reset_launches()
    got = grads()
    assert _lib.launches["fe_norm"] == 1 and _lib.launches["fe_norm_bwd"] == 1
    ref = [y.float().requires_grad_(True)] + [p.clone().requires_grad_(True) for p in params]
    want = torch.autograd.grad(fe_norm.fe_norm_gelu_plain(ref[0], *ref[1:], EPS, True, dim), ref,
                               dout.float())
    assert [g.dtype for g in got] == [dtype] + [torch.float32] * 3
    for name, a, b in zip(("y", "bias", "weight", "bias_ln"), got, want):
        assert _rel(a, b) <= TOL[dtype], name
    assert all(torch.equal(a, b) for a, b in zip(grads(), got))


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_every_cuda_input_launches_k6(cuda, dtype, dim):
    """The route: a CUDA tensor in either dtype and either layout goes to the
    kernel, with grad (forward and backward) and without (forward only)."""
    y, params, dout = _inputs(2, 64, 45, cuda, dtype=dtype, dim=dim)
    _lib.reset_launches()
    with torch.no_grad():
        fe_norm.fe_norm_gelu(y, *params, EPS, False, dim)
    assert _lib.launches["fe_norm"] == 1 and _lib.launches["fe_norm_bwd"] == 0
    leaf = y.clone().requires_grad_(True)
    torch.autograd.grad(fe_norm.fe_norm_gelu(leaf, *params, EPS, False, dim), leaf, dout)
    assert _lib.launches["fe_norm"] == 2 and _lib.launches["fe_norm_bwd"] == 1


def test_refused_shapes_raise(cuda):
    """C not a multiple of 8, C above 1024, float16, and a tensor that is
    not a 3-d CUDA conv output: the route and the kernel's entry points
    raise, and nothing is launched."""
    _lib.reset_launches()
    for dim in (1, 2):
        for C in (12, 1032):
            y, params, _ = _inputs(1, C, 40, cuda, dim=dim)
            with pytest.raises(ValueError):
                fe_norm.fe_norm_gelu(y, *params, EPS, True, dim)
    y, params, _ = _inputs(1, 16, 40, cuda)
    with pytest.raises(ValueError):
        fe_norm.fe_norm_gelu(y.half(), *params, EPS, True)
    with pytest.raises(ValueError):
        fe_norm.fe_norm_fwd(y[None], *params, EPS, True, stats=False)
    with pytest.raises(ValueError):
        fe_norm.fe_norm_fwd(y.cpu(), *params, EPS, True, stats=False)
    assert _lib.launches["fe_norm"] == 0


def _attack_and_eval(preset, dev, **overrides):
    """The launch counts of one attack step with one microbatch of two 2 s
    clips, then of one eval batch (under no_grad)."""
    from paa_tpu_torch.attack import step
    from paa_tpu_torch.config import AttackConfig, ConstraintParams
    from paa_tpu_torch.models import wav2vec2
    from paa_tpu_torch.ops import psycho, text

    model = wav2vec2.init_model(wav2vec2.get_config(preset, **overrides), seed=0)
    model = model.cast_param_storage(torch.bfloat16).to(dev)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", accum_steps=1,
                       model_name=preset)
    g = torch.Generator().manual_seed(0)
    audio = (torch.randn((2, 32_000), generator=g) * 0.1).to(dev)
    p = torch.zeros((1, 32_000), device=dev)
    labels, pads = (torch.from_numpy(a).to(dev) for a in text.encode_batch(["hello", "world"]))
    weights = torch.ones(2, device=dev)
    train = step.make_train_step(cfg, model, psycho.build_tables(cfg, dev))
    _lib.reset_launches()
    train(p, None, audio, labels, pads, weights, ConstraintParams.create(device=dev), cfg.lr)
    attack = dict(_lib.launches)
    _lib.reset_launches()
    step.make_eval_step(cfg, model)(p, audio, labels, pads, weights)
    return attack, dict(_lib.launches)


@pytest.mark.parametrize("conv_impl", ["conv", "im2col"])
def test_lv60_launches_k6_once_a_layer_each_way(cuda, conv_impl):
    """On cuDNN's (B, C, T) and on a lowering's (B, T, C) alike."""
    attack, evaluate = _attack_and_eval("wav2vec2-large-lv60", cuda, conv_impl=conv_impl)
    assert attack["fe_norm"] == 7 and attack["fe_norm_bwd"] == 7
    assert evaluate["fe_norm"] == 7 and evaluate["fe_norm_bwd"] == 0
    # beside it K7 at every LayerNorm: 2 × 24 layers, the final one, the projection's
    assert attack["layer_norm"] == attack["layer_norm_bwd"] == 50
    assert evaluate["layer_norm"] == 50 and evaluate["layer_norm_bwd"] == 0


def test_base_never_launches_k6(cuda):
    attack, evaluate = _attack_and_eval("wav2vec2-base", cuda)
    assert attack["fe_norm"] == attack["fe_norm_bwd"] == 0
    assert evaluate["fe_norm"] == evaluate["fe_norm_bwd"] == 0
    # K7: 2 × 12 post-LN layers, the LayerNorm before the stack, the projection's
    assert attack["layer_norm"] == attack["layer_norm_bwd"] == 26
    assert evaluate["layer_norm"] == 26 and evaluate["layer_norm_bwd"] == 0
