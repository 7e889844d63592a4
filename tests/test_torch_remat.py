"""The port's lean-residual Functions and remat against paa_tpu.models.wav2vec2
(float32, CPU): ``_LayerNormFn``, ``_GeluFn`` and ``_FFNFn`` against the JAX
custom VJPs ``_layernorm``, ``_gelu`` and ``_ffn`` (forward and every
gradient, at ``tests/test_custom_vjp.py``'s tolerances), what each keeps for
its backward, ∂loss/∂audio under every remat setting against remat off, the
remat model against the JAX one, and the command line's remat resolution
against the reference's."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.cli import parser as jparser
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v

FWD_TOL = 1e-6  # tests/test_custom_vjp.py's forward tolerance
GRAD_TOL = 2e-5  # and its gradient tolerance
EPS = 1e-5


def _jax_vjp(fn, args, ct):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _torch_vjp(fn, args, ct):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check(got, want, names):
    (out, grads), (jout, jgrads) = got, want
    np.testing.assert_allclose(out, jout, rtol=FWD_TOL, atol=FWD_TOL)
    for g, jg, name in zip(grads, jgrads, names):
        np.testing.assert_allclose(g, jg, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def _layernorm_input(case: str, rng) -> np.ndarray:
    if case == "normal":
        return rng.standard_normal((3, 7, 16)).astype(np.float32)
    # mean 10× the std: multiples of 1/16 around 10, so that every sum of
    # the fast variance (x, x², their means, the difference) is exact in
    # float32 in any order and both packages compute the same statistics;
    # Welford's (F.layer_norm's) rounds apart by more than FWD_TOL here
    x = (10 + rng.integers(-24, 25, (3, 7, 16)) / 16).astype(np.float32)
    assert abs(x.mean(-1)).min() > 10 * x.std(-1).max()
    return x


@pytest.mark.parametrize("case", ["normal", "mean_10x_std"])
def test_layernorm_matches_jax(case):
    rng = np.random.default_rng(42)
    x = _layernorm_input(case, rng)
    gamma = (rng.standard_normal(16) * 0.3 + 1).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.1).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want = _jax_vjp(lambda a, g, b: jw2v._layernorm(a, g, b, EPS), (x, gamma, beta), ct)
    got = _torch_vjp(lambda a, g, b: tw2v._LayerNormFn.apply(a, g, b, EPS), (x, gamma, beta), ct)
    _check(got, want, ("dx", "dgamma", "dbeta"))


def test_layernorm_is_not_welford():
    """On the exact-sum input the port's statistics are the fast variance's:
    torch's LayerNorm (Welford) misses the JAX reference by more than
    FWD_TOL, the port does not."""
    rng = np.random.default_rng(42)
    x = _layernorm_input("mean_10x_std", rng)
    ones, zeros = np.ones(16, np.float32), np.zeros(16, np.float32)
    want = np.asarray(jw2v._layernorm(jnp.asarray(x), ones, zeros, EPS))
    t = torch.from_numpy(x)
    welford = torch.nn.functional.layer_norm(t, (16,), eps=EPS).numpy()
    got = tw2v._LayerNormFn.apply(t, torch.from_numpy(ones), torch.from_numpy(zeros), EPS)
    assert np.abs(welford - want).max() > FWD_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_gelu_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 33)) * 2).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    _check(_torch_vjp(tw2v._GeluFn.apply, (x,), ct), _jax_vjp(jw2v._gelu, (x,), ct), ("dx",))


def test_ffn_matches_jax():
    """``_FFNFn`` takes ``nn.Linear``'s (out, in) weights, ``_ffn`` their
    transposes."""
    rng = np.random.default_rng(2)
    B, T, H, I = 2, 5, 8, 12
    y = rng.standard_normal((B, T, H)).astype(np.float32)
    ik = (rng.standard_normal((H, I)) * 0.3).astype(np.float32)
    ib = (rng.standard_normal(I) * 0.1).astype(np.float32)
    ok = (rng.standard_normal((I, H)) * 0.3).astype(np.float32)
    ob = (rng.standard_normal(H) * 0.1).astype(np.float32)
    ct = rng.standard_normal((B, T, H)).astype(np.float32)
    want = _jax_vjp(jw2v._ffn, (y, ik, ib, ok, ob), ct)
    out, grads = _torch_vjp(tw2v._FFNFn.apply, (y, ik.T.copy(), ib, ok.T.copy(), ob), ct)
    grads[1], grads[3] = grads[1].T, grads[3].T
    _check((out, grads), want, ("dy", "dik", "dib", "dok", "dob"))


def test_ffn_without_output_bias_is_the_partial_sum():
    """``ob=None`` (a tensor-parallel shard): the output lacks the bias, and
    the gradients of the rest are those with it."""
    rng = np.random.default_rng(3)
    y, ik, ib, ok, ob = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                         for s in ((2, 3, 8), (12, 8), (12,), (8, 12), (8,)))
    with_ob = tw2v._FFNFn.apply(y, ik, ib, ok, ob)
    without = tw2v._FFNFn.apply(y, ik, ib, ok, None)
    torch.testing.assert_close(without + ob, with_ob, rtol=0, atol=0)


def _saved(out: torch.Tensor) -> tuple:
    return out.grad_fn.saved_tensors


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_keeps_xhat_and_rstd_only(dtype):
    """x̂ in the input's dtype, 1/std in float32 (one per row) and the scale
    parameter itself: no float32 tensor of the input's size."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 6, 32)).astype(np.float32) * 3 + 1).to(dtype)
    norm = torch.nn.LayerNorm(32)
    x.requires_grad_(True)
    xhat, rstd, weight = _saved(tw2v._layer_norm(x, norm))
    xf = x.detach().float()
    mean = xf.mean(-1, keepdim=True)
    want_rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + norm.eps)
    assert xhat.dtype == dtype and xhat.shape == x.shape
    assert rstd.dtype == torch.float32 and rstd.shape == (2, 6, 1)
    assert weight is norm.weight
    torch.testing.assert_close(rstd, want_rstd)
    torch.testing.assert_close(xhat, ((xf - mean) * want_rstd).to(dtype))


def test_gelu_keeps_its_input_only():
    x = torch.randn(3, 5, requires_grad=True)
    (saved,) = _saved(tw2v._GeluFn.apply(x))
    assert saved is x


def test_ffn_keeps_its_input_and_weights_only():
    y = torch.randn(2, 3, 8, requires_grad=True)
    ik, ib, ok, ob = torch.randn(12, 8), torch.randn(12), torch.randn(8, 12), torch.randn(8)
    saved = _saved(tw2v._FFNFn.apply(y, ik, ib, ok, ob))
    assert len(saved) == 4 and all(s is t for s, t in zip(saved, (y, ik, ib, ok)))


# ---------------------------------------------------------------------------
# remat on the tiny preset
# ---------------------------------------------------------------------------

LV60_FLAGS = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
                  do_normalize=True)
LAYOUTS = {"tiny": {}, "lv60_flags": LV60_FLAGS}
ENCODER = {"off": {}, **{p: dict(remat=True, remat_policy=p)
                         for p in ("no_probs", "save_cheap", "save_resid", "full")}}
FE = {"fe_off": {}, "fe_save0": dict(remat_feature_extractor=True, remat_fe_save_layers=0),
      "fe_save2": dict(remat_feature_extractor=True, remat_fe_save_layers=2)}
FFN = {"ffn": {}, "remat_ffn": dict(remat_ffn=True)}
REMAT_CASES = list(itertools.product(LAYOUTS, ENCODER, FE, FFN))


def _grad_wrt_audio(layout: str, over: dict) -> tuple[np.ndarray, np.ndarray]:
    """(logits, ∂loss/∂audio) of the tiny model from seed 1 on a 0.25 s batch."""
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny", **LAYOUTS[layout], **over))
    model.load_state_dict(tw2v.init_model(model.cfg, seed=1).state_dict())
    model.requires_grad_(False).eval()
    rng = np.random.default_rng(5)
    audio = torch.from_numpy((rng.standard_normal((2, 4000)) * 0.1).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))
    x = audio.requires_grad_(True)
    logits = model(x)
    (g,) = torch.autograd.grad((logits * ct).sum(), x)
    return logits.detach().numpy(), g.numpy()


_REMAT_OFF = {}


@pytest.mark.parametrize("layout, encoder, fe, ffn", REMAT_CASES,
                         ids=["-".join(c) for c in REMAT_CASES])
def test_remat_grad_matches_remat_off(layout, encoder, fe, ffn):
    """Every encoder policy × feature-extractor remat × ``remat_ffn``: the
    same logits, and ∂loss/∂audio within 1e-6 of its largest value."""
    if layout not in _REMAT_OFF:
        _REMAT_OFF[layout] = _grad_wrt_audio(layout, {})
    want_logits, want = _REMAT_OFF[layout]
    logits, got = _grad_wrt_audio(layout, {**ENCODER[encoder], **FE[fe], **FFN[ffn]})
    np.testing.assert_array_equal(logits, want_logits)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_remat_is_skipped_without_grad():
    """Under ``no_grad`` no checkpoint is entered: the eval forward pays
    nothing for remat."""
    cfg = tw2v.get_config("wav2vec2-tiny", remat=True, remat_policy="full",
                          remat_feature_extractor=True)
    model = tw2v.init_model(cfg, seed=1)
    calls = []
    real = tw2v._checkpoint
    tw2v._checkpoint = lambda fn, *a: calls.append(fn) or real(fn, *a)
    try:
        with torch.no_grad():
            model(torch.zeros(1, 4000))
        assert calls == []
        x = torch.zeros(1, 4000, requires_grad=True)
        model(x).sum().backward()
        assert len(calls) == 1 + cfg.num_hidden_layers  # the FE and each layer
    finally:
        tw2v._checkpoint = real


@pytest.mark.parametrize("policy", ["full", "save_cheap"])
def test_remat_grad_matches_jax(policy):
    """The remat model against the JAX one with the same config (``remat``,
    the policy, feature-extractor remat, dense attention): logits and
    ∂loss/∂audio at ``tests/test_torch_wav2vec2.py``'s tolerances."""
    over = dict(compute_dtype="float32", remat=True, remat_policy=policy,
                remat_feature_extractor=True)
    jc = jw2v.get_config("wav2vec2-tiny", attention_impl="xla", **over)
    params = jw2v.init_params(jc, seed=1, example_len=2000)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny", **over))
    model.load_state_dict(convert.params_from_jax(params, model.cfg))
    model.requires_grad_(False).eval()
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((2, 12, 32)).astype(np.float32)
    want_logits, vjp = jax.vjp(lambda a: jmodel.apply({"params": params}, a), jnp.asarray(audio))
    (want,) = vjp(jnp.asarray(ct))
    want_logits, want = np.asarray(want_logits), np.asarray(want)
    x = torch.from_numpy(audio).requires_grad_(True)
    logits = model(x)
    (got,) = torch.autograd.grad(logits, x, torch.from_numpy(ct))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=2e-4, atol=2e-4)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3 * scale)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

REMAT_ARGVS = [[], ["--remat"], ["--no_remat"], ["--remat", "--no_remat"]]
REMAT_ARGVS += [f + ["--remat_policy", p] for f in ([], ["--remat"], ["--no_remat"])
                for p in ("full", "save_cheap", "no_probs", "save_resid")]


@pytest.mark.parametrize("argv", REMAT_ARGVS, ids=[" ".join(a) or "none" for a in REMAT_ARGVS])
def test_remat_resolves_as_the_reference_off_tpu(argv):
    """``(remat, remat_policy)`` as ``paa_tpu.cli.parser.resolve_perf_defaults``
    gives them on the CPU (the reference turns remat on by default only on a
    TPU): off unless asked, ``save_cheap`` when on without a policy."""
    assert jax.default_backend() == "cpu"
    jremat, jpolicy, _ = jparser.resolve_perf_defaults(jparser.create_arg_parser()
                                                       .parse_args(argv))
    targs = tparser.parse_args(argv)
    assert tparser.resolve_remat(targs) == (jremat, jpolicy)
    assert tparser.config_from_args(targs).remat is jremat
