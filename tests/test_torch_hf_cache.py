"""The port's HF hub cache loader against the JAX package's.

Fake caches are written under a temporary ``HF_HUB_CACHE`` (or ``HF_HOME``)
with the port's ``checkpoint_io.save_safetensors``; the port's lookup
(``paa_tpu_torch.models.hf_cache``) must find the file the reference's
``_find_cached_weights`` finds and read the same tensors, and the entry
point's ``load_model`` must attack the cached weights exactly as the
reference's ``load_model_bundle`` does, with the same logits.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.cli import parser as jparser
from paa_tpu.cli import run_attack as jrun
from paa_tpu.models import checkpoint_io as jcheckpoint_io
from paa_tpu.models import convert as jconvert
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.models import checkpoint_io, hf_cache
from paa_tpu_torch.models import wav2vec2 as tw2v

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")
BASE_REPO = "models--facebook--wav2vec2-base-960h"
# tests/test_torch_wav2vec2.py's tolerance for the base geometry
BASE_TOL = 1e-3


def _small_sd(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
            "a.bias": np.full((3,), seed, np.float32)}


def _snapshot(cache, sha, files, mtime=None, repo=BASE_REPO):
    """One snapshot directory holding ``files`` ({name: state dict}); the
    safetensors files are written by the port, the .bin files by torch."""
    snap = os.path.join(cache, repo, "snapshots", sha)
    os.makedirs(snap)
    for name, sd in files.items():
        path = os.path.join(snap, name)
        if name.endswith(".safetensors"):
            checkpoint_io.save_safetensors(path, sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    if mtime is not None:
        os.utime(snap, (mtime, mtime))
    return snap


def _ref(cache, sha, repo=BASE_REPO):
    os.makedirs(os.path.join(cache, repo, "refs"), exist_ok=True)
    with open(os.path.join(cache, repo, "refs", "main"), "w") as f:
        f.write(sha + "\n")


def _build(kind, cache):
    """A fake cache of one kind → the weights file the lookup must find."""
    st = "model.safetensors"
    if kind == "ref_wins":  # the ref names the older snapshot
        want = _snapshot(cache, "a" * 40, {st: _small_sd(1)}, mtime=1_000)
        _snapshot(cache, "b" * 40, {st: _small_sd(2)}, mtime=2_000)
        _ref(cache, "a" * 40)
    elif kind == "ref_to_missing_snapshot":  # the newest snapshot wins
        _snapshot(cache, "c" * 40, {st: _small_sd(3)}, mtime=1_000)
        want = _snapshot(cache, "b" * 40, {st: _small_sd(4)}, mtime=3_000)
        _snapshot(cache, "a" * 40, {st: _small_sd(5)}, mtime=2_000)
        _ref(cache, "f" * 40)
    elif kind == "no_ref_newest":
        want = _snapshot(cache, "0" * 40, {st: _small_sd(6)}, mtime=5_000)
        _snapshot(cache, "f" * 40, {st: _small_sd(7)}, mtime=4_000)
    elif kind == "safetensors_before_bin":
        want = _snapshot(cache, "a" * 40, {"pytorch_model.bin": _small_sd(8), st: _small_sd(9)})
        _ref(cache, "a" * 40)
    elif kind == "bin_alone":
        want = _snapshot(cache, "a" * 40, {"pytorch_model.bin": _small_sd(10)})
    else:
        raise ValueError(kind)
    name = st if os.path.exists(os.path.join(want, st)) else "pytorch_model.bin"
    return os.path.join(want, name)


@pytest.fixture
def no_hf_env(monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.delenv("HF_HOME", raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
@pytest.mark.parametrize("kind", ["ref_wins", "ref_to_missing_snapshot", "no_ref_newest",
                                  "safetensors_before_bin", "bin_alone"])
def test_lookup_matches_the_reference(tmp_path, no_hf_env, env, kind):
    """The same file as the reference's ``_find_cached_weights``, and the same
    tensors as its ``checkpoint_io.load_state_dict``, under ``HF_HUB_CACHE``
    or under ``HF_HOME`` alone (whose cache is ``$HF_HOME/hub``)."""
    if env == "HF_HUB_CACHE":
        cache = str(tmp_path / "hub_cache")
        no_hf_env.setenv("HF_HUB_CACHE", cache)
    else:
        no_hf_env.setenv("HF_HOME", str(tmp_path / "hf_home"))
        cache = str(tmp_path / "hf_home" / "hub")
    assert hf_cache.hub_cache_dir() == cache
    want_path = _build(kind, cache)
    got_path = hf_cache.find_cached_weights("facebook/wav2vec2-base-960h")
    assert got_path == want_path
    assert got_path == jconvert._find_cached_weights("facebook/wav2vec2-base-960h")
    path, sd = hf_cache.load_cached_state_dict("wav2vec2-base")
    assert path == want_path
    want_sd = jcheckpoint_io.load_state_dict(want_path)
    assert sd.keys() == want_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])


def test_default_cache_is_under_home(no_hf_env, tmp_path):
    no_hf_env.setenv("HOME", str(tmp_path))
    assert hf_cache.hub_cache_dir() == str(tmp_path / ".cache" / "huggingface" / "hub")


def test_empty_cache_raises(tmp_path, no_hf_env):
    no_hf_env.setenv("HF_HUB_CACHE", str(tmp_path))
    assert hf_cache.find_cached_weights("facebook/wav2vec2-base-960h") is None
    assert jconvert._find_cached_weights("facebook/wav2vec2-base-960h") is None
    with pytest.raises(FileNotFoundError, match="wav2vec2-base-960h"):
        hf_cache.load_cached_state_dict("wav2vec2-base")


def _args(model):
    argv = ["--model", model, "--platform", "cpu", "--compute_dtype", "float32"]
    return tparser.parse_args(argv), jparser.create_arg_parser().parse_args(argv)


def _state(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def base_cache(tmp_path_factory):
    """A cache holding base-geometry random weights (12 layers, hidden 768)
    as ``facebook/wav2vec2-base-960h``."""
    cache = str(tmp_path_factory.mktemp("hub"))
    cfg = tw2v.get_config("wav2vec2-base", compute_dtype="float32")
    sd = _state(tw2v.init_model(cfg, seed=11))
    _snapshot(cache, "d" * 40, {"model.safetensors": sd})
    _ref(cache, "d" * 40)
    return cache, sd


def test_base_loads_the_cached_weights_with_the_reference_logits(base_cache, no_hf_env):
    """``--model wav2vec2-base`` without ``--checkpoint_path``: the port loads
    exactly the cached tensors, and on a 0.5 s clip its logits equal the JAX
    model's on the weights the reference's own load found."""
    cache, sd = base_cache
    no_hf_env.setenv("HF_HUB_CACHE", cache)
    targs, jargs = _args("wav2vec2-base")
    model = trun.load_model(targs, torch.device("cpu"))
    got_sd = _state(model)
    assert got_sd.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got_sd[k], sd[k])

    _mcfg, params, apply_fn = jrun.load_model_bundle(jargs, attn_mesh=None)
    audio = (np.random.default_rng(5).standard_normal((1, 8000)) * 0.1).astype(np.float32)
    want = np.asarray(apply_fn(params, jnp.asarray(audio)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, model.cfg.feat_extract_output_length(8000), 32)
    np.testing.assert_allclose(got, want, rtol=BASE_TOL, atol=BASE_TOL)


def _random(model_name: str, seed: int) -> dict:
    cfg = tw2v.get_config(model_name, compute_dtype="float32")
    return _state(tw2v.init_model(cfg, seed=seed))


def _assert_same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_tiny_never_reads_the_cache(tmp_path, no_hf_env, caplog):
    """``wav2vec2-tiny`` is test-only: even with its weights in the cache it
    draws random weights from ``--seed``, without a warning."""
    no_hf_env.setenv("HF_HUB_CACHE", str(tmp_path))
    snap = _snapshot(str(tmp_path), "a" * 40, {}, repo="models--wav2vec2-tiny")
    os.symlink(TINY_CKPT, os.path.join(snap, "model.safetensors"))
    assert hf_cache.find_cached_weights("wav2vec2-tiny") is not None
    targs, _ = _args("wav2vec2-tiny")
    with caplog.at_level(logging.INFO, logger="paa_tpu"):
        got = _state(trun.load_model(targs, torch.device("cpu")))
    _assert_same_state(got, _random("wav2vec2-tiny", targs.seed))
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


@pytest.mark.parametrize("kind", ["empty", "unreadable", "wrong_tensors"])
def test_no_usable_cache_gives_random_weights_and_a_warning(tmp_path, no_hf_env, caplog, kind):
    """An empty cache, a weights file that cannot be read, or one whose
    tensors do not fit the preset: a warning, then random weights from
    ``--seed``, as the reference falls back."""
    no_hf_env.setenv("HF_HUB_CACHE", str(tmp_path))
    if kind == "unreadable":
        snap = _snapshot(str(tmp_path), "a" * 40, {})
        with open(os.path.join(snap, "model.safetensors"), "wb") as f:
            f.write(b"not a checkpoint")
    elif kind == "wrong_tensors":
        _snapshot(str(tmp_path), "a" * 40, {"model.safetensors": _small_sd(0)})
    targs, _ = _args("wav2vec2-base")
    with caplog.at_level(logging.WARNING, logger="paa_tpu"):
        got = _state(trun.load_model(targs, torch.device("cpu")))
    _assert_same_state(got, _random("wav2vec2-base", targs.seed))
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "pretrained weights unavailable" in warnings[0]
