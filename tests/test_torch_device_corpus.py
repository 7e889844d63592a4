"""The port's device feed (data/pipeline.py: DeviceCorpus, CachedCorpus,
maybe_device_corpus, CorpusCache, prefetch_to_device) against the JAX
package's, on the CPU: tests/test_device_corpus.py's cases, each fed the
same numpy inputs in both packages.

The batches must be bit-equal to the JAX feed's, padding rows included: the
device feed pads a short final batch with copies of row 0 and the host feed
with zero rows, and snr and tv size their ball from the whole clean batch,
so the padding decides the p an epoch ends with. The epochs through the tiny
committed checkpoint (float32) hold the port's scores against the JAX
runner's at tests/test_torch_loop.py's tolerances: clean scores within 1e-4
relative, perturbed CTC within 2 %, WER within 0.05; a projection of one p
against one batch within 1e-6.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.attack import optimizers as joptimizers
from paa_tpu.data import datasets
from paa_tpu.data import pipeline as jpipe
from paa_tpu.models import checkpoint_io
from paa_tpu.models import convert as jconvert
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.ops import projections as jproj
from paa_tpu.ops import psycho as jpsycho
from paa_tpu.train import loop as jloop
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.attack import optimizers
from paa_tpu_torch.cli import sweep
from paa_tpu_torch.data import pipeline as tpipe
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.ops import projections, psycho
from paa_tpu_torch.train import artifacts, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")
CPU = torch.device("cpu")
B = 8
FIELDS = ("audio", "labels", "label_paddings", "weights")


@pytest.fixture(scope="module")
def pipes():
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=36)
    return jpipe.build_pipeline(samples, seed=5), tpipe.build_pipeline(samples, seed=5)


def _same(got: tpipe.Batch, want) -> None:
    """Every field bit-equal, padding rows included; the port's arrays are
    tensors, its indices and host weights numpy."""
    for name in FIELDS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(g, torch.Tensor), name
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.indices.dtype == want.indices.dtype
    np.testing.assert_array_equal(got.indices, want.indices)
    assert isinstance(got.host_weights, np.ndarray)
    np.testing.assert_array_equal(got.host_weights, want.host_weights)


def _budget(split, rows: int) -> int:
    return rows * tpipe.row_bytes(split)


@pytest.mark.parametrize("shuffle", [None, 3], ids=["ordered", "shuffled"])
def test_device_corpus_matches_jax(pipes, shuffle):
    """Every field of every batch, the padded final batch included, equals
    the JAX DeviceCorpus's: padding rows carry row 0 with weight 0."""
    jp, tp = pipes
    rng = lambda: None if shuffle is None else np.random.default_rng(shuffle)
    want = list(jpipe.DeviceCorpus(jp.train).batches(B, shuffle_rng=rng()))
    got = list(tpipe.DeviceCorpus(tp.train, CPU).batches(B, shuffle_rng=rng()))
    assert len(got) == len(want) and len(tp.train) % B != 0  # a padded final batch
    for g, w in zip(got, want):
        _same(g, w)
    last = got[-1] if shuffle is None else None
    if last is not None:  # the padding rows are row 0's copies, not zeros
        pad = ~tpipe.host_mask(last)
        assert pad.any()
        for name in ("audio", "labels", "label_paddings"):
            rows = getattr(last, name).numpy()[pad]
            np.testing.assert_array_equal(rows, np.broadcast_to(
                getattr(got[0], name).numpy()[0], rows.shape))


@pytest.mark.parametrize("shuffle", [None, 3], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("rows", ["full", "half", "one"])
def test_cached_corpus_matches_jax(pipes, rows, shuffle):
    """At a full, a half and a one-row budget the batches equal the JAX
    CachedCorpus's and the port's DeviceCorpus's, bit for bit."""
    jp, tp = pipes
    n = {"full": len(tp.train), "half": len(tp.train) // 2, "one": 1}[rows]
    cache = _budget(tp.train, n) if rows != "one" else 1
    rng = lambda: None if shuffle is None else np.random.default_rng(shuffle)
    cc = tpipe.CachedCorpus(tp.train, cache, CPU)
    jc = jpipe.CachedCorpus(jp.train, cache_bytes=cache)
    assert cc.n_cached == jc.n_cached == n
    got = list(cc.batches(B, shuffle_rng=rng()))
    want = list(jc.batches(B, shuffle_rng=rng()))
    dev = list(tpipe.DeviceCorpus(tp.train, CPU).batches(B, shuffle_rng=rng()))
    assert len(got) == len(want) == len(dev)
    for g, w, d in zip(got, want, dev):
        _same(g, w)
        for name in FIELDS:
            assert torch.equal(getattr(g, name), getattr(d, name)), name


def test_cached_fully_resident_moves_no_audio_bytes(pipes):
    """A budget that holds the split: every batch is all-hit, the one-row
    zero buffer is staged once, and an epoch copies only index vectors."""
    _, tp = pipes
    cc = tpipe.CachedCorpus(tp.train, 64 << 30, CPU)
    assert cc.n_cached == len(tp.train)
    tpipe.reset_h2d()
    batches = list(cc.batches(B))
    zero = tpipe.h2d["bytes"] - len(batches) * 3 * B * 4  # beside the (3, B) int32 indices
    L = tp.train.labels.shape[1]
    assert zero == tp.train.audio_len * 4 + L * 4 + L * 4  # the zero buffer, once
    tpipe.reset_h2d()
    assert len(list(cc.batches(B))) == len(batches)
    assert tpipe.h2d["bytes"] == len(batches) * 3 * B * 4


def test_device_corpus_copies_only_rows(pipes):
    """DeviceCorpus copies a (B,) int32 row vector a batch; the host feed
    copies the whole batch."""
    _, tp = pipes
    corpus = tpipe.DeviceCorpus(tp.train, CPU)
    assert corpus.staged_bytes == tpipe.DeviceCorpus.nbytes(tp.train)
    tpipe.reset_h2d()
    n = len(list(corpus.batches(B)))
    assert tpipe.h2d == {"bytes": n * B * 4, "copies": n}
    tpipe.reset_h2d()
    host = list(tpipe.prefetch_to_device(tp.train.batches(B), CPU))
    assert tpipe.h2d["bytes"] == sum(sum(getattr(b, f).nbytes for f in FIELDS) for b in host)


def test_tristate(pipes):
    """False: the host feed; auto on the CPU: the host feed (the JAX auto
    on its CPU backend too); True: the whole split, on any device."""
    jp, tp = pipes
    assert tpipe.maybe_device_corpus(tp.train, False, CPU) is None
    assert tpipe.maybe_device_corpus(tp.train, None, CPU) is None
    assert isinstance(tpipe.maybe_device_corpus(tp.train, True, CPU), tpipe.DeviceCorpus)
    assert jpipe.maybe_device_corpus(jp.train, None) is None
    assert isinstance(jpipe.maybe_device_corpus(jp.train, True), jpipe.DeviceCorpus)


def test_auto_rule_on_cuda(pipes, monkeypatch):
    """Auto on a CUDA device, decided without one: the whole split at or
    under the budget, the cache past it (the JAX rule with TPU read as
    CUDA); explicit True and False win."""
    _, tp = pipes
    cuda = torch.device("cuda")
    nbytes = tpipe.DeviceCorpus.nbytes(tp.train)
    monkeypatch.setattr(tpipe, "_DEVICE_CACHE_AUTO_LIMIT", nbytes)
    assert tpipe.device_feed_kind(tp.train, None, cuda) == "device"
    monkeypatch.setattr(tpipe, "_DEVICE_CACHE_AUTO_LIMIT", nbytes - 1)
    assert tpipe.device_feed_kind(tp.train, None, cuda) == "cached"
    assert tpipe.device_feed_kind(tp.train, True, cuda) == "device"
    assert tpipe.device_feed_kind(tp.train, False, cuda) is None
    # the cache at that budget holds every row but the last
    budget = tpipe._DEVICE_CACHE_AUTO_LIMIT
    assert tpipe.CachedCorpus(tp.train, budget, CPU).n_cached == len(tp.train) - 1


def test_prefetch_keeps_order_and_host_weights(pipes):
    jp, tp = pipes
    got = list(tpipe.prefetch_to_device(tp.train.batches(B), CPU))
    want = list(jpipe.prefetch_to_device(jp.train.batches(B)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_batch_source_and_corpus_cache(pipes):
    """batch_source dispatches on the corpus; CorpusCache stages a split
    once, logs it once, and keeps the host feed under False."""
    _, tp = pipes
    corpus = tpipe.DeviceCorpus(tp.train, CPU)
    via = list(tpipe.batch_source(tp.train, B, corpus, CPU))
    for g, w in zip(via, corpus.batches(B)):
        assert torch.equal(g.audio, w.audio)
    host = next(tpipe.batch_source(tp.train, B, None, CPU))
    assert torch.equal(host.audio, torch.from_numpy(next(tp.train.batches(B)).audio))
    cache = tpipe.CorpusCache(True, CPU)
    log, lines = logging.getLogger("paa_tpu"), _Lines()
    level = log.level
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    try:
        first, again = cache.corpus(tp.train), cache.corpus(tp.train)
    finally:
        log.removeHandler(lines)
        log.setLevel(level)
    assert first is again and isinstance(first, tpipe.DeviceCorpus)
    assert sum("staged split to device" in line for line in lines.lines) == 1
    assert tpipe.CorpusCache(False, CPU).corpus(tp.train) is None


# -- epochs through the tiny checkpoint -------------------------------------


@pytest.fixture(scope="module")
def bundle():
    """The committed tiny checkpoint in both packages, and 48 clips: a train
    split of 38, whose last batch of 8 holds 6."""
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.requires_grad_(False).eval()
    jc = jw2v.get_config("wav2vec2-tiny")
    jm = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jm.apply({"params": prm}, a)
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=48)
    jp, tp = jpipe.build_pipeline(samples, seed=5), tpipe.build_pipeline(samples, seed=5)
    assert len(tp.train) % B != 0
    return model, (japply, jconvert.convert_hf_state_dict(sd, jc)), jp, tp


def _kw(**over):
    kw = dict(optimizer_type="pgd", lr=5e-3, batch_size=B, num_epochs=1, seed=5,
              model_name="wav2vec2-tiny")
    kw.update(over)
    return kw


def _init_p(audio_len):
    return (np.random.default_rng(21).standard_normal((1, audio_len)) * 1e-3).astype(np.float32)


def _port_epoch(model, pipe, cfg, cparams, corpus=None):
    runner = loop.AttackRunner(cfg, model, pipe, cparams)
    if corpus is not None:
        runner.corpora._corpora[id(pipe.train)] = (pipe.train, corpus)
    p = torch.from_numpy(_init_p(pipe.audio_len))
    p, _, train, _ = runner.train_epoch(p, optimizers.init_opt_state(cfg, p), 0,
                                        np.random.default_rng(7))
    return (p.numpy(), train, runner.evaluate(pipe.eval, p, perturbed=False),
            runner.evaluate(pipe.eval, p, perturbed=True))


@pytest.mark.parametrize("feed", ["device", "cached"])
def test_host_and_device_feeds_give_the_same_epoch(bundle, feed):
    """An epoch of linf PGD on the device feed (the whole split, or half of
    it resident) equals the host-feed epoch bit for bit: the same p and
    scores. linf never reads the clean batch and padding rows weigh 0."""
    model, _, _, tp = bundle
    cparams = tcfg.ConstraintParams.create(linf_size=0.02)
    host = _port_epoch(model, tp, tcfg.AttackConfig(**_kw(norm_type="linf",
                                                         cache_data_on_device=False)), cparams)
    cfg = tcfg.AttackConfig(**_kw(norm_type="linf", cache_data_on_device=True))
    corpus = (tpipe.CachedCorpus(tp.train, _budget(tp.train, len(tp.train) // 2), CPU)
              if feed == "cached" else None)
    dev = _port_epoch(model, tp, cfg, cparams, corpus)
    np.testing.assert_array_equal(dev[0], host[0])
    assert dev[1:] == host[1:]


SNR_TV = {"snr": {"snr_db": 50.0}, "tv": {"tv_epsilon": 1e-3}}


@pytest.mark.parametrize("norm", list(SNR_TV))
def test_snr_tv_epoch_matches_jax_device_corpus(bundle, norm):
    """One epoch of snr 50 or tv 1e-3 PGD on the device feed against the
    JAX runner on its device corpus, from the same p; p ends on the ball's
    surface, which the last (padded) batch sizes, so its norm is held too."""
    model, (japply, jparams), jp, tp = bundle
    kw = _kw(norm_type=norm, cache_data_on_device=True)
    p, train, clean, pert = _port_epoch(model, tp, tcfg.AttackConfig(**kw),
                                        tcfg.ConstraintParams.create(**SNR_TV[norm]))
    jcf = jcfg.AttackConfig(**kw)
    runner = jloop.AttackRunner(jcf, japply, jparams, jp,
                                cparams=jcfg.ConstraintParams.create(**SNR_TV[norm]),
                                use_mesh=False)
    jp0 = np.asarray(_init_p(jp.audio_len))
    jp1, _, jtrain, _ = runner.train_epoch(jp0, joptimizers.init_opt_state(jcf, jp0), 0,
                                           shuffle_rng=np.random.default_rng(7))
    jclean = runner.evaluate(jp.eval, jp1, perturbed=False)
    jpert = runner.evaluate(jp.eval, jp1, perturbed=True)
    assert clean.ctc == pytest.approx(jclean.ctc, rel=1e-4, abs=1e-4)
    assert clean.wer == pytest.approx(jclean.wer, rel=1e-4, abs=1e-4)
    assert train.ctc == pytest.approx(jtrain.ctc, rel=2e-2)
    assert pert.ctc == pytest.approx(jpert.ctc, rel=2e-2)
    assert abs(pert.wer - jpert.wer) <= 0.05
    size = (lambda x: np.sqrt(np.sum(x ** 2))) if norm == "snr" else (
        lambda x: np.sum(np.abs(np.diff(x))))
    assert size(p) == pytest.approx(size(np.asarray(jp1)), rel=1e-4)


def _final_batch(feed: str, jp, tp):
    """The last train batch (padded) of one feed, in the port and in JAX."""
    if feed == "host":
        got = list(tpipe.prefetch_to_device(tp.train.batches(B), CPU))[-1]
        want = list(jp.train.batches(B))[-1]
    else:
        got = list(tpipe.DeviceCorpus(tp.train, CPU).batches(B))[-1]
        want = list(jpipe.DeviceCorpus(jp.train).batches(B))[-1]
    assert not tpipe.host_mask(got).all()
    return got.audio, np.asarray(want.audio)


@pytest.mark.parametrize("feed", ["host", "device"])
@pytest.mark.parametrize("norm", list(SNR_TV))
def test_snr_tv_projection_of_the_padded_batch(bundle, norm, feed):
    """A fixed p projected against each feed's final padded batch equals the
    JAX projection against that feed's batch within 1e-6; the device feed's
    ball differs from the host feed's, so the padding is seen."""
    _, _, jp, tp = bundle
    kw = _kw(norm_type=norm)
    p = np.random.default_rng(4).standard_normal((1, tp.audio_len)).astype(np.float32)
    tc, jc = tcfg.AttackConfig(**kw), jcfg.AttackConfig(**kw)
    tparams = tcfg.ConstraintParams.create(**SNR_TV[norm])
    jparams = jcfg.ConstraintParams.create(**SNR_TV[norm])
    proj = {}
    for f in ("host", "device"):
        clean, jclean = _final_batch(f, jp, tp)
        got = projections.perturbation_constraint(torch.from_numpy(p), clean, tc, tparams,
                                                  psycho.build_tables(tc, CPU)).numpy()
        want = np.asarray(jproj.perturbation_constraint(p, jclean, jc, jparams,
                                                        jpsycho.build_tables(jc)))
        if f == feed:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        proj[f] = got
    assert not np.allclose(proj["host"], proj["device"], rtol=1e-3, atol=0)


def test_sweep_stages_each_split_once(tmp_path, monkeypatch):
    """A two-norm sweep with --device_cache on the CPU stages the train,
    eval and test splits once each, for every norm and across the drop of
    a frozen cell (linf ε=0 stops after 2 flat epochs)."""
    staged = []
    real = tpipe.DeviceCorpus.__init__

    def counting(self, split, device, mesh=None):
        staged.append(id(split))
        real(self, split, device, mesh=mesh)

    monkeypatch.setattr(tpipe.DeviceCorpus, "__init__", counting)
    monkeypatch.setattr(artifacts, "HAVE_MPL", False)
    argv = ["--platform", "cpu", "--model", "wav2vec2-tiny", "--compute_dtype", "float32",
            "--dataset", "synthetic", "--synthetic_samples", "24", "--synthetic_words", "3,4",
            "--batch_size", "8", "--optimizer_type", "pgd", "--lr", "5e-3",
            "--num_items_to_inspect", "0", "--norms", "linf,l2",
            "--grid", json.dumps({"linf": [0.0, 2e-2], "l2": [0.05]}), "--num_epochs", "4",
            "--early_stopping", "2", "--device_cache", "--save_root", str(tmp_path)]
    assert sweep.main(argv) == 0
    summary = json.load(open(tmp_path / "sweep_results.json"))
    assert summary["linf"]["programs_built"] == [1, 2]  # a frozen cell was dropped
    assert len(staged) == len(set(staged)) == 3
