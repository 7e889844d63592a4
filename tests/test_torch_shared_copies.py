"""The port's own copies of the JAX package's JAX-free modules, each held
against its original on the same inputs: the ISO 226 tables bit for bit,
text encoding, WER through the port's own Levenshtein library, FLAC decoding
of the golden streams through the port's own decoder library, the synthetic
corpus, checkpoint reading, scoring, TensorBoard event files and the
results aggregator. Also: the port's C helpers load their libraries from
``build/paa_tpu_torch/``.
"""

import os
from pathlib import Path

import json

import numpy as np
import pytest

from paa_tpu.cli import aggregate as j_aggregate
from paa_tpu.data import datasets as j_datasets
from paa_tpu.data import flac as j_flac
from paa_tpu.data import synthetic as j_synthetic
from paa_tpu.models import checkpoint_io as j_ckpt
from paa_tpu.ops import iso226 as j_iso226
from paa_tpu.ops import text as j_text
from paa_tpu.ops import wer as j_wer
from paa_tpu.train import artifacts as j_artifacts
from paa_tpu.train import scoring as j_scoring
from paa_tpu.train import tb_events as j_tb
from paa_tpu_torch.cli import aggregate as t_aggregate
from paa_tpu_torch.data import datasets as t_datasets
from paa_tpu_torch.data import flac as t_flac
from paa_tpu_torch.data import synthetic as t_synthetic
from paa_tpu_torch.models import checkpoint_io as t_ckpt
from paa_tpu_torch.ops import iso226 as t_iso226
from paa_tpu_torch.ops import text as t_text
from paa_tpu_torch.ops import wer as t_wer
from paa_tpu_torch.ops.kernels._lib import BUILD_DIR
from paa_tpu_torch.train import artifacts as t_artifacts
from paa_tpu_torch.train import scoring as t_scoring
from paa_tpu_torch.train import tb_events as t_tb

REPO = Path(__file__).resolve().parents[1]
TINY_CKPT = REPO / "checkpoints" / "wav2vec2-tiny-synthetic.safetensors"
BIN_FREQS = np.fft.rfftfreq(1024, d=1.0 / 16000)  # the attack's STFT bins


def _same(a, b):
    """Bit for bit: equal type, shape, dtype and bytes."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


ISO_CASES = {
    "constants": lambda m: (m.ISO226_FREQUENCIES, m.ISO226_ALPHA, m.ISO226_LU, m.ISO226_TF,
                            np.array([m.FREQ_MIN_HZ, m.FREQ_MAX_HZ, m.PHON_MIN, m.PHON_MAX])),
    "spl_40_phon": lambda m: m.iso226_spl(40.0, BIN_FREQS[2:]),
    "weight_matrix": lambda m: m.compute_weight_matrix(),
    "perceptual_weight": lambda m: m.perceptual_weight(m.compute_weight_matrix()[2]),
    "fm_weight_table": lambda m: m.fm_weight_table(BIN_FREQS),
    "phon_threshold_60": lambda m: m.phon_threshold(BIN_FREQS, 60.0),
    "phon_threshold_table": lambda m: m.phon_threshold_table(BIN_FREQS),
}


@pytest.mark.parametrize("case", sorted(ISO_CASES))
def test_iso226_tables_bit_for_bit(case):
    _same(ISO_CASES[case](t_iso226), ISO_CASES[case](j_iso226))


TEXTS = ["hello world", "Don't STOP, believing!", "", "  a  b  ", "ünïcode & digits 42"]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_text_encode_decode(i):
    s = TEXTS[i]
    assert t_text.clean_transcripts([s]) == j_text.clean_transcripts([s])
    assert t_text.encode(s) == j_text.encode(s)
    assert t_text.decode_ids(t_text.encode(s)) == j_text.decode_ids(j_text.encode(s))
    for got, want in zip(t_text.encode_batch([s, "open door"], pad_to=32),
                         j_text.encode_batch([s, "open door"], pad_to=32)):
        _same(got, want)


@pytest.mark.parametrize("target, reps, batch", [("delete", 1, 3), ("open the door", 4, 2)])
def test_text_targeted_texts(target, reps, batch):
    got = t_text.targeted_texts(target, reps, batch)
    assert got == j_text.targeted_texts(target, reps, batch)
    ids = np.asarray(t_text.encode_batch(got)[0])
    assert t_text.decode_batch(ids) == j_text.decode_batch(ids)


WER_CASES = [
    (["the cat sat"], ["the cat sat"]),
    (["the cat", "a b c d"], ["the cat sat", "b a c e"]),
    (["", "x"], ["one two", ""]),
    ([f"w{i} w{i + 1} w{i % 3}" for i in range(40)], [f"w{i} w{i % 5}" for i in range(40)]),
]


@pytest.mark.parametrize("i", range(len(WER_CASES)))
def test_wer_through_the_ports_library(i):
    preds, refs = WER_CASES[i]
    assert t_wer._load_native() is not None  # the native path, not the numpy fallback
    _same(t_wer.batched_word_distances(preds, refs), j_wer.batched_word_distances(preds, refs))
    assert t_wer.wer(preds, refs) == j_wer.wer(preds, refs)


@pytest.mark.parametrize("i", range(len(j_flac._golden_parity_streams())))
def test_flac_golden_streams_bit_exact(i):
    stream = t_flac._golden_parity_streams()[i]
    assert stream == j_flac._golden_parity_streams()[i]
    lib = t_flac._load_native()
    assert lib is not None
    got, sr = t_flac._native_call(lib, stream)
    want, want_sr = j_flac.decode_flac_py(stream)
    assert sr == want_sr
    _same(got, want)
    _same(t_flac.decode_flac(stream), j_flac.decode_flac(stream))


def test_flac_roundtrip_matches(tmp_path):
    x = (np.sin(np.arange(4000) / 7.0) * 9000).astype(np.int16)
    assert t_flac.encode_flac(x, 16000) == j_flac.encode_flac(x, 16000)
    path = str(tmp_path / "a.flac")
    t_flac.write_flac(path, x, 16000)
    _same(t_flac.read_flac(path), j_flac.read_flac(path))


@pytest.mark.parametrize("seed, words", [(5, {}), (11, {"min_words": 44, "max_words": 52})])
def test_synthetic_corpus_from_a_seed(seed, words):
    got = list(t_synthetic.generate_corpus(num_samples=4, seed=seed, **words))
    want = list(j_synthetic.generate_corpus(num_samples=4, seed=seed, **words))
    assert len(got) == len(want) == 4
    for (gw, gsr, gt), (ww, wsr, wt) in zip(got, want):
        _same(gw, ww)
        assert (gsr, gt) == (wsr, wt)


def test_synthetic_dataset_tuples():
    kw = dict(seed=3, synthetic_samples=6, synthetic_words=(3, 5))
    got = t_datasets.load_dataset_tuples("synthetic", **kw)
    want = j_datasets.load_dataset_tuples("synthetic", **kw)
    assert [t for _, _, t in got] == [t for _, _, t in want]
    for (gw, _, _), (ww, _, _) in zip(got, want):
        _same(gw, ww)


@pytest.mark.parametrize("reader", ["load_safetensors", "load_state_dict"])
def test_checkpoint_io_tiny_checkpoint(reader):
    got = getattr(t_ckpt, reader)(str(TINY_CKPT))
    want = getattr(j_ckpt, reader)(str(TINY_CKPT))
    assert list(got) == list(want)
    for name in want:
        _same(got[name], want[name])


def test_checkpoint_io_save_roundtrip(tmp_path):
    tensors = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(5, np.int64)}
    t_ckpt.save_safetensors(str(tmp_path / "t.safetensors"), tensors)
    j_ckpt.save_safetensors(str(tmp_path / "j.safetensors"), tensors)
    assert (tmp_path / "t.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()


SCORING_CASES = {
    "is_better": lambda m: [m.is_better(c, b, mode) for c, b in ((1.0, 2.0), (2.0, 1.0), (1.0, 1.0))
                            for mode in ("targeted", "untargeted")],
    "best_agg": lambda m: [m.best_agg([3.0, 1.0, 2.0], mode) for mode in ("targeted", "untargeted")],
    "initial_best": lambda m: [m.initial_best(mode) for mode in ("targeted", "untargeted")],
    "emission_metrics": lambda m: m.emission_metrics(
        ["open the door now", "close it", "OPEN THE DOOR open the door"], "open the door", 2),
    "scores": lambda m: m.Scores(1.5, 0.25),
}


@pytest.mark.parametrize("case", sorted(SCORING_CASES))
def test_scoring(case):
    got, want = SCORING_CASES[case](t_scoring), SCORING_CASES[case](j_scoring)
    if case == "scores":
        got, want = (got.ctc, got.wer), (want.ctc, want.wer)
    assert got == want


def test_tb_events_file_bytes(tmp_path):
    paths = []
    for name, mod in (("t", t_tb), ("j", j_tb)):
        with mod.EventWriter(str(tmp_path / name), wall_time=1_700_000_000.0) as w:
            w.scalar("loss/ctc", 12.5, 0, wall_time=1_700_000_001.0)
            w.scalars({"wer": 0.75, "skip": None, "ctc": 3}, 7, wall_time=1_700_000_002.0)
            paths.append(Path(w.path))
    assert paths[0].name == paths[1].name
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_artifacts_wav_and_results(tmp_path):
    p = np.sin(np.arange(1600, dtype=np.float32) / 5.0) * 0.3
    for name, mod in (("t", t_artifacts), ("j", j_artifacts)):
        d = tmp_path / name
        d.mkdir()
        mod.save_audio(str(d / "p.wav"), p, 16000, amplify=5.0)
        mod.save_json_results(str(d), "fletcher_munson", 0.05, eval_score={"ctc": 1.0, "wer": 0.5})
    for f in ("p.wav", "results.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


@pytest.mark.parametrize("module", ["wer", "flac"])
def test_c_helpers_load_from_the_ports_build_dir(module):
    """The loaded library's own path lies under build/paa_tpu_torch/, and its
    source is the port's copy: the JAX package's native/ is never used."""
    mod = {"wer": t_wer, "flac": t_flac}[module]
    lib = mod._load_native()
    assert lib is not None
    loaded = Path(lib._name).resolve()
    assert loaded.is_relative_to(BUILD_DIR.resolve()), loaded
    assert Path(mod._C_SOURCE).resolve().is_relative_to(REPO / "paa_tpu_torch" / "csrc")


def test_aggregate_collect_render_plot(tmp_path):
    """Both aggregators on the same run directories: equal rows, table and
    plot files (a finished sweep cell, an unfinished one, a failed run)."""
    runs = {
        "untargeted/synthetic/linf_0.0001_untargeted_pgd":
            {"norm_type": "linf", "attack_size": 1e-4, "finished_training": True,
             "final_test_clean": {"ctc": 9.5, "wer": 0.0},
             "final_test_perturbed": {"ctc": 20.25, "wer": 0.5},
             "perturbation_efficiency": {"ctc": 2.13, "wer": None}, "steps_per_sec": 3.5},
        "untargeted/synthetic/linf_0.0003_untargeted_pgd":
            {"norm_type": "linf", "attack_size": 3e-4, "finished_training": False,
             "eval_score_clean": {"ctc": 9.5, "wer": 0.0},
             "eval_score_perturbed": {"ctc": 40.0, "wer": 0.75}},
        "targeted/synthetic/max_phon_20_targeted_adam":
            {"norm_type": "max_phon", "attack_size": 20.0, "finished_training": False,
             "error": "boom"},
    }
    for rel, r in runs.items():
        (tmp_path / "logs" / rel).mkdir(parents=True)
        (tmp_path / "logs" / rel / "results.json").write_text(json.dumps(r))
    key = lambda row: row["run"]
    got = sorted(t_aggregate.collect(str(tmp_path / "logs")), key=key)
    want = sorted(j_aggregate.collect(str(tmp_path / "logs")), key=key)
    assert got == want and len(got) == 3
    assert t_aggregate.render(got) == j_aggregate.render(want)
    t_pngs = t_aggregate.plot(got, str(tmp_path / "t"))
    j_pngs = j_aggregate.plot(want, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in t_pngs] == [os.path.basename(p) for p in j_pngs]
