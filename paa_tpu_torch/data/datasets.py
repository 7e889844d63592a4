"""Dataset adapters: LibriSpeech / CommonVoice / TEDLIUM / synthetic.

Every adapter normalizes to the tuple contract of the reference's
pipeline — ``(waveform float32 (T,), sample_rate, transcript)`` —
(reference: src/training_utils/build.py:104-220). Network-dependent
sources are gated: in the zero-egress build environment they raise a
clear error and the ``synthetic`` corpus stands in (data/synthetic.py).

Supported sources:
  * ``synthetic``     — offline deterministic corpus (always available).
  * ``LibreeSpeech``  — the reference's (sic) LibriSpeech union over
    test-clean/test-other/dev-clean/dev-other (build.py:118-133): reads a
    local LibriSpeech-layout directory — WAV via the stdlib, FLAC via the
    optional ``soundfile`` import (the upstream distribution format).
  * ``CommonVoice`` / ``tedlium`` — HF datasets adapters mirroring
    build.py:135-163 (require a local HF cache).

The 30k-sample cap matches the reference (build.py:114).
"""

from __future__ import annotations

import logging
import os
import wave

import numpy as np

from paa_tpu_torch.data import synthetic

logger = logging.getLogger(__name__)

TARGET_SIZE = 30_000  # reference: build.py:114
DATASET_CHOICES = ("LibreeSpeech", "CommonVoice", "tedlium", "synthetic")

LIBRISPEECH_SPLITS = ("test-clean", "test-other", "dev-clean", "dev-other")


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        raw = f.readframes(n)
        width = f.getsampwidth()
        ch = f.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def _read_flac(path: str) -> tuple[np.ndarray, int]:
    """FLAC decode (the upstream LibriSpeech distribution format; the
    reference decodes it with torchaudio, build.py:118-133).

    Prefers ``soundfile`` (libsndfile) when installed; otherwise the
    bundled pure-numpy decoder (data/flac.py) covers the stock
    LibriSpeech subset. Exotic streams outside that subset keep the
    actionable error gate."""
    try:
        import soundfile as sf
    except ImportError:
        from paa_tpu_torch.data import flac

        try:
            return flac.read_flac(path)
        except flac.FlacError as e:
            raise RuntimeError(
                f"Could not decode {path!r} with the bundled FLAC decoder "
                f"({e}). Install 'soundfile' for full-format coverage, or "
                "convert the tree to WAV."
            ) from e
    x, sr = sf.read(path, dtype="float32", always_2d=False)
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, int(sr)


def _read_audio(path: str) -> tuple[np.ndarray, int]:
    if path.lower().endswith(".flac"):
        return _read_flac(path)
    return _read_wav(path)


_AUDIO_EXTS = (".wav", ".WAV", ".flac", ".FLAC")


def _iter_librispeech_pairs(root: str):
    """Walk a LibriSpeech-layout tree: speaker/chapter/*.trans.txt + audio.

    Audio may be WAV (stdlib decode) or FLAC (needs soundfile, see
    ``_read_flac``); transcript files use the standard ``<utt-id> <TEXT>``
    lines. Yields ``(audio_path, text)`` WITHOUT decoding — the caller
    shuffles the index before paying for decode.
    """
    for dirpath, _dirnames, filenames in os.walk(root):
        trans = [f for f in filenames if f.endswith(".trans.txt")]
        for tf in trans:
            with open(os.path.join(dirpath, tf)) as fh:
                for line in fh:
                    utt, _, text = line.strip().partition(" ")
                    for ext in _AUDIO_EXTS:
                        ap = os.path.join(dirpath, utt + ext)
                        if os.path.exists(ap):
                            yield ap, text
                            break


def _load_librispeech(data_root: str | None, target_size: int, seed: int):
    base = data_root or "librispeech_data"
    if not os.path.isdir(base):
        raise RuntimeError(
            "LibriSpeech not found locally and downloads are unavailable in "
            f"this environment (looked in {base!r}). Provide --data_root with "
            "a LibriSpeech-layout directory of WAV files, or use "
            "--dataset synthetic."
        )
    # index the whole tree (cheap string walk), shuffle, THEN decode only
    # target_size files — otherwise the cap keeps the first-walked
    # speakers/chapters and the subset is directory-biased
    pairs = list(_iter_librispeech_pairs(base))
    if not pairs:
        raise RuntimeError(f"No WAV/transcript pairs found under {base!r}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    samples = []
    for i in order[:target_size]:
        path, text = pairs[i]
        wav, sr = _read_audio(path)
        samples.append((wav, sr, text))
    return samples


def _load_hf(dataset: str, seed: int, target_size: int):
    """CommonVoice/TEDLIUM via HF datasets (reference: build.py:135-163)."""
    from datasets import Audio, load_dataset  # noqa: deferred heavy import

    if dataset == "CommonVoice":
        ds = load_dataset(
            "mozilla-foundation/common_voice_13_0", "en", split="train",
            trust_remote_code=True,
        )
        text_key = "sentence"
    else:
        ds = load_dataset("sanchit-gandhi/tedlium-data", split="train")
        text_key = "text"
    ds = ds.shuffle(seed=seed)
    ds = ds.select(range(min(target_size, len(ds))))
    ds = ds.cast_column("audio", Audio(sampling_rate=16_000))
    out = []
    for ex in ds:
        wav = np.asarray(ex["audio"]["array"], dtype=np.float32)
        out.append((wav, ex["audio"]["sampling_rate"], ex[text_key]))
    return out


def load_dataset_tuples(
    dataset: str,
    seed: int = 5,
    target_size: int = TARGET_SIZE,
    data_root: str | None = None,
    small_data: bool = False,
    synthetic_samples: int = 512,
    synthetic_words: tuple[int, int] | None = None,
):
    """Materialize the chosen corpus as a list of (waveform, sr, text).

    ``small_data`` subsets to ~1% — implementing the reference's
    *documented* behavior (its flag never actually subsets; SURVEY.md
    §5.9 "documented-vs-actual gap", parser.py:65).
    """
    if small_data and dataset != "synthetic":
        # ~1% subset, decided BEFORE decoding so small runs don't pay for
        # materializing the full corpus first
        target_size = max(64, target_size // 100)

    if dataset == "synthetic":
        n = synthetic_samples if not small_data else max(32, synthetic_samples // 8)
        words = {}
        if synthetic_words is not None:
            words = dict(min_words=synthetic_words[0], max_words=synthetic_words[1])
        samples = list(synthetic.generate_corpus(num_samples=n, seed=seed, **words))
    elif dataset == "LibreeSpeech":
        samples = _load_librispeech(data_root, target_size, seed)
    elif dataset in ("CommonVoice", "tedlium"):
        try:
            samples = _load_hf(dataset, seed, target_size)
        except Exception as e:
            raise RuntimeError(
                f"Could not load {dataset} via HF datasets (offline "
                "environment?). Use --dataset synthetic."
            ) from e
    else:
        raise ValueError(f"Unsupported dataset: {dataset!r}")

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    return [samples[i] for i in order][:target_size]
