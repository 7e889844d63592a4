"""Deterministic synthetic speech-like corpus.

The build environment is zero-egress: LibriSpeech/CommonVoice/TEDLIUM
cannot be downloaded (the reference materializes them via torchaudio/HF
at reference: src/training_utils/build.py:104-220). This module provides
a fully offline stand-in with the same *interface* — an iterable of
``(waveform float32, sample_rate, transcript str)`` — so every layer
above the adapters (length filtering, splits, batching, attack loop,
metrics) exercises identical code paths.

Each transcript word maps to a deterministic formant-like chirp pattern,
so audio/transcript pairs are consistent across runs and a CTC model can
in principle learn them; utterance lengths vary to exercise the quantile
length filter (reference: build.py:186-192).
"""

from __future__ import annotations

import hashlib

import numpy as np

WORD_BANK = (
    "the quick brown fox jumps over lazy dog speech attack delete "
    "model audio signal noise loud quiet phone tone hello world test "
    "alpha beta gamma delta open close start stop"
).split()


def _word_seed(word: str) -> int:
    return int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")


def _word_audio(word: str, sr: int) -> np.ndarray:
    """A short formant-ish chirp unique to the word (deterministic)."""
    rng = np.random.default_rng(_word_seed(word))
    dur = 0.18 + 0.04 * len(word)  # longer words take longer to "say"
    t = np.arange(int(dur * sr)) / sr
    f0 = rng.uniform(120.0, 280.0)
    formants = rng.uniform(400.0, 2800.0, size=3)
    sig = 0.35 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.1 * np.sin(2 * np.pi * 3.0 * t)))
    for k, f in enumerate(formants):
        sig = sig + 0.18 / (k + 1) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    env = np.minimum(1.0, 8.0 * np.minimum(t, t[::-1] + 1e-9) / dur)
    return (sig * env).astype(np.float32)


def generate_corpus(
    num_samples: int = 256,
    sr: int = 16000,
    seed: int = 5,
    min_words: int = 3,
    max_words: int = 8,
):
    """Yield ``(waveform, sr, transcript)`` tuples (reference adapter
    contract, build.py:133)."""
    rng = np.random.default_rng(seed)
    gap = np.zeros(int(0.06 * sr), dtype=np.float32)
    for _ in range(num_samples):
        n_words = int(rng.integers(min_words, max_words + 1))
        words = [WORD_BANK[i] for i in rng.integers(0, len(WORD_BANK), n_words)]
        pieces = [gap]
        for w in words:
            pieces.append(_word_audio(w, sr))
            pieces.append(gap)
        wav = np.concatenate(pieces)
        noise = rng.standard_normal(len(wav)).astype(np.float32) * 0.01
        wav = np.clip(wav + noise, -1.0, 1.0)
        yield wav, sr, " ".join(words)
