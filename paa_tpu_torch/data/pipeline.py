"""Batching pipeline: length filter, splits, fixed-shape collate, and the
copy of each batch to the device.

The port's copy of the host feed of ``paa_tpu/data/pipeline.py:35-237``
(that module imports JAX). The numpy code is the same, so batches and their
shuffles, drawn from the same numpy generators, are bit-identical to the JAX
feed's (a test compares them):

  * length statistics from the first 300 samples; lengths kept within the
    [q10, q(relative_audio_length)] window;
  * every waveform cropped or zero-padded to the window's upper quantile,
    so all batches have one shape;
  * a deterministic shuffle and an 80/10/10 train/eval/test split;
  * labels tokenized once per split; the last partial batch padded to the
    batch shape with weight-0 rows.

:func:`to_device` copies a host batch to the card through pinned memory
with a non-blocking copy. Under data parallelism the feed stays global and
bit-exact on every rank; :func:`shard_rows` gives a rank its rows. The device-resident corpora of the JAX package
(``DeviceCorpus``, ``CachedCorpus``) are not ported yet (ROADMAP.md,
queue 1: DeviceCorpus and CachedCorpus).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from paa_tpu_torch.ops import text as text_ops


class Batch(NamedTuple):
    audio: np.ndarray  # (B, T) float32
    labels: np.ndarray  # (B, L) int32
    label_paddings: np.ndarray  # (B, L) float32
    weights: np.ndarray  # (B,) float32 — 0.0 on padding rows
    indices: np.ndarray  # (B,) int32 — row index into the split (−1 pad)
    # set by to_device: the host copy of the weights, so that a loop builds
    # row masks without reading the device
    host_weights: np.ndarray | None = None


def host_mask(batch: Batch) -> np.ndarray:
    """Boolean valid-row mask from the host copy of the weights."""
    w = batch.host_weights if batch.host_weights is not None else batch.weights
    return np.asarray(w) > 0


def to_device(batch: Batch, device: torch.device) -> Batch:
    """The batch's arrays as tensors on ``device``: on a CUDA device through
    pinned host memory with a non-blocking copy, so that the copy overlaps
    the work already queued on the card."""

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return Batch(put(batch.audio), put(batch.labels), put(batch.label_paddings),
                 put(batch.weights), batch.indices, host_weights=np.asarray(batch.weights))


def shard_rows(x, n: int, r: int):
    """Rows ``[r·B/n, (r+1)·B/n)`` of ``x`` (a numpy array or a tensor with
    the batch first): rank ``r``'s share of a batch on an ``n``-way data
    axis."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} data ranks")
    b = B // n
    return x[r * b:(r + 1) * b]


@dataclasses.dataclass
class Split:
    """One data split: variable-length waveforms + pre-tokenized labels."""

    waveforms: list  # list[np.ndarray (Ti,)]
    texts: list  # cleaned transcripts
    labels: np.ndarray  # (N, L) int32
    label_paddings: np.ndarray  # (N, L) float32
    audio_len: int

    def __len__(self):
        return len(self.waveforms)

    def collate(self, idx: Sequence[int], batch_size: int) -> Batch:
        """Fixed-shape batch from rows ``idx`` (padded to batch_size)."""
        B, T = batch_size, self.audio_len
        audio = np.zeros((B, T), dtype=np.float32)
        weights = np.zeros((B,), dtype=np.float32)
        rows = np.full((B,), -1, dtype=np.int32)
        L = self.labels.shape[1]
        labels = np.full((B, L), text_ops.PAD_ID, dtype=np.int32)
        paddings = np.ones((B, L), dtype=np.float32)
        for j, i in enumerate(idx):
            w = self.waveforms[i]
            n = min(len(w), T)  # crop or zero-pad
            audio[j, :n] = w[:n]
            labels[j] = self.labels[i]
            paddings[j] = self.label_paddings[i]
            weights[j] = 1.0
            rows[j] = i
        return Batch(audio, labels, paddings, weights, rows)

    def batches(
        self,
        batch_size: int,
        shuffle_rng: np.random.Generator | None = None,
        drop_remainder: bool = False,
    ) -> Iterator[Batch]:
        for rows in _batch_rows(len(self), batch_size, shuffle_rng, drop_remainder):
            yield self.collate(rows[rows >= 0], batch_size)

    def num_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)


def _batch_rows(
    n: int,
    batch_size: int,
    shuffle_rng: np.random.Generator | None = None,
    drop_remainder: bool = False,
) -> Iterator[np.ndarray]:
    """Yield ``(batch_size,)`` int32 row vectors (−1 = padding row) over a
    length-``n`` split: the order, shuffle and remainder rules of the feed."""
    order = np.arange(n)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)
    for start in range(0, n, batch_size):
        chunk = order[start : start + batch_size]
        if len(chunk) < batch_size and drop_remainder:
            return
        rows = np.full((batch_size,), -1, dtype=np.int32)
        rows[: len(chunk)] = chunk
        yield rows


class DataPipeline(NamedTuple):
    train: Split
    eval: Split
    test: Split
    audio_len: int


def _make_split(samples: list, texts: list[str], audio_len: int, label_len: int) -> Split:
    labels, paddings = text_ops.encode_batch(texts, pad_to=label_len)
    return Split(
        waveforms=[np.asarray(w, dtype=np.float32).reshape(-1) for (w, _, _) in samples],
        texts=texts,
        labels=labels,
        label_paddings=paddings,
        audio_len=audio_len,
    )


def _to_target_sr(w, sr: int, target_sr: int):
    """Polyphase-resample one waveform to ``target_sr`` (no-op if equal)."""
    if sr == target_sr or sr <= 0:
        return w
    from scipy.signal import resample_poly

    g = math.gcd(int(sr), int(target_sr))
    return resample_poly(
        np.asarray(w, np.float32).reshape(-1), target_sr // g, sr // g
    ).astype(np.float32)


def build_pipeline(
    samples: list,
    relative_audio_length: float = 0.80,
    seed: int = 5,
    target_size: int | None = None,
    target_sr: int = 16000,
) -> DataPipeline:
    """Length-filter, split and pre-tokenize a materialized corpus of
    ``(waveform, sample_rate, transcript)`` tuples."""
    samples = [(_to_target_sr(w, sr, target_sr), target_sr, t) for (w, sr, t) in samples]
    lengths = np.asarray(
        [len(np.asarray(w).reshape(-1)) for (w, _, _) in samples[: min(300, len(samples))]],
        dtype=np.float64,
    )
    min_len = int(np.quantile(lengths, 0.10))
    audio_len = int(np.quantile(lengths, relative_audio_length))

    kept = [
        s
        for s in samples
        if min_len <= len(np.asarray(s[0]).reshape(-1)) <= audio_len
    ]
    if target_size is not None:
        kept = kept[:target_size]
    if len(kept) < 3:
        raise ValueError(
            f"Too few samples after length filtering ({len(kept)}); "
            f"window=[{min_len}, {audio_len}]"
        )

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(kept))
    kept = [kept[i] for i in order]

    # 80/10/10 with int-floor sizes, but never an empty eval or test split
    n_train = int(0.8 * len(kept))
    n_eval = int(0.1 * len(kept))
    if n_eval == 0:
        n_eval = 1
        n_train = len(kept) - 2  # leaves exactly one test sample
    groups = {
        "train": kept[:n_train],
        "eval": kept[n_train : n_train + n_eval],
        "test": kept[n_train + n_eval :],
    }
    if not all(groups.values()):
        raise ValueError(f"an empty split: { {k: len(v) for k, v in groups.items()} }")
    # one label width for every split, so that every eval batch has one shape
    all_texts = text_ops.clean_transcripts([t for (_, _, t) in kept])
    label_len = max((len(text_ops.encode(t)) for t in all_texts), default=1)
    text_groups = {
        "train": all_texts[:n_train],
        "eval": all_texts[n_train : n_train + n_eval],
        "test": all_texts[n_train + n_eval :],
    }

    return DataPipeline(
        train=_make_split(groups["train"], text_groups["train"], audio_len, label_len),
        eval=_make_split(groups["eval"], text_groups["eval"], audio_len, label_len),
        test=_make_split(groups["test"], text_groups["test"], audio_len, label_len),
        audio_len=audio_len,
    )
