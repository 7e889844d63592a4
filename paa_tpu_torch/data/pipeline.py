"""Batching pipeline: length filter, splits, fixed-shape collate, and the
two feeds that bring batches to the device.

The port of ``paa_tpu/data/pipeline.py`` (that module imports JAX). The
numpy code is the same, so batches and their shuffles, drawn from the same
numpy generators, are bit-identical to the JAX feed's (a test compares them):

  * length statistics from the first 300 samples; lengths kept within the
    [q10, q(relative_audio_length)] window;
  * every waveform cropped or zero-padded to the window's upper quantile,
    so all batches have one shape;
  * a deterministic shuffle and an 80/10/10 train/eval/test split;
  * labels tokenized once per split; the last partial batch padded to the
    batch shape with weight-0 rows.

The host feed collates each batch on the host and :func:`to_device` copies
it to the card through pinned memory with a non-blocking copy
(:func:`prefetch_to_device` keeps two batches in flight). The device feed
stages a split on the card once and forms each batch there by gather
(:class:`DeviceCorpus`, or :class:`CachedCorpus` when only the first rows fit
the budget); :class:`CorpusCache` resolves the ``cache_data_on_device``
tri-state per split. The device feed pads a short final batch with copies of
row 0, the host feed with zero rows, as in the JAX package: both carry weight
0, but snr and tv size their ball from the whole clean batch, so the two
feeds end an epoch on different p for those norms.

Under data parallelism every rank feeds the same global batches, bit-exact,
and :func:`shard_rows` gives a rank its rows. The JAX package shards the
staged corpus over the mesh's ``data`` axis and lets XLA insert the gather
collectives; here every rank stages the whole split (or its cache) on its
own card and gathers the global batch, which needs no collective per step.
The batches are the same; only the memory differs.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from paa_tpu_torch.ops import text as text_ops

logger = logging.getLogger("paa_tpu")

# Host→device traffic of the feeds since the last reset_h2d(): bytes and
# copies. Counted on the CPU too, where the copy is a no-op.
h2d = {"bytes": 0, "copies": 0}


def reset_h2d() -> None:
    h2d.update(bytes=0, copies=0)


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


def _host(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A zeroed host buffer for a copy to ``device``: pinned for a CUDA
    device."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _put(a, device: torch.device) -> torch.Tensor:
    """``a`` (a numpy array or a host tensor) on ``device``: on a CUDA device
    through pinned host memory with a non-blocking copy, so that the copy
    overlaps the work already queued on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    h2d["bytes"] += t.nbytes
    h2d["copies"] += 1
    if device.type == "cuda":
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def to_device(batch: Batch, device: torch.device) -> Batch:
    """The batch's arrays as tensors on ``device`` (see :func:`_put`); the
    weights stay on the host too, as ``host_weights``."""
    return Batch(_put(batch.audio, device), _put(batch.labels, device),
                 _put(batch.label_paddings, device), _put(batch.weights, device),
                 batch.indices, host_weights=np.asarray(batch.weights))


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


def row_bytes(split: Split) -> int:
    """Bytes a staged row takes: its audio, labels and label paddings."""
    L = split.labels.shape[1]
    return split.audio_len * 4 + split.labels.itemsize * L + 4 * L


def _fill_audio(split: Split, rows, out: np.ndarray) -> np.ndarray:
    """Rows ``rows`` of the split's audio into ``out``, each cropped or
    zero-padded to the clip length, as :meth:`Split.collate` does."""
    T = split.audio_len
    for j, i in enumerate(rows):
        w = split.waveforms[i]
        n = min(len(w), T)
        out[j, :n] = w[:n]
    return out


def _stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A staged array on ``device``: one blocking copy from pageable memory
    (pinning a corpus-sized buffer costs more than it saves, once)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _gather_rows(audio, labels, pads, rows):
    """A batch from the staged rows: a padding row (−1) gathers row 0 and
    weighs 0."""
    safe = rows.clamp(min=0)
    return (audio.index_select(0, safe), labels.index_select(0, safe),
            pads.index_select(0, safe), (rows >= 0).to(torch.float32))


class DeviceCorpus:
    """A split staged on the device once; batches form there by gather.

    Each batch then moves only a ``(B,)`` int32 row vector to the device,
    through pinned memory, instead of its ``(B, T)`` audio. Padding rows of
    a short final batch gather row 0 with weight 0, as the JAX package's
    ``_gather_rows_fn`` does: the step's loss and metrics are weighted, so
    they contribute nothing there, but snr and tv size their ball from the
    whole clean batch, row 0's copies included.

    ``mesh`` changes nothing in what is staged: every rank of a data axis
    stages the whole split and gathers the global batch, and the sharded
    steps take their rows of it (module docstring).
    """

    def __init__(self, split: Split, device: torch.device, mesh=None):
        N, T = len(split), split.audio_len
        self.split, self.device, self.mesh = split, device, mesh
        self.audio = _stage(_fill_audio(split, range(N), np.zeros((N, T), np.float32)), device)
        self.labels = _stage(split.labels, device)
        self.label_paddings = _stage(split.label_paddings, device)
        self.staged_bytes = sum(t.nbytes for t in (self.audio, self.labels,
                                                   self.label_paddings))

    @staticmethod
    def nbytes(split: Split) -> int:
        return (len(split) * split.audio_len * 4 + split.labels.nbytes
                + split.label_paddings.nbytes)

    def batches(self, batch_size: int, shuffle_rng: np.random.Generator | None = None,
                drop_remainder: bool = False) -> Iterator[Batch]:
        for rows in _batch_rows(len(self.split), batch_size, shuffle_rng, drop_remainder):
            audio, labels, pads, weights = _gather_rows(
                self.audio, self.labels, self.label_paddings, _put(rows, self.device))
            yield Batch(audio, labels, pads, weights, rows, (rows >= 0).astype(np.float32))


class CachedCorpus:
    """The device feed for a split past the resident budget: the first ``C``
    rows (all that ``cache_bytes`` holds, at least one) stay on the device,
    and each batch copies only its rows past them, one batch ahead, through
    pinned memory with non-blocking copies.

    The device assembles each batch from two gathers and a select, as the
    JAX package's ``_combine_cached_fn`` does, so its batches equal
    :class:`DeviceCorpus`'s bit for bit, padding rows included: a ``-1``
    row selects cache row 0. A batch whose rows are all resident reuses one
    staged one-row buffer, so a fully resident epoch moves no audio bytes.
    The JAX package pads each miss buffer to a multiple of ``MISS_BUCKET``
    rows to bound the number of XLA programs; eager PyTorch compiles none,
    so here a miss buffer holds the batch's missing rows and no more.

    ``mesh`` changes nothing in what is staged (see :class:`DeviceCorpus`).
    """

    def __init__(self, split: Split, cache_bytes: int, device: torch.device, mesh=None):
        N, T = len(split), split.audio_len
        C = max(1, min(N, int(cache_bytes) // row_bytes(split)))
        self.split, self.device, self.mesh, self.n_cached = split, device, mesh, C
        self.audio = _stage(_fill_audio(split, range(C), np.zeros((C, T), np.float32)), device)
        self.labels = _stage(split.labels[:C], device)
        self.label_paddings = _stage(split.label_paddings[:C], device)
        self.staged_bytes = sum(t.nbytes for t in (self.audio, self.labels,
                                                   self.label_paddings))
        self._zero_miss = None  # staged once, reused for all-hit batches

    def _stage_miss(self, rows: np.ndarray) -> tuple:
        """Batch ``rows``' miss buffer on the device, its (3, B) index
        vectors (rows, cache rows, miss rows) on the device, and ``rows``."""
        split, C, dev = self.split, self.n_cached, self.device
        use_miss = rows >= C
        miss_rows = rows[use_miss]
        m = len(miss_rows)
        index = _host((3, len(rows)), torch.int32, dev)
        idx = index.numpy()
        idx[0] = rows
        idx[1] = np.where(use_miss, 0, np.maximum(rows, 0))
        idx[2][use_miss] = np.arange(m, dtype=np.int32)
        if m == 0:
            if self._zero_miss is None:
                L = split.labels.shape[1]
                self._zero_miss = (_put(np.zeros((1, split.audio_len), np.float32), dev),
                                   _put(np.zeros((1, L), split.labels.dtype), dev),
                                   _put(np.ones((1, L), np.float32), dev))
            miss = self._zero_miss
        else:
            audio = _host((m, split.audio_len), torch.float32, dev)
            _fill_audio(split, miss_rows, audio.numpy())
            miss = (_put(audio, dev), _put(split.labels[miss_rows], dev),
                    _put(split.label_paddings[miss_rows], dev))
        return miss, _put(index, dev), rows

    def _combine(self, miss, index) -> tuple:
        rows, sel_cache, sel_miss = index
        use_miss = (rows >= self.n_cached)[:, None]
        pick = lambda cached, missed: torch.where(
            use_miss, missed.index_select(0, sel_miss), cached.index_select(0, sel_cache))
        return (pick(self.audio, miss[0]), pick(self.labels, miss[1]),
                pick(self.label_paddings, miss[2]), (rows >= 0).to(torch.float32))

    def batches(self, batch_size: int, shuffle_rng: np.random.Generator | None = None,
                drop_remainder: bool = False) -> Iterator[Batch]:
        queue = collections.deque()

        def emit(staged) -> Batch:
            miss, index, rows = staged
            audio, labels, pads, weights = self._combine(miss, index)
            return Batch(audio, labels, pads, weights, rows, (rows >= 0).astype(np.float32))

        for rows in _batch_rows(len(self.split), batch_size, shuffle_rng, drop_remainder):
            queue.append(self._stage_miss(rows))
            if len(queue) >= 2:
                yield emit(queue.popleft())
        while queue:
            yield emit(queue.popleft())


_DEVICE_CACHE_AUTO_LIMIT = 512 << 20  # bytes per device


def device_feed_kind(split: Split, enable: bool | None, device: torch.device) -> str | None:
    """The ``cache_data_on_device`` tri-state for one split: ``"device"``
    (:class:`DeviceCorpus`), ``"cached"`` (:class:`CachedCorpus` at the
    auto budget) or None (the host feed).

    ``False`` keeps the host feed; ``True`` stages the whole split on any
    device. ``None`` (auto) is the JAX package's rule with its TPU read as
    CUDA: on a CUDA device the whole split when it stages in at most
    ``_DEVICE_CACHE_AUTO_LIMIT`` bytes, else the rows that budget holds; on
    the CPU the host feed. The JAX package divides the split over its data
    axis before the comparison; here every rank stages the whole split, so
    its share per device is the whole split."""
    if enable is False:
        return None
    if enable is None:
        if device.type != "cuda":
            return None
        if DeviceCorpus.nbytes(split) > _DEVICE_CACHE_AUTO_LIMIT:
            return "cached"
    return "device"


def maybe_device_corpus(split: Split, enable: bool | None, device: torch.device,
                        mesh=None) -> DeviceCorpus | CachedCorpus | None:
    """The split staged as :func:`device_feed_kind` decides, or None for the
    host feed. A staging that fails raises: no feed falls back to the host."""
    kind = device_feed_kind(split, enable, device)
    if kind == "cached":
        return CachedCorpus(split, _DEVICE_CACHE_AUTO_LIMIT, device, mesh=mesh)
    if kind == "device":
        return DeviceCorpus(split, device, mesh=mesh)
    return None


def batch_source(split: Split, batch_size: int, corpus: DeviceCorpus | CachedCorpus | None,
                 device: torch.device,
                 shuffle_rng: np.random.Generator | None = None) -> Iterator[Batch]:
    """Batches gathered on the device when a corpus is staged, else host
    collate and prefetch: one call site for both feeds."""
    if corpus is not None:
        return corpus.batches(batch_size, shuffle_rng=shuffle_rng)
    return prefetch_to_device(split.batches(batch_size, shuffle_rng=shuffle_rng), device)


class CorpusCache:
    """Stages each split once under the ``cache_data_on_device`` tri-state,
    at its first use, keyed by the split's identity: the one home of the
    policy and its log lines for the single run (train/loop.py) and the
    sweep (cli/sweep.py)."""

    def __init__(self, enable: bool | None, device: torch.device, mesh=None):
        self._enable, self._device, self._mesh = enable, device, mesh
        self._corpora: dict[int, tuple] = {}  # id(split) → (split, its corpus or None)

    def corpus(self, split: Split) -> DeviceCorpus | CachedCorpus | None:
        key = id(split)
        if key not in self._corpora:
            c = maybe_device_corpus(split, self._enable, self._device, mesh=self._mesh)
            if isinstance(c, CachedCorpus):
                logger.info(
                    "split exceeds the resident-HBM budget (%d clips, %.0f MB) "
                    "— caching the first %d rows on device (%.0f%%), host-"
                    "filling only the overflow per batch",
                    len(split), DeviceCorpus.nbytes(split) / 1e6,
                    c.n_cached, 100.0 * c.n_cached / len(split))
            elif c is not None:
                logger.info(
                    "staged split to device HBM: %d clips, %.0f MB — batches "
                    "now form by on-device gather",
                    len(split), DeviceCorpus.nbytes(split) / 1e6)
            self._corpora[key] = (split, c)
        return self._corpora[key][1]

    def batches(self, split: Split, batch_size: int,
                shuffle_rng: np.random.Generator | None = None) -> Iterator[Batch]:
        return batch_source(split, batch_size, self.corpus(split), self._device,
                            shuffle_rng=shuffle_rng)


def prefetch_to_device(iterator: Iterator[Batch], device: torch.device,
                       size: int = 2) -> Iterator[Batch]:
    """Host batches on ``device`` (:func:`to_device`), copied ``size - 1``
    batches ahead of the one consumed, so that a batch's copy is queued
    while the host still collates the next; ``host_weights`` keeps the
    weights on the host."""
    queue = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
