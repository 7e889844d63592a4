"""The port's host feed against paa_tpu.data.pipeline: the same corpus and
the same numpy generators give bit-identical splits and batches."""

import numpy as np
import pytest
import torch

from paa_tpu.data import datasets
from paa_tpu.data import pipeline as jpipe
from paa_tpu_torch.data import pipeline as tpipe


@pytest.fixture(scope="module")
def pipes():
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=48)
    return jpipe.build_pipeline(samples, seed=5), tpipe.build_pipeline(samples, seed=5)


def _same_batch(got: tpipe.Batch, want: jpipe.Batch) -> None:
    for name in ("audio", "labels", "label_paddings", "weights", "indices"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_splits_are_identical(pipes):
    jp, tp = pipes
    assert tp.audio_len == jp.audio_len
    for name in ("train", "eval", "test"):
        js, ts = getattr(jp, name), getattr(tp, name)
        assert ts.texts == js.texts
        np.testing.assert_array_equal(ts.labels, js.labels)
        np.testing.assert_array_equal(ts.label_paddings, js.label_paddings)
        assert len(ts.waveforms) == len(js.waveforms)
        for a, b in zip(ts.waveforms, js.waveforms):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split, shuffle_seed", [("train", (5, 0)), ("train", (5, 3)),
                                                 ("eval", None), ("test", None)])
def test_batches_are_bit_identical(pipes, split, shuffle_seed):
    """Shuffled and in-order batches of B=8 from the same numpy generator,
    the zero-weight padding rows of the last batch included."""
    jp, tp = pipes
    rng = lambda: None if shuffle_seed is None else np.random.default_rng(shuffle_seed)
    want = list(getattr(jp, split).batches(8, shuffle_rng=rng()))
    got = list(getattr(tp, split).batches(8, shuffle_rng=rng()))
    assert len(got) == len(want) == getattr(tp, split).num_batches(8)
    for g, w in zip(got, want):
        _same_batch(g, w)
        np.testing.assert_array_equal(tpipe.host_mask(g), jpipe.host_mask(w))
    last = got[-1]
    n_pad = int((last.weights == 0).sum())
    assert n_pad == -len(getattr(tp, split)) % 8
    if n_pad:
        pad = last.weights == 0
        assert (last.indices[pad] == -1).all() and not last.audio[pad].any()


def test_drop_remainder_matches(pipes):
    jp, tp = pipes
    want = list(jp.train.batches(8, np.random.default_rng(1), drop_remainder=True))
    got = list(tp.train.batches(8, np.random.default_rng(1), drop_remainder=True))
    assert len(got) == len(want) == len(tp.train) // 8
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_to_device_copies_every_array(pipes):
    """On the CPU the copy is a plain one; the host keeps the weights for
    the row mask."""
    _, tp = pipes
    host = next(tp.test.batches(8))
    dev = tpipe.to_device(host, torch.device("cpu"))
    for name in ("audio", "labels", "label_paddings", "weights"):
        t = getattr(dev, name)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), getattr(host, name))
    np.testing.assert_array_equal(dev.indices, host.indices)
    np.testing.assert_array_equal(tpipe.host_mask(dev), host.weights > 0)


def test_too_few_samples_raises():
    samples = datasets.load_dataset_tuples("synthetic", synthetic_samples=3)
    with pytest.raises(ValueError, match="Too few samples"):
        tpipe.build_pipeline(samples)
