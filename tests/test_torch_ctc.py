"""The port's CTC loss and decode helpers against paa_tpu.ops.ctc (float32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops import ctc as jctc
from paa_tpu.ops import text
from paa_tpu_torch.ops import ctc as tctc


def _case(rng, texts, frames):
    labels, pads = text.encode_batch(texts)
    logits = rng.standard_normal((len(texts), frames, text.VOCAB_SIZE)).astype(np.float32) * 2
    return logits, labels, pads


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_loss_matches_optax(rng, reduction):
    logits, labels, pads = _case(rng, ["hello world", "a", "the quick brown fox"], 49)
    want = np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(pads), reduction=reduction))
    got = tctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(pads), reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_infeasible_alignment_matches_optax(rng):
    """Targets longer than the clip: optax's log_epsilon gives a large finite
    loss where F.ctc_loss gives inf; the port returns optax's value and a
    finite gradient. Row 1 needs 5 labels + 1 blank between the two L's of
    'hello' = 6 frames > 5; row 0 fits."""
    logits, labels, pads = _case(rng, ["ab", "hello", "delete delete delete"], 5)
    want = np.asarray(jctc.ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(pads), reduction="none"))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(pads), reduction="none")
    assert np.all(np.isfinite(want)) and want[1] > 1e4 and want[2] > 1e4
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got.sum().backward()
    assert bool(torch.isfinite(x.grad).all())


def test_repeat_needs_a_blank():
    """'aa' needs 3 frames: feasible at 3, infeasible at 2."""
    labels, _ = text.encode_batch(["aa", "ab"])
    lengths = torch.tensor([2, 2])
    assert tctc._infeasible(torch.from_numpy(labels), lengths, 3).tolist() == [False, False]
    assert tctc._infeasible(torch.from_numpy(labels), lengths, 2).tolist() == [True, False]


def test_greedy_and_collapse_match(rng):
    logits = rng.standard_normal((2, 30, text.VOCAB_SIZE)).astype(np.float32)
    ids = tctc.greedy_ids(torch.from_numpy(logits))
    want = np.asarray(jctc.greedy_ids(jnp.asarray(logits)))
    np.testing.assert_array_equal(ids.numpy(), want)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(tctc.collapse_mask(ids).numpy(),
                                  np.asarray(jctc.collapse_mask(jnp.asarray(want))))
