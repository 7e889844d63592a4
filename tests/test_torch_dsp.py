"""The port's STFT/iSTFT against paa_tpu.ops.dsp (float32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops import dsp as jdsp
from paa_tpu_torch.ops import dsp as tdsp

# float32 FFTs of O(1) signals in another library: a few ulps of the
# largest bin
ATOL = 2e-4


@pytest.mark.parametrize("T, n_fft, hop, win", [
    (16000, 1024, 256, 1024),  # the attack's geometry
    (4001, 1024, 256, 1024),  # T not a multiple of hop
    (3000, 512, 160, 400),  # hop does not divide n_fft, shorter window
])
def test_stft_istft_match_jax(rng, T, n_fft, hop, win):
    x = rng.standard_normal((2, T)).astype(np.float32)
    want = np.asarray(jdsp.stft(jnp.asarray(x), n_fft, hop, win))
    got = tdsp.stft(torch.from_numpy(x), n_fft, hop, win).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, tdsp.num_frames(T, n_fft, hop))
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())

    back_j = np.asarray(jdsp.istft(jnp.asarray(want), n_fft, hop, win, length=T))
    back_t = tdsp.istft(torch.from_numpy(want), n_fft, hop, win, length=T).numpy()
    assert back_t.shape == (2, T)
    np.testing.assert_allclose(back_t, back_j, atol=1e-5)
    np.testing.assert_allclose(back_t, x, atol=1e-5)  # exact length round trip


def test_align_to_and_bin_freqs():
    x = torch.arange(6.0).reshape(1, 6)
    np.testing.assert_array_equal(tdsp.align_to(4, x).numpy(),
                                  np.asarray(jdsp.align_to(4, jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(tdsp.align_to(9, x).numpy(),
                                  np.asarray(jdsp.align_to(9, jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(tdsp.rfft_bin_freqs(1024, 16000),
                                  jdsp.rfft_bin_freqs(1024, 16000))
