"""ISO 226 equal-loudness contours and the Fletcher-Munson weight table.

The benchmark's own frozen copy of the closed form (ISO 226:2003 over its
29 third-octave bands) and of the attack's perceptual weight
``(1 - SPL/SPL_max)²`` on a grid of phon levels 0, 10, ..., 90, pre-evaluated
at the STFT's bin frequencies. Its boundary choices are the attack's own:
the band table is extended to 20 kHz by repeating the 20 Hz entry, the
band parameters are interpolated with monotone PCHIP, and a bin outside
[20, 20000] Hz takes the weight 1.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import PchipInterpolator

FREQUENCIES = np.array([
    20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0,
    250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
    2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0, 12500.0,
])
ALPHA = np.array([
    0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349, 0.330,
    0.315, 0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250, 0.246, 0.244,
    0.243, 0.243, 0.243, 0.242, 0.242, 0.245, 0.254, 0.271, 0.301,
])
LU = np.array([
    -31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5,
    -3.1, -2.0, -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7,
    2.5, 1.2, -2.1, -7.1, -11.2, -10.7, -3.1,
])
TF = np.array([
    78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
    11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0, -5.4,
    -1.5, 6.0, 12.6, 13.9, 12.3,
])
F_MIN, F_MAX = 20.0, 20000.0


def _extended(values: np.ndarray) -> np.ndarray:
    return np.concatenate([values, values[:1]])


def spl(phon: float, freqs: np.ndarray) -> np.ndarray:
    """SPL in dB that sounds as loud as ``phon`` at each frequency."""
    grid = np.concatenate([FREQUENCIES, [F_MAX]])
    alpha = PchipInterpolator(grid, _extended(ALPHA))(freqs)
    lu = PchipInterpolator(grid, _extended(LU))(freqs)
    tf = PchipInterpolator(grid, _extended(TF))(freqs)
    a = 0.00447 * (10.0 ** (0.025 * phon) - 1.15)
    b = (0.4 * 10.0 ** ((tf + lu) / 10.0 - 9.0)) ** alpha
    return (10.0 / alpha) * np.log10(a + b) - lu + 94.0


def fm_table(bin_freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(table (10, F), in_domain (F,))``: the weight at phon level
    ``10·i`` and bin ``f``, linear in frequency between the grid's bands,
    and 1.0 where the bin lies in [20, 20000] Hz."""
    grid = np.concatenate([FREQUENCIES, [F_MAX]])
    levels = np.stack([spl(float(p), grid) for p in range(0, 100, 10)])
    weights = np.clip((1.0 - levels / levels.max()) ** 2, 0.0, 1.0)
    f = np.clip(np.asarray(bin_freqs, np.float64), grid[0], grid[-1])
    hi = np.clip(np.searchsorted(grid, f, side="left"), 1, len(grid) - 1)
    lo = hi - 1
    t = (f - grid[lo]) / (grid[hi] - grid[lo])
    table = weights[:, lo] * (1.0 - t) + weights[:, hi] * t
    in_domain = (bin_freqs >= F_MIN) & (bin_freqs <= F_MAX)
    return table, in_domain.astype(np.float64)
