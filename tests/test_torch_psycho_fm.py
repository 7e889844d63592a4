"""The port's psychoacoustic weights and the plain version of kernel K3
against paa_tpu (jnp reference and the Pallas kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import AttackConfig as JConfig
from paa_tpu.ops import dsp as jdsp
from paa_tpu.ops import psycho as jpsycho
from paa_tpu.ops.pallas import fm_norm as jfm
from paa_tpu_torch.config import AttackConfig
from paa_tpu_torch.ops import psycho
from paa_tpu_torch.ops.kernels import fm_norm

RTOL = 1e-5  # float32 sums of positive terms, in another order


@pytest.fixture(scope="module")
def tables():
    return psycho.build_tables(AttackConfig()), jpsycho.build_tables(JConfig())


def test_tables_match(tables):
    t, j = tables
    for name in t._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("phon", [0.0, 20.0, 37.25, 90.0, 120.0])
def test_phon_contour_matches(tables, phon):
    t, j = tables
    got = psycho.phon_contour(t, torch.tensor(phon)).numpy()
    want = np.asarray(jpsycho.phon_contour(j, jnp.float32(phon)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _edge_planes():
    """(re, im) of a (1, 513, 130) STFT with power 0, SPL exactly 0
    (power 1) and SPL exactly 90 (power 1e9 = 1200² + 31600²)."""
    re = np.zeros((1, 513, 130), np.float32)
    im = np.zeros_like(re)
    re[0, 10:200, 5:60] = 1.0
    re[0, 200:400, 60:120] = 1200.0
    im[0, 200:400, 60:120] = 31600.0
    re[0, 0, :] = 1.0  # 0 Hz lies outside [20, 20000]
    return re, im


@pytest.mark.parametrize("case", ["random", "edges"])
def test_plain_fm_power_sum_matches_pallas_and_jnp(rng, tables, case):
    t, j = tables
    if case == "random":
        # powers in and out of the phon domain, T not a multiple of 128
        re = rng.standard_normal((2, 513, 130)).astype(np.float32) * 10
        im = rng.standard_normal((2, 513, 130)).astype(np.float32) * 10
    else:
        re, im = _edge_planes()
    got = float(fm_norm.fm_weighted_power_sum(torch.complex(torch.from_numpy(re),
                                                            torch.from_numpy(im)), t))
    pallas = float(jfm.fm_weighted_power_sum(jnp.asarray(re), jnp.asarray(im), j.fm_table,
                                             j.fm_in_domain, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL)
    if case == "edges":
        # jnp.log10 on XLA's CPU rounds 10·log10(1e9) to 90.00001, one ulp
        # above the domain, where the Pallas kernel's log·(1/ln 10) and
        # torch.log10 give 90.0: the jnp reference is held on the other edges
        re[0, 200:400, 60:120] = 0.0
        im[0, 200:400, 60:120] = 0.0
        got = float(fm_norm.fm_weighted_power_sum(torch.complex(torch.from_numpy(re),
                                                                torch.from_numpy(im)), t))
    power = jnp.asarray(re**2 + im**2)
    jnp_ref = float(jnp.sum(jpsycho.fm_cell_weights(power, j) * power))
    np.testing.assert_allclose(got, jnp_ref, rtol=RTOL)


def test_cell_weights_match_at_the_domain_edges(tables):
    t, j = tables
    re, im = _edge_planes()
    power = re**2 + im**2
    got = psycho.fm_cell_weights(torch.from_numpy(power), t).numpy()
    want = np.array(jpsycho.fm_cell_weights(jnp.asarray(power), j))
    spl90 = (slice(None), slice(200, 400), slice(60, 120))
    want[spl90] = got[spl90]  # the one-ulp log10 edge, pinned below
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # SPL exactly 0 and exactly 90 lie inside the closed domain [0, 90];
    # power 0 (SPL −100) and the 0 Hz bin lie outside it
    np.testing.assert_allclose(got[0, 100, 10], t.fm_table[0, 100].item(), rtol=1e-6)
    np.testing.assert_allclose(got[0, 300, 100], t.fm_table[9, 300].item(), rtol=1e-6)
    assert got[0, 100, 100] == 1.0 and got[0, 0, 10] == 1.0


def test_fm_weighted_norm_matches_on_a_real_stft(rng, tables):
    t, j = tables
    cfg = AttackConfig()
    p = rng.standard_normal((1, 16000)).astype(np.float32)
    spec = jdsp.stft(jnp.asarray(p), cfg.n_fft, cfg.hop_length, cfg.win_length)
    want = float(jpsycho.fm_weighted_norm(spec, j))
    spec_t = torch.from_numpy(np.asarray(spec))
    np.testing.assert_allclose(float(psycho.fm_weighted_norm(spec_t, t)), want, rtol=RTOL)
    np.testing.assert_allclose(float(fm_norm.fm_weighted_norm(spec_t, t)), want, rtol=RTOL)
