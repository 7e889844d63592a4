"""The port's eight projections against paa_tpu.ops.projections (float32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.ops import projections as jproj
from paa_tpu.ops import psycho as jpsycho
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.ops import projections as tproj
from paa_tpu_torch.ops import psycho as tpsycho

T = 16000


@pytest.fixture(scope="module")
def tables():
    return tpsycho.build_tables(tcfg.AttackConfig()), jpsycho.build_tables(jcfg.AttackConfig())


# (norm, constraint, scale of p, whether p lies outside the set)
CASES = [
    ("l2", dict(l2_size=0.05), 0.01, True),
    ("l1", dict(l1_size=1.0), 0.01, True),
    ("linf", dict(linf_size=1e-3), 0.01, True),
    ("snr", dict(snr_db=30.0), 0.01, True),
    ("tv", dict(tv_epsilon=1e-3), 0.01, True),
    ("fletcher_munson", dict(fm_epsilon=2.0), 0.01, True),
    ("fletcher_munson", dict(fm_epsilon=1e6), 0.01, False),  # STFT round trip only
    ("min_max_freqs", dict(min_freq=120.0, max_freq=4000.0), 0.01, True),
    ("max_phon", dict(max_phon_level=20.0), 0.1, True),
    ("max_phon", dict(max_phon_level=57.5), 0.1, True),
]


@pytest.mark.parametrize("norm, kw, scale, acts", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_projection_matches_jax(rng, tables, norm, kw, scale, acts):
    t_tables, j_tables = tables
    p = (rng.standard_normal((1, T)) * scale).astype(np.float32)
    clean = (rng.standard_normal((3, T)) * 0.1).astype(np.float32)
    want = np.asarray(jproj.perturbation_constraint(
        jnp.asarray(p), jnp.asarray(clean), jcfg.AttackConfig(norm_type=norm),
        jcfg.ConstraintParams.create(**kw), j_tables))
    got = tproj.perturbation_constraint(
        torch.from_numpy(p), torch.from_numpy(clean), tcfg.AttackConfig(norm_type=norm),
        tcfg.ConstraintParams.create(**kw), t_tables).numpy()
    assert got.shape == want.shape == (1, T)
    assert (np.abs(want - p).max() > 1e-4 * scale) == acts
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_snr_and_tv_need_clean(tables):
    p = torch.zeros(1, 100)
    for norm in ("snr", "tv"):
        with pytest.raises(ValueError, match="clean"):
            tproj.perturbation_constraint(p, None, tcfg.AttackConfig(norm_type=norm),
                                          tcfg.ConstraintParams.create(), tables[0])
