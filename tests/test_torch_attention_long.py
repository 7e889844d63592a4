"""The port's attention against K4, the stock Pallas TPU flash attention that
paa_tpu's wav2vec2 runs on clips longer than 15.5 s
(``paa_tpu.models.wav2vec2._flash_attention``), in TPU interpret mode on the
CPU. The port runs K1/K2 at those lengths; here their plain version.

T = 200 and 300 pad to 256 and 384 inside K4, so its padded keys are really
masked (segment ids) and its padded query rows really sliced off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu_torch.ops.kernels import attention

HEADS = 2
RTOL = 1e-5  # float32 sums in another order, relative to the largest value


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("T", [200, 300])
@pytest.mark.parametrize("d", [16, 64])
def test_port_attention_matches_k4_values_and_grads(T, d):
    rng = np.random.default_rng(T + d)
    q, k, v, ct = (rng.standard_normal((1, T, HEADS, d)).astype(np.float32) for _ in range(4))
    q *= d**-0.5  # the model pre-scales q; K4 runs with sm_scale=1

    def k4_loss(q_, k_, v_):
        out = jw2v._flash_attention(q_, k_, v_, jnp.float32)
        return jnp.sum(out * ct), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grads = jax.value_and_grad(k4_loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = attention.attention(*leaves)
    (got * torch.from_numpy(ct)).sum().backward()

    assert got.shape == want.shape == (1, T, HEADS, d)
    assert _rel(got.detach().numpy(), np.asarray(want)) <= RTOL
    for name, leaf, w in zip("qkv", leaves, want_grads):
        assert _rel(leaf.grad.numpy(), np.asarray(w)) <= RTOL, name
