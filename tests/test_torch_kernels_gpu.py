"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions on a
GPU, and the step's launch counts. Every test needs a CUDA device and skips
without one (the kernels have no CPU mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.ops import psycho
from paa_tpu_torch.ops.kernels import _lib, attention, fm_norm

# max |kernel − plain| / max(max |plain|, 0.1): bf16 outputs are stored in
# bf16 (relative step 2^-8); at T=1, dq = dk = 0 exactly
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    return float((a - b).float().abs().max() / max(b.float().abs().max(), 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, heads, d", [(1, 12, 64), (130, 12, 64), (499, 12, 64),
                                         (640, 12, 64), (130, 4, 16), (499, 16, 64)])
def test_attention_kernels_match_plain(cuda, dtype, T, heads, d):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v, do = ((torch.randn((2, T, heads * d), generator=g, device=cuda) * 0.5).to(dtype)
                   for _ in range(4))
    o, lse = attention.attention_fwd(q, k, v, heads)
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, heads)
    assert _rel(o, o_ref) <= TOL[dtype]
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    got = attention.attention_bwd(q, k, v, o, lse, do, heads)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, heads)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= TOL[dtype]


def test_attention_function_runs_both_kernels(cuda):
    q, k, v = (torch.randn((2, 50, 4, 16), device=cuda, requires_grad=True) for _ in range(3))
    _lib.reset_launches()
    attention.attention(q, k, v).sum().backward()
    assert _lib.launches["attention_fwd"] == 1 and _lib.launches["attention_bwd"] == 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.parametrize("shape", [(1, 513, 626), (2, 513, 130), (3, 1, 513, 7)])
def test_fm_kernel_matches_plain(cuda, shape):
    tables = psycho.build_tables(AttackConfig(), cuda)
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    spec = torch.complex(torch.randn(shape, generator=g, device=cuda) * 10,
                         torch.randn(shape, generator=g, device=cuda) * 10)
    got = fm_norm.fm_weighted_power_sum(spec, tables)
    want = fm_norm.fm_weighted_power_sum_plain(spec, tables)
    assert float((got - want).abs() / want) <= 1e-5
    # deterministic: the same input gives the same bits
    assert float(fm_norm.fm_weighted_power_sum(spec, tables)) == float(got)


def test_fm_projection_goes_through_the_kernel(cuda):
    """The fletcher_munson projection on the card launches K3 once and gives
    what the plain path gives on the CPU."""
    from paa_tpu_torch.ops import projections

    cfg = AttackConfig(norm_type="fletcher_munson")
    p = torch.randn((1, 16000), generator=torch.Generator().manual_seed(3)) * 0.05

    def project(x, dev):
        return projections.perturbation_constraint(
            x.to(dev), None, cfg, ConstraintParams.create(device=dev),
            psycho.build_tables(cfg, dev))

    _lib.reset_launches()
    got = project(p, cuda)
    assert _lib.launches["fm_norm"] == 1
    want = project(p, torch.device("cpu"))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((want - p).abs().max()) > 1e-3  # p lay outside the ball
