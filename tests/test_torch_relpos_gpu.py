"""Kernel K8 (the relative-position attention, ``csrc/attention_relpos_sm90.cu``)
against its plain PyTorch version on a GPU, at ragged lengths and at the
benchmark cells' microbatches; its bits on a repeat; its launch counters.
Every test needs a CUDA device and skips without one (the kernel has no CPU
mode).

The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_relpos_gpu.py
"""

import pytest
import torch

from paa_tpu_torch.ops.kernels import _lib, attention

# max |kernel − plain| / max(max |plain|, 0.1): bf16 outputs are stored in
# bf16 (relative step 2^-8), as K1/K2's
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paa_tpu_torch import runtime

    return runtime.require_cuda()


def _rel(a, b):
    return float((a - b).float().abs().max() / max(b.float().abs().max(), 0.1))


def _inputs(dev, B, T, H, seed=0):
    """qu, qv at about the scale of (q + u)/√d, k, v, P and do about 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda rows, scale: (torch.randn((*rows, H * 64), generator=g, device=dev)
                             * scale).to(torch.bfloat16)
    return (r((B, T), 0.125), r((B, T), 0.125), r((B, T), 1.0), r((B, T), 1.0),
            r((2 * T - 1,), 1.0), r((B, T), 1.0))


@pytest.mark.parametrize("B, T, H", [(2, 1, 2), (2, 7, 2), (2, 65, 2), (2, 130, 2),
                                     (3, 200, 4), (16, 1499, 16), (32, 999, 16)])
def test_k8_matches_plain_and_repeats_its_bits(cuda, B, T, H):
    qu, qv, k, v, pos, do = _inputs(cuda, B, T, H, seed=T)
    o, lse = attention.attention_relpos_fwd(qu, qv, k, v, pos, H)
    o_ref, lse_ref = attention.attention_relpos_fwd_plain(qu, qv, k, v, pos, H)
    assert _rel(o, o_ref) <= TOL
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    del o_ref, lse_ref
    got = attention.attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H)
    want = attention.attention_relpos_bwd_plain(qu, qv, k, v, pos, o, lse, do, H)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and _rel(a, b) <= TOL
    del want
    o2, lse2 = attention.attention_relpos_fwd(qu, qv, k, v, pos, H)
    again = attention.attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k8_launch_counters(cuda):
    qu, qv, k, v, pos, do = _inputs(cuda, 2, 130, 2)
    for t in (qu, qv, k, v):
        t.requires_grad_(True)
    _lib.reset_launches()
    out = attention.attention_relpos(qu, qv, k, v, pos, 2)
    assert _lib.launches["attention_relpos_fwd"] == 1 and _lib.launches["attention_relpos_bwd"] == 0
    out.backward(do)
    assert _lib.launches["attention_relpos_fwd"] == 1 and _lib.launches["attention_relpos_bwd"] == 1
    assert _lib.launches["attention_fwd_sm90"] == _lib.launches["attention_bwd_sm90"] == 0
    with pytest.raises(ValueError, match="bfloat16 with head dim 64"):
        attention.attention_relpos_fwd(qu.float(), qv.float(), k.float(), v.float(),
                                       pos.float(), 2)


def test_relative_conformer_launches_k8_once_a_layer_each_way(cuda):
    """The preset at two layers, bf16 as served: one forward and one
    backward of K8 a layer, no K1/K2, one P a layer for the frame count."""
    from paa_tpu_torch.models import presets
    from paa_tpu_torch.models import wav2vec2_conformer as conformer

    cfg = presets.get_config("wav2vec2-conformer-rel-pos-large", num_hidden_layers=2)
    model = presets.init_model(cfg).cast_param_storage(torch.bfloat16).to(cuda)
    audio = torch.randn((2, 32000), device=cuda, requires_grad=True)
    conformer.reset_counts()
    _lib.reset_launches()
    model(audio).float().sum().backward()
    assert _lib.launches["attention_relpos_fwd"] == _lib.launches["attention_relpos_bwd"] == 2
    assert _lib.launches["attention_fwd_sm90"] == _lib.launches["attention_bwd_sm90"] == 0
    assert _lib.launches["attention_fwd"] == _lib.launches["attention_bwd"] == 0
    assert conformer.counts["relpos_tables"] == 2
    assert audio.grad is not None and bool(torch.isfinite(audio.grad).all())
