"""Fletcher-Munson weighted power kernel K3, and its plain version.

Port of ``paa_tpu/ops/pallas/fm_norm.py``: ``Σ w·|X|²`` over every cell of
an STFT ``(..., F, T)``, with the per-cell weight of
``paa_tpu_torch.ops.psycho.fm_cell_weights``. The CUDA source is
``csrc/fm_norm.cu``. The wrapper runs the kernel on a CUDA tensor and the
plain version on a CPU tensor; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from paa_tpu_torch.ops import psycho
from paa_tpu_torch.ops.kernels import _lib
from paa_tpu_torch.ops.psycho import PsychoTables


def fm_weighted_power_sum_plain(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """Plain version of K3: a float32 scalar, power = re² + im²."""
    x = torch.view_as_real(stft_p)
    power = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
    return torch.sum(psycho.fm_cell_weights(power, tables) * power)


def fm_weighted_power_sum(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """K3: ``Σ w·|X|²`` of a complex64 ``(..., F, T)`` STFT, a float32 scalar
    (plain version on CPU). Leading axes are flattened into one batch axis."""
    if not stft_p.is_cuda:
        return fm_weighted_power_sum_plain(stft_p, tables)
    if stft_p.dtype != torch.complex64 or stft_p.dim() < 2:
        raise ValueError(f"fm_weighted_power_sum: expected complex64 (..., F, T), got "
                         f"{stft_p.dtype} {tuple(stft_p.shape)}")
    F, T = stft_p.shape[-2:]
    table, dom = tables.fm_table, tables.fm_in_domain
    if table.shape != (10, F) or dom.shape != (F,):
        raise ValueError(f"fm_weighted_power_sum: tables do not match F={F}")
    for t in (table, dom):
        if t.device != stft_p.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fm_weighted_power_sum: tables must be contiguous float32 "
                             "on the STFT's device")
    x = torch.view_as_real(stft_p.reshape(-1, F, T).contiguous())
    B = x.shape[0]
    lib = _lib.library()
    partials = torch.empty(lib.paa_fm_num_partials(B, F, T), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.paa_fm_power_sum(
            x.data_ptr(), table.data_ptr(), dom.data_ptr(), partials.data_ptr(),
            out.data_ptr(), B, F, T, stream,
        )
    _lib.check(status, "fm_weighted_power_sum")
    _lib.launches["fm_norm"] += 1
    return out


def fm_weighted_norm(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """Fletcher-Munson weighted norm ``sqrt(Σ w·|X|²)`` through K3."""
    return torch.sqrt(fm_weighted_power_sum(stft_p, tables))
