"""Fletcher-Munson weighted power kernel K3, and its plain version.

Port of ``paa_tpu/ops/pallas/fm_norm.py``: ``Σ w·|X|²`` over every cell of
an STFT ``(..., F, T)``, with the per-cell weight of
``paa_tpu_torch.ops.psycho.fm_cell_weights``. The CUDA source is
``csrc/fm_norm.cu``: one launch that reads the STFT in place. The wrapper
runs the kernel on a CUDA tensor and the plain version on a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
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


THREADS = 512  # a block; the grid is one block per SM at most

# device index → (partials, ticket, SM count): the kernel's scratch, made
# once per device and reused by every call
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}


def _scratch_for(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, int]:
    found = _scratch.get(device.index)
    if found is None:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        found = (torch.zeros(n_sm, dtype=torch.float32, device=device),
                 torch.zeros(1, dtype=torch.int32, device=device), n_sm)
        _scratch[device.index] = found
    return found


def fm_weighted_power_sum(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """K3: ``Σ w·|X|²`` of a complex64 ``(..., F, T)`` STFT, a fresh float32
    scalar (plain version on CPU). Leading axes are flattened into one batch
    axis.

    On the card it is one kernel launch that reads the STFT where it lies,
    at its strides (``torch.stft``'s frames-major layout as it comes); only
    leading axes that cannot be flattened without a copy are copied. The
    kernel's scratch is made once per device and shared by every call, so
    calls on one device must come from one stream at a time."""
    if not stft_p.is_cuda:
        return fm_weighted_power_sum_plain(stft_p, tables)
    device = stft_p.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fm_weighted_power_sum(stft_p, tables)
    if stft_p.dtype != torch.complex64 or stft_p.dim() < 2:
        raise ValueError(f"fm_weighted_power_sum: expected complex64 (..., F, T), got "
                         f"{stft_p.dtype} {tuple(stft_p.shape)}")
    F, T = stft_p.shape[-2:]
    table, dom = tables.fm_table, tables.fm_in_domain
    if table.shape != (10, F) or dom.shape != (F,):
        raise ValueError(f"fm_weighted_power_sum: tables do not match F={F}")
    for t in (table, dom):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fm_weighted_power_sum: tables must be contiguous float32 "
                             "on the STFT's device")
    x = stft_p if stft_p.dim() == 3 else stft_p.reshape(-1, F, T)
    partials, ticket, n_sm = _scratch_for(device)
    out = torch.empty((), dtype=torch.float32, device=device)
    status = _lib.library().paa_fm_power_sum(
        x.data_ptr(), table.data_ptr(), dom.data_ptr(), partials.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), x.shape[0], F, T, *x.stride(), n_sm, THREADS,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _lib.check(status, "fm_weighted_power_sum")
    _lib.launches["fm_norm"] += 1
    return out


def fm_weighted_norm(stft_p: torch.Tensor, tables: PsychoTables) -> torch.Tensor:
    """Fletcher-Munson weighted norm ``sqrt(Σ w·|X|²)`` through K3."""
    return torch.sqrt(fm_weighted_power_sum(stft_p, tables))
