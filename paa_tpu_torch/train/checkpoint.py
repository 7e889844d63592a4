"""Checkpoint and resume of an attack run.

The full attack state (perturbation, optimizer state, epoch, best score,
best perturbation, early-stopping count and metric history) is written
atomically, so a resumed run continues bit for bit where an interrupted one
stopped. The perturbation is also written alone as ``perturbation.npy``,
the run's product, the same file the JAX package writes.

The state file is the port's own format, ``attack_state.pt``: a dict of
CPU tensors, Python numbers and None, written by ``torch.save`` and read
with ``weights_only=True``. ``paa_tpu`` writes flax msgpack
(``attack_state.msgpack``), which needs flax to read; neither package
resumes from the other's state file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

STATE_FILE = "attack_state.pt"


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return x


def save_checkpoint(path: str, state: dict) -> None:
    """Atomically write ``state`` (nested dicts of tensors, numpy arrays,
    numbers and None): write a temporary file beside it, then rename."""
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: dict) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint`.

    Tolerates history-series drift against ``template["history"]``: a
    series the checkpoint lacks (one added after the run started) comes
    back NaN-filled to the length of the others; a series the template no
    longer names is dropped (as ``paa_tpu/train/checkpoint.py:32-52``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    hist, want = state.get("history"), template.get("history")
    if isinstance(hist, dict) and isinstance(want, dict):
        n = max((len(v) for v in hist.values()), default=0)
        for k in want:
            if k not in hist:
                hist[k] = torch.full((n,), float("nan"), dtype=torch.float64)
        for k in list(hist):
            if k not in want:
                del hist[k]
    return state


def save_perturbation(path: str, p) -> None:
    np.save(path, p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p))


def load_perturbation(path: str) -> np.ndarray:
    return np.load(path)


def discover_resume(save_dir: str) -> tuple[bool, str | None]:
    """A state file in ``save_dir`` means an earlier run was interrupted."""
    path = os.path.join(save_dir, STATE_FILE)
    if os.path.exists(path):
        return True, path
    return False, None
