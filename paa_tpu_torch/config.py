"""Attack configuration — the port's copy of ``paa_tpu/config.py``.

``paa_tpu/config.py`` imports ``jax.numpy``, so the port keeps its own.
``AttackConfig`` has the reference's fields and defaults (a test compares
them); ``ConstraintParams`` holds the same dynamic scalars as 0-d float32
tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

NORM_TYPES = (
    "l2",
    "linf",
    "snr",
    "tv",
    "l1",
    "fletcher_munson",
    "min_max_freqs",
    "max_phon",
)
FREQ_NORM_TYPES = ("fletcher_munson", "min_max_freqs", "max_phon")
ATTACK_MODES = ("untargeted", "targeted")
OPTIMIZER_TYPES = ("pgd", "adam")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Static attack facts (reference: ``paa_tpu/config.py:41-140``).

    The fields that steer TPU-only machinery (``remat``, ``use_pallas_fm``,
    ``tp``, ``cache_data_on_device``) are kept so that one configuration
    describes a run in both packages. The port's step rejects the values it
    does not run yet (``accum_steps > 1``, ``tp > 1``); it picks the
    Fletcher-Munson kernel by the tensor's device, not by ``use_pallas_fm``.
    """

    # attack
    norm_type: str = "max_phon"
    attack_mode: str = "untargeted"
    optimizer_type: str = "adam"
    target: str = "delete"
    target_reps: int = 5

    # sound / STFT geometry
    sr: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024

    # psychoacoustics
    phon_reference_db: float = 65.0

    # training
    batch_size: int = 64
    lr: float = 1e-4
    num_epochs: int = 50
    early_stopping: int = 4
    gamma: float = 0.9
    step_size: int = 2
    seed: int = 5

    # model
    model_name: str = "wav2vec2-base"
    compute_dtype: str = "bfloat16"
    remat: bool = False

    clamp_audio: bool = True
    accum_steps: int = 1
    use_pallas_fm: bool = False
    tp: int = 1
    cache_data_on_device: bool | None = None

    def __post_init__(self):
        if self.norm_type not in NORM_TYPES:
            raise ValueError(f"Unknown norm_type: {self.norm_type!r}")
        if self.attack_mode not in ATTACK_MODES:
            raise ValueError(f"Unknown attack_mode: {self.attack_mode!r}")
        if self.optimizer_type not in OPTIMIZER_TYPES:
            raise ValueError(f"Unknown optimizer_type: {self.optimizer_type!r}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")

    @property
    def is_freq_domain(self) -> bool:
        return self.norm_type in FREQ_NORM_TYPES

    @property
    def num_freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def loss_direction(self) -> float:
        """+1 = maximize CTC loss (untargeted), -1 = minimize (targeted)."""
        return 1.0 if self.attack_mode == "untargeted" else -1.0

    def replace(self, **kw) -> "AttackConfig":
        return dataclasses.replace(self, **kw)


class ConstraintParams(NamedTuple):
    """Dynamic constraint scalars (reference: ``paa_tpu/config.py:143-185``).

    Only the entry matching ``AttackConfig.norm_type`` is read by the
    projection for that config.
    """

    fm_epsilon: torch.Tensor
    l2_size: torch.Tensor
    l1_size: torch.Tensor
    linf_size: torch.Tensor
    snr_db: torch.Tensor
    tv_epsilon: torch.Tensor
    min_freq: torch.Tensor
    max_freq: torch.Tensor
    max_phon_level: torch.Tensor

    @classmethod
    def create(
        cls,
        fm_epsilon: float = 2.0,
        l2_size: float = 0.05,
        l1_size: float = 1.0,
        linf_size: float = 1e-4,
        snr_db: float = 64.0,
        tv_epsilon: float = 1e-3,
        min_freq: float = 120.0,
        max_freq: float = 20_000.0,
        max_phon_level: float = 20.0,
        device: torch.device | str | None = None,
    ) -> "ConstraintParams":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return cls(
            fm_epsilon=f32(fm_epsilon),
            l2_size=f32(l2_size),
            l1_size=f32(l1_size),
            linf_size=f32(linf_size),
            snr_db=f32(snr_db),
            tv_epsilon=f32(tv_epsilon),
            min_freq=f32(min_freq),
            max_freq=f32(max_freq),
            max_phon_level=f32(max_phon_level),
        )
