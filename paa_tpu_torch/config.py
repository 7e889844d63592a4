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

    ``remat`` records whether the encoder layers are rematerialized (the
    model config carries it with its policy, ``cli/parser.py:resolve_remat``).
    ``use_pallas_fm`` is kept so that one configuration describes a run in
    both packages: the port picks the Fletcher-Munson kernel by the tensor's
    device, not by it. ``tp`` sizes the model axis under ``torchrun``, and
    ``cache_data_on_device`` picks the feed (True, False or None for auto;
    ``data/pipeline.py:device_feed_kind``), as in the JAX package.
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

    @classmethod
    def from_args(cls, args, device: torch.device | str | None = None) -> "ConstraintParams":
        """From an argparse namespace with the reference's flag names."""
        return cls.create(
            fm_epsilon=args.fm_epsilon,
            l2_size=args.l2_size,
            l1_size=args.l1_size,
            linf_size=args.linf_size,
            snr_db=args.snr_db,
            tv_epsilon=args.tv_epsilon,
            min_freq=args.min_freq_attack,
            max_freq=args.max_freq_attack,
            max_phon_level=args.max_phon_level,
            device=device,
        )


# norm_type -> the ConstraintParams field that sizes its feasible set
SWEEP_FIELD = {
    "min_max_freqs": "min_freq",
    "fletcher_munson": "fm_epsilon",
    "max_phon": "max_phon_level",
    "l2": "l2_size",
    "l1": "l1_size",
    "linf": "linf_size",
    "snr": "snr_db",
    "tv": "tv_epsilon",
}

# norm_type -> the command-line flag that carries that size
SWEEP_ARG = {**SWEEP_FIELD, "min_max_freqs": "min_freq_attack"}


def attack_size_value(cfg: AttackConfig, params: ConstraintParams) -> float:
    """The scalar size of the active constraint, for run naming."""
    return float(getattr(params, SWEEP_FIELD[cfg.norm_type]))


def with_sweep_value(params: ConstraintParams, norm_type: str, value) -> ConstraintParams:
    """``params`` with the sweep field of ``norm_type`` replaced by ``value``,
    a scalar or a per-cell vector, as float32 on that field's device
    (reference: ``paa_tpu/config.py:231-237``)."""
    field = SWEEP_FIELD[norm_type]
    old = getattr(params, field)
    return params._replace(**{field: torch.as_tensor(value, dtype=torch.float32,
                                                     device=old.device)})
