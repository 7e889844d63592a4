"""Every model preset of the port, by name, and the model each builds.

The entry points, the runner's frame and tensor-parallel checks and the
benchmark look presets up here: the wav2vec2 family's
(``models/wav2vec2.py``) and the conformer's
(``models/wav2vec2_conformer.py``). A config's ``family`` picks its model.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from paa_tpu_torch.models import wav2vec2, wav2vec2_conformer

PRESETS = {**wav2vec2.PRESETS, **wav2vec2_conformer.PRESETS}
MODELS = {wav2vec2.Wav2Vec2Config.family: wav2vec2.Wav2Vec2ForCTC,
          wav2vec2_conformer.ConformerConfig.family: wav2vec2_conformer.Wav2Vec2ConformerForCTC}


def get_config(name: str, **overrides) -> wav2vec2.Wav2Vec2Config:
    """Preset ``name`` with ``overrides``; a field its family does not take
    raises in the config."""
    if name not in PRESETS:
        raise ValueError(f"Unknown model preset {name!r}; have {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides)


def build(cfg: wav2vec2.Wav2Vec2Config) -> nn.Module:
    """The CTC model of ``cfg``'s family, on the CPU, in float32, untrained."""
    return MODELS[cfg.family](cfg)


def init_model(cfg: wav2vec2.Wav2Vec2Config, seed: int = 0) -> nn.Module:
    """:func:`build` with random weights from ``seed``
    (``wav2vec2.init_weights``), frozen."""
    return wav2vec2.init_weights(build(cfg), seed)
