"""The benchmark's inputs, all made from ``--seed``: the clips, their
transcripts and CTC labels, and the model's weights.

Audio is N(0, std²) white noise, drawn on the device, every clip exactly
the traffic's length. Each transcript is a uniform number of words between
the traffic's bounds, drawn from a fixed bank; its labels use the 32-token
character vocabulary of the facebook wav2vec2 CTC checkpoints (blank 0,
``|`` between words). The weights are drawn on the device from a
``torch.Generator`` seeded with the seed, one draw for all of them, in the
order of the family's parameter table (``reference/<family>.py``'s
``param_specs``), and are made in the type they are served in: the
convolutions' and matrix products' weights in bfloat16, everything else in
float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench import family

VOCAB = (
    "<pad>", "<s>", "</s>", "<unk>", "|",
    "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U", "M", "W",
    "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J", "Q", "Z",
)
WORDS = (
    "the quick brown fox jumps over lazy dog speech attack delete model audio signal "
    "noise loud quiet phone tone hello world test alpha beta gamma delta open close "
    "start stop river mountain paper window garden yellow seven eleven morning evening"
).split()


class Clips(NamedTuple):
    audio: np.ndarray  # (N, T) float32
    texts: list  # lower-case transcripts
    labels: np.ndarray  # (N, L) int32, 0 past the end
    lengths: np.ndarray  # (N,) int64
    paddings: np.ndarray  # (N, L) float32, 1.0 past the end


def encode(texts: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(labels, lengths, paddings)`` of ``texts`` in the CTC vocabulary."""
    index = {c: i for i, c in enumerate(VOCAB)}
    rows = [[index.get(c, 3) for c in t.upper().replace(" ", "|")] for t in texts]
    L = max(len(r) for r in rows)
    labels = np.zeros((len(rows), L), np.int32)
    paddings = np.ones((len(rows), L), np.float32)
    for i, r in enumerate(rows):
        labels[i, :len(r)] = r
        paddings[i, :len(r)] = 0.0
    return labels, np.array([len(r) for r in rows], np.int64), paddings


def clips(seed: int, stream: int, n: int, samples: int, words: tuple, std: float,
          device) -> Clips:
    """``n`` clips of ``samples`` samples from ``(seed, stream)``: one stream
    per split, so that splits never share a clip. The audio is drawn on
    ``device`` in one call and brought to the host, where the program's
    splits keep their waveforms."""
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2**63)
    audio = (torch.randn((n, samples), generator=gen, device=device) * std).cpu().numpy()
    rng = np.random.default_rng([seed, stream])
    lo, hi = words
    texts = [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(lo, hi + 1))))
             for _ in range(n)]
    labels, lengths, paddings = encode(texts)
    return Clips(audio, texts, labels, lengths, paddings)


# how each kind of parameter is made from its slice ``x`` of the draw: a
# tensor of its own (no view of the draw), in the type it is served in; a
# family's reference adds kinds of its own (``KINDS``), never one of these
KINDS = {
    "matmul": lambda x, shape, cfg: (x * math.prod(shape[1:]) ** -0.5).to(torch.bfloat16),
    "branch_out": lambda x, shape, cfg: (
        x * (math.prod(shape[1:]) * 2 * cfg["num_hidden_layers"]) ** -0.5).to(torch.bfloat16),
    "head": lambda x, shape, cfg: x * math.prod(shape[1:]) ** -0.5,
    "bias": lambda x, shape, cfg: x * 0.02,
    "norm_weight": lambda x, shape, cfg: 1.0 + 0.1 * x,
    "norm_bias": lambda x, shape, cfg: x * 0.1,
    "pos_gain": lambda x, shape, cfg: 1.0 + 0.1 * x,
    "pos_direction": lambda x, shape, cfg: x.clone(),
}


def weights(cfg: dict, seed: int, device) -> dict:
    """``{HF name: tensor}`` on ``device``, in the order and kinds of the
    family's ``param_specs``: matmul and conv weights N(0, 1/fan_in) in
    bfloat16, the last product of each encoder branch (attention's
    ``out_proj``, the FFN's ``output_dense``) scaled by
    ``1/sqrt(2·layers)``; the head N(0, 1/fan_in), biases N(0, 0.02²), norm
    gains 1 + N(0, 0.1²), norm shifts N(0, 0.1²), the positional conv's
    per-tap gains 1 + N(0, 0.1²) and its direction N(0, 1), all in float32;
    a kind of the family's own as its ``KINDS`` makes it. Each takes the
    next slice of the one draw, whatever its kind.

    The branch scaling keeps each frame's own features through the stack:
    with every branch at full scale the random encoder maps all frames of a
    clip to nearly one vector (a random transformer's rank collapse), so
    the greedy ids are one token across the clip or flip at almost every
    frame, by the seed, and the host's decoding work varies with the seed.
    Scaled, the logits move from frame to frame with the input, and near
    ties between the best two tokens, which the check reads, occur on every
    seed."""
    ref = family.reference(cfg)
    own = getattr(ref, "KINDS", {})
    clash = own.keys() & KINDS.keys()
    if clash:
        raise ValueError(f"family {cfg['family']!r} redefines the kinds {sorted(clash)}")
    kinds = {**KINDS, **own}
    specs = ref.param_specs(cfg)
    total = sum(math.prod(shape) for shape, _ in specs.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        out[name] = kinds[kind](draw[at:at + n].view(shape), shape, cfg)
        at += n
    return out


def rows_of(audio_heads: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The row of ``data`` whose first samples equal each row of
    ``audio_heads`` ``(B, k)``, or -1 where none does."""
    k = audio_heads.shape[1]
    index = {data[i, :k].tobytes(): i for i in range(data.shape[0])}
    return np.array([index.get(r.tobytes(), -1) for r in np.ascontiguousarray(audio_heads)])
