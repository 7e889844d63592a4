"""Character tokenizer for Wav2Vec2-CTC — self-contained, no HF runtime.

The facebook wav2vec2 CTC checkpoints share one fixed 32-token character
vocabulary; the reference reaches it through ``Wav2Vec2Processor``
(reference: src/core/loss_helpers.py:19-20, :27). Baking the vocab here
removes the per-batch CPU tokenizer from the hot loop: labels are
tokenized ONCE per epoch on the host, and decode is a cheap id→char map
applied only at report time.

Also hosts the transcript normalization the reference applies before
tokenizing/WER (``clean_transcripts``: strip <unk>, lowercase, collapse
whitespace — reference: src/core/loss_helpers.py:7-9).
"""

from __future__ import annotations

import re

import numpy as np

# facebook/wav2vec2-*-960h vocab.json, in id order.
VOCAB = (
    "<pad>", "<s>", "</s>", "<unk>", "|",
    "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U", "M", "W",
    "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J", "Q", "Z",
)
PAD_ID = 0  # doubles as the CTC blank, as in HF Wav2Vec2
UNK_ID = 3
WORD_DELIM_ID = 4  # "|"
SPECIAL_IDS = frozenset({0, 1, 2, 3})
VOCAB_SIZE = len(VOCAB)

_CHAR_TO_ID = {c: i for i, c in enumerate(VOCAB)}


def clean_transcripts(texts: list[str]) -> list[str]:
    """Strip ``<unk>``, lowercase, collapse whitespace.

    Reference: src/core/loss_helpers.py:7-9.
    """
    return [re.sub(r"\s+", " ", t.replace("<unk>", "").lower()).strip() for t in texts]


def encode(text: str) -> list[int]:
    """Text → token ids (uppercased; spaces → '|'; OOV → <unk>)."""
    ids = []
    for ch in text.upper().replace(" ", "|"):
        ids.append(_CHAR_TO_ID.get(ch, UNK_ID))
    return ids


def encode_batch(texts: list[str], pad_to: int | None = None):
    """Batch-encode to a padded ``(B, L)`` int32 array + padding mask.

    Returns:
      labels: ``(B, L)`` int32, padded with PAD_ID.
      label_paddings: ``(B, L)`` float32, 1.0 at padded positions (the
        convention ``optax.ctc_loss`` expects; equivalent to the
        reference's pad→-100 masking at src/core/loss_helpers.py:20).
    """
    encoded = [encode(t) for t in texts]
    max_len = max((len(e) for e in encoded), default=1)
    L = max(pad_to or 0, max_len, 1)
    labels = np.full((len(encoded), L), PAD_ID, dtype=np.int32)
    paddings = np.ones((len(encoded), L), dtype=np.float32)
    for i, e in enumerate(encoded):
        labels[i, : len(e)] = e
        paddings[i, : len(e)] = 0.0
    return labels, paddings


def targeted_texts(target: str, target_reps: int, batch: int) -> list[str]:
    """The repeated malicious phrase used as the label in targeted mode.

    Reference: src/core/loss_helpers.py:13-15.
    """
    return [" ".join([target] * target_reps)] * batch


def decode_ids(ids) -> str:
    """CTC-collapse one id sequence and map to text.

    Collapse repeats, drop the blank, drop special tokens, '|' → ' '
    (HF ``batch_decode(skip_special_tokens=True)`` semantics, as used at
    reference: src/core/loss_helpers.py:25-32, :60-62).
    """
    ids = np.asarray(ids)
    if ids.size == 0:
        return ""
    keep = np.ones(len(ids), dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]  # collapse repeats
    out = []
    for i in ids[keep]:
        i = int(i)
        if i in SPECIAL_IDS:
            continue
        out.append(" " if i == WORD_DELIM_ID else VOCAB[i])
    return "".join(out).strip()


def decode_batch(ids_batch) -> list[str]:
    return [decode_ids(row) for row in np.asarray(ids_batch)]
