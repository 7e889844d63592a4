"""Score tracking: better-than comparisons and best aggregation.

Reference: src/training_utils/scoring_helpers.py (whose missing
``dataclass`` import is fixed here, SURVEY.md §5.9).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Scores:
    ctc: float
    wer: float


def is_better(curr: float, best: float, mode: str) -> bool:
    """Targeted: lower WER is better (hit the target); untargeted: higher
    CTC loss is better (degrade ASR). Reference: scoring_helpers.py:6-16."""
    if mode == "targeted":
        return curr < best
    if mode == "untargeted":
        return curr > best
    raise ValueError(f"Unknown attack_mode: {mode!r}")


def best_agg(values: list, mode: str) -> float:
    """Min for targeted, max for untargeted (scoring_helpers.py:18-22)."""
    if not values:
        return float("inf") if mode == "targeted" else float("-inf")
    return (min if mode == "targeted" else max)(values)


def initial_best(mode: str) -> float:
    return float("inf") if mode == "targeted" else float("-inf")


def emission_metrics(preds: list[str], target: str, target_reps: int) -> dict:
    """Targeted-attack success signals from a batch of greedy decodes.

    The reference's only success detector is the sus-routing substring
    test ``target in prediction`` (src/training_utils/save.py:86); the
    paper reports targeted attacks by whether the model ever emits the
    target (report.pdf §4.4). This makes that a first-class per-epoch
    metric:

      * ``emission_rate`` — fraction of utterances whose greedy decode
        contains the (cleaned, lowercased) target phrase at least once;
      * ``wer_to_target`` — corpus WER of the decodes against the FULL
        repeated target (``" ".join([target] * target_reps)``, the exact
        label string the targeted loss trains toward,
        src/core/loss_helpers.py:14-15); 0.0 would mean the attack
        perfectly controls the transcript.
    """
    from paa_tpu_torch.ops import text as text_ops, wer as wer_ops

    tgt = text_ops.clean_transcripts([target])[0].lower()
    full = text_ops.clean_transcripts(
        [" ".join([target] * max(target_reps, 1))]
    )[0].lower()
    lowered = [p.lower() for p in preds]
    n = max(len(lowered), 1)
    emitted = sum(1 for p in lowered if tgt and tgt in p)
    return {
        "emission_rate": emitted / n,
        "wer_to_target": wer_ops.wer(lowered, [full] * len(lowered))
        if lowered else float("inf"),
    }
