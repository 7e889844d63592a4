"""Structured console/file logging for attack runs.

Reference: src/training_utils/log_helpers.py (epoch/summary tables) and
src/training_utils/build.py:19-38 (rotating-file + console logger).
"""

from __future__ import annotations

import json
import logging
import os
from logging.handlers import RotatingFileHandler

logger = logging.getLogger("paa_tpu")


def setup_logging(save_dir: str, log_name: str = "train.log", console: bool = True) -> logging.Logger:
    os.makedirs(save_dir, exist_ok=True)
    log = logging.getLogger("paa_tpu")
    log.setLevel(logging.INFO)
    log.handlers.clear()
    fh = RotatingFileHandler(
        os.path.join(save_dir, log_name), maxBytes=5_000_000, backupCount=3
    )
    fh.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    log.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter("%(levelname)s | %(message)s"))
        log.addHandler(ch)
    return log


def log_args(log: logging.Logger, args_dict: dict) -> None:
    log.info("========= Args =========")
    log.info(json.dumps(args_dict, indent=4, default=str))
    log.info("========================")


def log_epoch_metrics(
    epoch: int,
    num_epochs: int,
    *,
    train_ctc: float,
    eval_ctc_clean: float,
    eval_ctc_perturbed: float,
    train_wer: float,
    eval_wer_clean: float,
    eval_wer_perturbed: float,
    step_time_ms: float | None = None,
) -> None:
    """Per-epoch metric block (same content as the reference's epoch
    table, log_helpers.py:16-40, restyled) + step timing."""
    head = f"── epoch {epoch + 1}/{num_epochs} "
    lines = [
        head + "─" * max(0, 62 - len(head)),
        f"{'':>8}  {'train':>12}  {'eval/clean':>12}  {'eval/perturbed':>14}",
        f"{'ctc':>8}  {train_ctc:>12.1f}  {eval_ctc_clean:>12.1f}  {eval_ctc_perturbed:>14.1f}",
        f"{'wer':>8}  {train_wer:>12.3f}  {eval_wer_clean:>12.3f}  {eval_wer_perturbed:>14.3f}",
    ]
    if step_time_ms is not None:
        lines.append(f"{'ms/step':>8}  {step_time_ms:>12.1f}")
    lines.append("─" * 62)
    for line in lines:
        logger.info(line)


def log_summary_metrics(
    *,
    norm_type: str,
    attack_size_string: str,
    clean_ctc_test: float,
    clean_wer_test: float,
    pert_ctc_test: float,
    pert_wer_test: float,
    best_epoch: int,
) -> None:
    """Final report block (same content as the reference's summary
    table, log_helpers.py:43-70, restyled)."""
    lines = [
        "═" * 62,
        f"final report — {norm_type} @ {attack_size_string} (best epoch {best_epoch})",
        "═" * 62,
        f"{'':>8}  {'test/clean':>14}  {'test/perturbed':>14}",
        f"{'ctc':>8}  {clean_ctc_test:>14.2f}  {pert_ctc_test:>14.2f}",
        f"{'wer':>8}  {clean_wer_test:>14.3f}  {pert_wer_test:>14.3f}",
        "═" * 62,
    ]
    for line in lines:
        logger.info(line)
