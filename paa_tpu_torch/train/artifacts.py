"""Run artifacts: WAV export, plots, results.json, samples.

Mirrors the reference's artifact bundle (src/training_utils/save.py):
per-improvement WAV + 5×-amplified WAV + waveform PNG, random-sample
transcription triples with sus_ routing, loss/WER curves with test
h-lines, and the cumulative ``results.json`` including
``perturbation_efficiency``. The STFT spectrograms and the projection debug
plots (``--debug_plots``) are not ported yet. WAV I/O uses the stdlib ``wave``
module (int16 PCM, as save.py:11-21); plotting degrades gracefully when
matplotlib is absent.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import wave as wave_mod

import numpy as np

logger = logging.getLogger(__name__)

try:  # plots are optional
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except Exception:  # pragma: no cover
    HAVE_MPL = False


def save_audio(filename: str, tensor, sample_rate: int = 16000, amplify: float = 1.0):
    """float waveform → int16 PCM WAV (reference: save.py:11-21)."""
    x = np.asarray(tensor, dtype=np.float32).reshape(-1)
    x = np.clip(x * amplify, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave_mod.open(filename, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def plot_pert(path: str, tensor, sample_rate: int = 16000, title: str = "Perturbation waveform"):
    """Waveform PNG (reference: save.py:24-45)."""
    if not HAVE_MPL:
        return
    x = np.asarray(tensor).reshape(-1)
    t = np.arange(len(x)) / sample_rate
    plt.figure(figsize=(10, 4))
    plt.plot(t, x, linewidth=0.8)
    plt.title(title)
    plt.xlabel("Time (s)")
    plt.ylabel("Amplitude")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def save_loss_plot(
    train_scores: dict,
    eval_scores_clean: dict,
    eval_scores_perturbed: dict,
    save_dir: str,
    norm_type: str,
    clean_test_loss: dict | None = None,
    perturbed_test_loss: dict | None = None,
):
    """CTC/WER curves with optional test h-lines (reference: save.py:173-199)."""
    if not HAVE_MPL:
        return
    os.makedirs(save_dir, exist_ok=True)
    x = list(range(len(train_scores["ctc"])))
    for loss_type in ("ctc", "wer"):
        plt.figure(figsize=(10, 6))
        plt.plot(x, train_scores[loss_type], label="Train", marker="o", color="blue")
        plt.plot(x, eval_scores_clean[loss_type], label="Eval Clean", marker="^", color="orange")
        plt.plot(x, eval_scores_perturbed[loss_type], label="Eval Perturbed", marker="x", color="purple")
        if clean_test_loss is not None:
            plt.axhline(y=clean_test_loss[loss_type], color="green", label="Clean Test")
        if perturbed_test_loss is not None:
            plt.axhline(y=perturbed_test_loss[loss_type], color="red", label="Perturbed Test")
        plt.xlabel("Epoch")
        plt.ylabel(f"{loss_type.upper()} Loss")
        plt.title(f"{loss_type.upper()} Loss Curve — Norm Type: {norm_type}")
        plt.legend()
        plt.grid(True)
        plt.savefig(os.path.join(save_dir, f"loss_plot_{loss_type}.png"))
        plt.close()


def save_json_results(save_dir: str, norm_type: str, attack_size, **kwargs):
    """Cumulative results.json incl. perturbation_efficiency
    (reference: save.py:226-257)."""
    json_path = os.path.join(save_dir, "results.json")

    def safe(v):
        if isinstance(v, dict):
            return {k: safe(v[k]) for k in v}
        if isinstance(v, (bool, np.bool_)):  # bool is an int subclass
            return bool(v)
        if isinstance(v, (int, float, np.floating, np.integer)):
            return round(float(v), 4)
        return v

    # cumulative: merge over the existing file so the finalize pass (and
    # the failure handler) extend rather than destroy per-epoch keys
    results = {}
    if os.path.exists(json_path):
        try:
            with open(json_path) as f:
                results = json.load(f)
        except Exception:
            results = {}
    results.update({"norm_type": norm_type, "attack_size": float(attack_size)})
    for key, val in kwargs.items():
        if val is not None:
            results[key] = safe(val)

    def first_present(*keys):
        for k in keys:
            v = kwargs.get(k)
            if v is not None:
                return v
        return None

    clean = first_present("final_test_clean", "test_loss_clean")
    pert = first_present("final_test_perturbed", "test_loss_perturbed")
    # a clean score of exactly 0 (plausible for WER with strong models on a
    # small split) yields null, not bare Infinity — results.json must stay
    # strict JSON for non-Python consumers
    if clean is not None and pert is not None:
        if isinstance(clean, dict):
            results["perturbation_efficiency"] = {
                k: pert[k] / clean[k] if clean.get(k) else None for k in clean
            }
        else:
            results["perturbation_efficiency"] = pert / clean if clean else None

    tmp = json_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_finite_or_none(results), f, indent=2, allow_nan=False)
    os.replace(tmp, json_path)
    return json_path


def _finite_or_none(v):
    """Map non-finite numbers to null so results.json is strict JSON."""
    if isinstance(v, dict):
        return {k: _finite_or_none(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite_or_none(x) for x in v]
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def inspect_samples(
    save_dir: str,
    samples: list[dict],
    attack_mode: str,
    target: str,
    sr: int = 16000,
):
    """Write clean/perturbed WAV + 3-line transcription per inspected
    sample, routing to ``sus_sample_i/`` when the attack visibly worked
    (reference: save.py:49-101).

    ``samples``: dicts with keys clean, perturbed (waveforms),
    ground_truth, clean_pred, pert_pred.
    """
    for i, s in enumerate(samples):
        if attack_mode == "targeted":
            # predictions are lowercased upstream; match case-insensitively
            is_sus = target.lower() in s["pert_pred"].lower()
        else:
            is_sus = s["clean_pred"] != s["pert_pred"]

        sample_dir = os.path.join(save_dir, f"sample_{i}")
        sus_dir = os.path.join(save_dir, f"sus_sample_{i}")
        for d in (sample_dir, sus_dir):
            if os.path.exists(d):
                shutil.rmtree(d)
        out_dir = sus_dir if is_sus else sample_dir
        os.makedirs(out_dir)

        save_audio(os.path.join(out_dir, "clean.wav"), s["clean"], sr)
        save_audio(os.path.join(out_dir, "perturbed.wav"), s["perturbed"], sr)
        name = "sus_transcription.txt" if is_sus else "transcription.txt"
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"{'Ground Truth:'.ljust(28)}{s['ground_truth'].lower()}\n\n")
            f.write(f"{'Clean Prediction:'.ljust(28)}{s['clean_pred'].lower()}\n\n")
            f.write(f"{'Perturbed Prediction:'.ljust(28)}{s['pert_pred'].lower()}\n\n")
