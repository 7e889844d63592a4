"""Run artifacts: WAV export, plots, spectrograms, results.json, samples.

Mirrors the reference's artifact bundle (src/training_utils/save.py):
per-improvement WAV + 5×-amplified WAV + waveform PNG + STFT spectrograms
(linear/log), random-sample transcription triples with sus_ routing,
loss/WER curves with test h-lines, the cumulative ``results.json``
including ``perturbation_efficiency``, and the projection debug plots
(``--debug_plots``). WAV I/O uses the stdlib ``wave`` module (int16 PCM, as
save.py:11-21); plotting degrades gracefully when matplotlib is absent.

The port's copy of ``paa_tpu/train/artifacts.py``; the spectrograms take
|STFT| from the port's ``ops/dsp.py`` on the CPU, where the original uses
``jnp``, and :func:`stft_db` and :func:`debug_phon_arrays` return the arrays
the plots draw.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import wave as wave_mod

import numpy as np
import torch

from paa_tpu_torch.ops import dsp, psycho

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


def stft_db(tensor, cfg) -> np.ndarray:
    """``20·log10(|STFT| + 1e-8)`` of a waveform, ``(1, F, frames)`` float32."""
    x = torch.as_tensor(np.asarray(tensor, dtype=np.float32).reshape(1, -1))
    mag = dsp.stft(x, cfg.n_fft, cfg.hop_length, cfg.win_length).abs().numpy()
    return 20.0 * np.log10(mag + 1e-8)


def stft_plot(path: str, tensor, cfg, title: str = "STFT Magnitude"):
    """Linear + log frequency-scale spectrograms (reference: save.py:105-153)."""
    if not HAVE_MPL:
        return
    db = stft_db(tensor, cfg)[0]
    freqs = np.fft.rfftfreq(cfg.n_fft, d=1.0 / cfg.sr)
    frames = db.shape[1]

    for scale, suffix in (("linear", "_linear.png"), ("log", "_log.png")):
        plt.figure(figsize=(10, 4))
        plt.imshow(
            db, aspect="auto", origin="lower", interpolation="none",
            extent=[0, frames - 1, freqs[0], freqs[-1]],
        )
        if scale == "log":
            plt.yscale("log")
            plt.ylim(max(freqs[1], 1.0), freqs[-1])
        plt.title(f"{title} ({scale.capitalize()} Frequency Scale)")
        plt.xlabel("Time Frame")
        plt.ylabel("Frequency (Hz)")
        plt.colorbar(label="Amplitude (dB)")
        plt.tight_layout()
        plt.savefig(path + suffix)
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


def save_epoch_bundle(save_dir: str, p, cfg):
    """perturbation.wav + 5× amplified + waveform/STFT PNGs
    (reference: save.py:158-171)."""
    save_audio(os.path.join(save_dir, "perturbation.wav"), p, cfg.sr)
    save_audio(os.path.join(save_dir, "perturbation_5x.wav"), p, cfg.sr, amplify=5.0)
    plot_pert(os.path.join(save_dir, "perturbation.png"), p, cfg.sr)
    stft_plot(os.path.join(save_dir, "perturbation_stft"), p, cfg)


def debug_phon_arrays(p, cfg, cparams, tables):
    """The max_phon debug panels' arrays: ``(mag_db (1, F, frames),
    mag_db clipped at the threshold, scaled threshold (F,))``, the ISO 226
    contour at ``cparams.max_phon_level`` shifted so its maximum sits at
    ``phon_reference_db``."""
    mag_db = stft_db(p, cfg)
    contour = psycho.phon_contour(tables, cparams.max_phon_level).cpu().numpy()
    scaled_thresh = contour - contour.max() + cfg.phon_reference_db
    return mag_db, np.minimum(mag_db, scaled_thresh[:, None]), scaled_thresh


def save_debug_plots(save_dir: str, p, cfg, cparams, tables, tag: str = ""):
    """Projection debug artifacts for the perceptual constraints.

    The reference emits the 3-panel phon plot from *inside* the projection
    (reference: src/core/projections.py:156-157 → save.py:260-294); here the
    same panels are drawn on the host from the perturbation on improvement
    epochs (--debug_plots) and at a sweep cell's end (--cell_artifacts)."""
    if not HAVE_MPL or cfg.norm_type not in ("max_phon", "fletcher_munson"):
        return
    if cfg.norm_type == "max_phon":
        mag_db, clipped, scaled_thresh = debug_phon_arrays(p, cfg, cparams, tables)
        plot_debug_phon(mag_db, clipped, scaled_thresh, cfg, save_dir, tag=tag)
    else:  # fletcher_munson: the per-bin perceptual sensitivity curve
        # at 60 phon — the table row a typical speech-level cell lerps to
        plot_fm_weights(
            tables.bin_freqs.cpu().numpy(), tables.fm_table[6].cpu().numpy(),
            path=os.path.join(save_dir, f"fm_weights_{tag}.png" if tag else "fm_weights.png"),
        )


def plot_debug_phon(mag_db, mag_db_clipped, scaled_thresh, cfg, save_dir, tag=""):
    """3-panel before/after/diff debug plot for the max_phon projection
    (reference: save.py:260-294)."""
    if not HAVE_MPL:
        return
    mag_db_np = np.asarray(mag_db)[0]
    clipped_np = np.asarray(mag_db_clipped)[0]
    contour_np = np.asarray(scaled_thresh).reshape(-1)
    frames = mag_db_np.shape[1]
    freqs = np.fft.rfftfreq(cfg.n_fft, d=1.0 / cfg.sr)

    fig, axs = plt.subplots(3, 1, figsize=(10, 12), constrained_layout=True)
    extent = [0, frames, freqs[0], freqs[-1]]
    axs[0].imshow(mag_db_np, aspect="auto", origin="lower", extent=extent, cmap="viridis")
    axs[0].plot(np.arange(frames), [contour_np.mean()] * frames, color="r", label="Phon Threshold")
    axs[0].set_title("Original STFT Magnitude (dB)")
    axs[0].set_ylabel("Frequency (Hz)")
    axs[0].legend()
    axs[1].imshow(clipped_np, aspect="auto", origin="lower", extent=extent, cmap="viridis")
    axs[1].set_title("Clipped STFT Magnitude (dB)")
    axs[1].set_ylabel("Frequency (Hz)")
    axs[2].imshow(mag_db_np - clipped_np, aspect="auto", origin="lower", extent=extent, cmap="coolwarm")
    axs[2].set_title("Difference (Before - After)")
    axs[2].set_xlabel("Time Frame")
    axs[2].set_ylabel("Frequency (Hz)")
    plt.suptitle(f"Phon-Level Constraint Debug {tag}", fontsize=16)
    plt.savefig(os.path.join(save_dir, f"phon_projection_debug_{tag}.png"), bbox_inches="tight")
    plt.close()


def plot_fm_weights(freqs, weights, path="fm_weights.png"):
    """Fletcher-Munson perceptual sensitivity curve
    (reference: save.py:203-218)."""
    if not HAVE_MPL:
        return
    plt.figure(figsize=(10, 4))
    plt.plot(np.asarray(freqs), np.asarray(weights), label="Interpolated FM Weights", color="purple")
    plt.title("Fletcher-Munson Perceptual Sensitivity Curve")
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Perceptual Sensitivity (Normalized)")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
