"""Epoch orchestration: train → eval → track best → early stop → finalize.

Port of ``paa_tpu/train/loop.py``. The run is the JAX package's, step for
step:

  * every train batch is one attack step (attack/step.py); its metrics stay
    on the device until the epoch ends, so the host never waits on a step
    inside the epoch;
  * eval runs clean and perturbed passes per epoch with ``p`` added
    unclamped; targeted runs swap the loss labels, and WER stays against
    the ground truth;
  * the best perturbation is tracked on perturbed-eval WER (targeted) or
    CTC (untargeted), with early stopping;
  * resume is exact: p, Adam state, epoch, best score and history are
    checkpointed (train/checkpoint.py), and the shuffle order is a pure
    function of (seed, epoch).

Under ``torchrun`` the runner takes its mesh from ``decide_mesh`` (the
reference's mesh branches): dp, or dp × tp with the model sharded on the
``model`` axis; every rank feeds the same global batches (under the device
feed, each from its own staged copy of the split) and runs the
sharded steps, and their metrics are global on every rank. The initial p
is broadcast from rank 0, the early-stop decision is rank 0's on every
rank, every rank reads the checkpoint on resume, and only rank 0 writes the
run directory.

The helpers of ``train`` (scoring, log_helpers, tb_events and artifacts)
are the port's own copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from paa_tpu_torch.ops import text as text_ops, wer as wer_ops
from paa_tpu_torch.train import artifacts, log_helpers, scoring
from paa_tpu_torch.attack import optimizers, step as attack_step
from paa_tpu_torch.config import AttackConfig, ConstraintParams, attack_size_value
from paa_tpu_torch.data import pipeline as pipeline_lib
from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.ops import projections, psycho
from paa_tpu_torch.parallel import mesh as mesh_lib, tp as tp_lib
from paa_tpu_torch.train import checkpoint

logger = logging.getLogger("paa_tpu")


@dataclasses.dataclass
class RunResult:
    best_epoch: int
    test_clean: scoring.Scores
    test_perturbed: scoring.Scores
    perturbation: np.ndarray
    history: dict


def _targeted_labels(cfg: AttackConfig, batch_size: int, label_len: int,
                     audio_len: int | None = None):
    """Targeted label grid: the repeated phrase, padded to at least the
    corpus label width. With ``audio_len``, a label that no CTC alignment
    fits into the model's frames raises instead of giving inf losses."""
    texts = text_ops.clean_transcripts(
        text_ops.targeted_texts(cfg.target, cfg.target_reps, batch_size))
    labels, paddings = text_ops.encode_batch(texts, pad_to=label_len)
    if audio_len is not None:
        frames = wav2vec2.get_config(cfg.model_name).feat_extract_output_length(audio_len)
        row = labels[0][paddings[0] < 0.5]
        need = len(row) + int(np.sum(row[1:] == row[:-1]))
        if need > frames:
            raise ValueError(
                f"targeted label ({cfg.target!r} × {cfg.target_reps}) needs {need} CTC "
                f"frames but the model emits only {frames} for {audio_len}-sample audio — "
                "every step's loss would be inf. Reduce --target_reps or shorten --target.")
    return labels, paddings


def _truncate_metrics(path: str, start_epoch: int) -> None:
    """Keep only metrics.jsonl lines with epoch < start_epoch."""
    if not os.path.exists(path):
        return
    if start_epoch <= 0:
        os.remove(path)
        return
    kept = []
    with open(path) as f:
        for line in f:
            try:
                if json.loads(line).get("epoch", start_epoch) < start_epoch:
                    kept.append(line)
            except json.JSONDecodeError:
                pass
    with open(path, "w") as f:
        f.writelines(kept)


def _batch_wer(ids: np.ndarray, ref_texts: list[str]) -> tuple[float, list[str]]:
    preds = [p.lower() for p in text_ops.decode_batch(ids)]
    return wer_ops.wer(preds, [r.lower() for r in ref_texts]), preds


def _scores(pending: list, texts: list[str], empty: float,
            preds: list | None = None) -> scoring.Scores:
    """Per-batch sums averaged over batches, as the reference aggregates
    them; ``pending`` holds (StepMetrics, host row mask, row indices) per
    batch, WER is against ``texts``, ``empty`` is the score of no batch, and
    ``preds`` (if given) collects the lowercased greedy decodes."""
    ctc_scores, wer_scores = [], []
    for m, w, indices in pending:
        ctc_scores.append(float(m.ctc_loss))
        batch_wer, batch_preds = _batch_wer(m.greedy_ids.cpu().numpy()[w],
                                            [texts[i] for i in indices[w]])
        wer_scores.append(batch_wer)
        if preds is not None:
            preds.extend(batch_preds)
    avg = lambda v: sum(v) / len(v) if v else empty
    return scoring.Scores(avg(ctc_scores), avg(wer_scores))


def _write_epoch(metrics_path: str, tb_writer, epoch: int, train: scoring.Scores,
                 clean: scoring.Scores, pert: scoring.Scores, step_ms: float, lr: float,
                 extra: dict | None = None) -> None:
    """One epoch's line of metrics.jsonl and, with a writer, its
    TensorBoard scalars; ``extra`` holds further ``eval_*`` fields."""
    extra = extra or {}
    with open(metrics_path, "a") as f:
        f.write(json.dumps({
            "epoch": epoch, "train_ctc": train.ctc, "train_wer": train.wer,
            "eval_clean_ctc": clean.ctc, "eval_clean_wer": clean.wer,
            "eval_pert_ctc": pert.ctc, "eval_pert_wer": pert.wer,
            "step_time_ms": step_ms, "lr": lr, **extra,
        }) + "\n")
    if tb_writer is not None:
        tb_writer.scalars({
            "train/ctc": train.ctc, "train/wer": train.wer,
            "eval/clean_ctc": clean.ctc, "eval/clean_wer": clean.wer,
            "eval/pert_ctc": pert.ctc, "eval/pert_wer": pert.wer,
            "train/step_time_ms": step_ms, "train/lr": lr,
            **{f"eval/{k[len('eval_'):]}": v for k, v in extra.items()},
        }, step=epoch)
        tb_writer.flush()


def _running_scores(history: dict, mode: str) -> dict:
    """results.json's best-so-far perturbed-eval and train scores."""
    agg = lambda key: scoring.best_agg(history[key], mode)
    return {"eval_score_perturbed": {"ctc": agg("eval_pert_ctc"), "wer": agg("eval_pert_wer")},
            "train_score": {"ctc": agg("train_ctc"), "wer": agg("train_wer")}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AttackRunner:
    """The steps, tables and data feed of one attack configuration on the
    device of the model's parameters, over the run's mesh.

    ``mesh``: "auto" takes the reference's choice, ``decide_mesh(cfg.tp,
    cfg.batch_size)`` over the world's ranks (``tp > 1`` checks the model
    axis first); None runs the one-device steps; a mesh with a ``data``
    axis (the sweep passes its own) shards the batch over it. On a mesh
    with a ``model`` axis the runner keeps this rank's shard of ``model``.

    The train and eval batches come from ``corpora`` (default: a
    :class:`~paa_tpu_torch.data.pipeline.CorpusCache` of its own under
    ``cfg.cache_data_on_device``; the sweep passes one for all its norms);
    the initial perturbation and the inspected samples collate on the host,
    as in the JAX package."""

    def __init__(self, cfg: AttackConfig, model: torch.nn.Module,
                 pipe: pipeline_lib.DataPipeline, cparams: ConstraintParams | None = None,
                 mesh="auto", corpora: pipeline_lib.CorpusCache | None = None):
        if isinstance(mesh, str):
            if cfg.tp > 1:
                tp_lib.check_model_axis(wav2vec2.get_config(cfg.model_name), cfg.tp)
            mesh = mesh_lib.decide_mesh(cfg.tp, cfg.batch_size)
        self.mesh = mesh
        self.cfg = cfg
        self.pipe = pipe
        self.model = tp_lib.shard_model(model, mesh)
        self.device = next(model.parameters()).device
        cparams = cparams if cparams is not None else ConstraintParams.create()
        self.cparams = ConstraintParams(*(t.to(self.device) for t in cparams))
        self.tables = psycho.build_tables(cfg, self.device)
        self.train_step = attack_step.make_sharded_step(cfg, self.model, self.tables, mesh)
        self.eval_step = attack_step.make_sharded_eval_step(cfg, self.model, mesh)
        if mesh is not None:
            logger.info("mesh %s over %d ranks", mesh.shape, mesh.size)
        # each split staged at its first use under cfg.cache_data_on_device
        self.corpora = corpora if corpora is not None else pipeline_lib.CorpusCache(
            cfg.cache_data_on_device, self.device, mesh=mesh)
        self._tgt = None
        if cfg.attack_mode == "targeted":
            tl, tp = _targeted_labels(cfg, cfg.batch_size, pipe.train.labels.shape[1],
                                      audio_len=pipe.audio_len)
            self._tgt = (torch.from_numpy(tl).to(self.device),
                         torch.from_numpy(tp).to(self.device))

    def _batches(self, split: pipeline_lib.Split, shuffle_rng=None):
        return self.corpora.batches(split, self.cfg.batch_size, shuffle_rng=shuffle_rng)

    def _labels(self, batch):
        return self._tgt if self._tgt is not None else (batch.labels, batch.label_paddings)

    # -- perturbation lifecycle ------------------------------------------

    def init_perturbation(self, seed: int, cparams: ConstraintParams | None = None) -> torch.Tensor:
        """randn(1, audio_len) from a CPU generator seeded with ``seed``,
        projected once with ``cparams`` (default: the runner's). SNR and TV
        size their ball from the first train batch. (The JAX package draws
        from ``jax.random``, which torch does not reproduce; pass ``init_p``
        to :func:`run_attack` for a run that starts where a JAX run starts.)"""
        gen = torch.Generator().manual_seed(seed)
        p = torch.randn((1, self.pipe.audio_len), generator=gen).to(self.device)
        clean = None
        if self.cfg.norm_type in ("snr", "tv"):
            first = next(self.pipe.train.batches(self.cfg.batch_size))
            clean = torch.from_numpy(first.audio).to(self.device)
        p = projections.perturbation_constraint(
            p, clean, self.cfg, self.cparams if cparams is None else cparams, self.tables)
        logger.info("Perturbation waveform shape: %s", tuple(p.shape))
        return p

    # -- epochs ------------------------------------------------------------

    def train_epoch(self, p, opt_state, epoch: int, shuffle_rng) -> tuple:
        cfg = self.cfg
        lr = optimizers.step_lr(cfg, epoch)
        # metrics stay on the device until every step of the epoch is queued
        pending = []
        _sync(self.device)
        t0 = time.perf_counter()
        for batch in self._batches(self.pipe.train, shuffle_rng):
            labels, pads = self._labels(batch)
            p, opt_state, m = self.train_step(p, opt_state, batch.audio, labels, pads,
                                              batch.weights, self.cparams, lr)
            pending.append((m, pipeline_lib.host_mask(batch), batch.indices))
        _sync(self.device)
        step_time = (time.perf_counter() - t0) / max(len(pending), 1)
        return p, opt_state, _scores(pending, self.pipe.train.texts, 0.0), step_time

    def evaluate(self, split: pipeline_lib.Split, p, perturbed: bool, return_preds: bool = False):
        """Clean pass with p = 0; perturbed adds p unclamped. Targeted runs
        swap the loss labels; WER stays against the ground truth. With
        ``return_preds`` returns ``(Scores, preds)``, the lowercased greedy
        decodes in split order."""
        p_eff = p if perturbed else torch.zeros_like(p)
        pending = []
        for batch in self._batches(split):
            labels, pads = self._labels(batch)
            m = self.eval_step(p_eff, batch.audio, labels, pads, batch.weights)
            pending.append((m, pipeline_lib.host_mask(batch), batch.indices))
        preds = [] if return_preds else None
        scores = _scores(pending, split.texts, float("inf"), preds)
        return (scores, preds) if return_preds else scores

    def inspect_samples(self, p, num_items: int, seed: int = 0) -> list[dict]:
        """Random test samples: clean and perturbed audio and the prediction
        triple, for ``artifacts.inspect_samples``."""
        split = self.pipe.test
        rng = np.random.default_rng(seed)
        n = min(num_items, len(split))
        idx = rng.choice(len(split), size=n, replace=False)
        p_np = p.detach().cpu().numpy()[0]
        out = []
        for start in range(0, n, self.cfg.batch_size):
            host = split.collate(idx[start : start + self.cfg.batch_size], self.cfg.batch_size)
            batch = pipeline_lib.to_device(host, self.device)
            args = (batch.audio, batch.labels, batch.label_paddings, batch.weights)
            clean_m = self.eval_step(torch.zeros_like(p), *args)
            pert_m = self.eval_step(p, *args)
            clean_preds = text_ops.decode_batch(clean_m.greedy_ids.cpu().numpy())
            pert_preds = text_ops.decode_batch(pert_m.greedy_ids.cpu().numpy())
            for j in np.flatnonzero(host.weights > 0):
                audio = host.audio[j]
                out.append(dict(
                    clean=audio,
                    perturbed=np.clip(audio + p_np[: len(audio)], -1, 1),
                    ground_truth=split.texts[int(host.indices[j])],
                    clean_pred=clean_preds[j].lower(),
                    pert_pred=pert_preds[j].lower(),
                ))
        return out


def run_attack(
    cfg: AttackConfig,
    model: torch.nn.Module,
    pipe: pipeline_lib.DataPipeline,
    save_dir: str,
    cparams: ConstraintParams | None = None,
    num_items_to_inspect: int = 12,
    resume: bool = True,
    init_p: np.ndarray | None = None,
    debug_plots: bool = False,
    tensorboard: bool = False,
) -> RunResult:
    """Full attack run with best-tracking, early stopping and artifacts, on
    the device of ``model``. ``init_p`` warm-starts from a saved
    perturbation; ``debug_plots`` draws the projection debug panels on each
    improving epoch; ``tensorboard`` mirrors the per-epoch metrics to
    ``save_dir/tb/``. Under ``torchrun`` every rank calls it; rank 0
    writes."""
    writer = mesh_lib.is_writer()
    if writer:
        os.makedirs(save_dir, exist_ok=True)
    runner = AttackRunner(cfg, model, pipe, cparams)
    cparams, device = runner.cparams, runner.device
    size_str = attack_size_value(cfg, cparams)

    if init_p is not None:
        if init_p.shape[-1] != pipe.audio_len:
            raise ValueError(
                f"Loaded perturbation length {init_p.shape[-1]} != expected {pipe.audio_len}")
        p = torch.from_numpy(np.asarray(init_p, np.float32).reshape(1, -1)).to(device)
    else:
        p = runner.init_perturbation(cfg.seed)
    p = mesh_lib.broadcast(p.contiguous(), src=0)
    opt_state = optimizers.init_opt_state(cfg, p)

    history = {
        "train_ctc": [], "train_wer": [],
        "eval_clean_ctc": [], "eval_clean_wer": [],
        "eval_pert_ctc": [], "eval_pert_wer": [],
    }
    targeted = cfg.attack_mode == "targeted"
    if targeted:
        history["eval_emission_rate"] = []
        history["eval_wer_to_target"] = []
    start_epoch = 0
    best_epoch = -1
    no_improve = 0
    best_eval_score = scoring.initial_best(cfg.attack_mode)
    best_p = p.detach().cpu().numpy()

    ckpt_path = os.path.join(save_dir, checkpoint.STATE_FILE)
    pert_path = os.path.join(save_dir, "perturbation.npy")
    found, path = checkpoint.discover_resume(save_dir)
    if resume and found:
        state = checkpoint.load_checkpoint(path, {"history": history})
        p = state["p"].to(device)
        if state["opt_state"] is not None:
            opt_state = optimizers.AdamState(
                *(state["opt_state"][k].to(device) for k in optimizers.AdamState._fields))
        start_epoch = int(state["epoch"]) + 1
        best_epoch = int(state["best_epoch"])
        no_improve = int(state["no_improve"])
        best_eval_score = float(state["best_eval_score"])
        best_p = state["best_p"].numpy()
        history = {k: v.tolist() for k, v in state["history"].items()}
        logger.info("Resuming from checkpoint: %s (epoch=%d)", path, start_epoch)
    # every rank has read the state before rank 0 writes the next one
    mesh_lib.barrier()

    # the metric stream keeps only epochs before the resume point
    metrics_path = os.path.join(save_dir, "metrics.jsonl")
    if writer:
        _truncate_metrics(metrics_path, start_epoch)
    tb_writer = None
    if tensorboard and writer:
        from paa_tpu_torch.train import tb_events

        tb_writer = tb_events.EventWriter(os.path.join(save_dir, "tb"))

    clean_eval_cache = None
    step_ms = 0.0
    for epoch in range(start_epoch, cfg.num_epochs):
        if no_improve >= cfg.early_stopping:
            logger.info("resumed run already early-stopped; finalizing")
            break
        logger.info("starting epoch: %d", epoch)
        data_rng = np.random.default_rng((cfg.seed, epoch))
        p, opt_state, train_scores, step_time = runner.train_epoch(
            p, opt_state, epoch, shuffle_rng=data_rng)
        step_ms = 1000.0 * step_time
        # the clean pass does not depend on p: evaluate once
        if clean_eval_cache is None:
            clean_eval_cache = runner.evaluate(pipe.eval, p, perturbed=False)
        clean = clean_eval_cache
        emis = None
        if targeted:
            pert, pert_preds = runner.evaluate(pipe.eval, p, perturbed=True, return_preds=True)
            emis = scoring.emission_metrics(pert_preds, cfg.target, cfg.target_reps)
            history["eval_emission_rate"].append(emis["emission_rate"])
            history["eval_wer_to_target"].append(emis["wer_to_target"])
            logger.info("targeted: emission_rate=%.4f wer_to_target=%.4f",
                        emis["emission_rate"], emis["wer_to_target"])
        else:
            pert = runner.evaluate(pipe.eval, p, perturbed=True)

        history["train_ctc"].append(train_scores.ctc)
        history["train_wer"].append(train_scores.wer)
        history["eval_clean_ctc"].append(clean.ctc)
        history["eval_clean_wer"].append(clean.wer)
        history["eval_pert_ctc"].append(pert.ctc)
        history["eval_pert_wer"].append(pert.wer)

        log_helpers.log_epoch_metrics(
            epoch, cfg.num_epochs,
            train_ctc=train_scores.ctc, eval_ctc_clean=clean.ctc,
            eval_ctc_perturbed=pert.ctc, train_wer=train_scores.wer,
            eval_wer_clean=clean.wer, eval_wer_perturbed=pert.wer,
            step_time_ms=step_ms,
        )
        emis_fields = ({"eval_emission_rate": emis["emission_rate"],
                        "eval_wer_to_target": emis["wer_to_target"]} if emis else {})
        if writer:
            _write_epoch(metrics_path, tb_writer, epoch, train_scores, clean, pert, step_ms,
                         optimizers.step_lr(cfg, epoch), emis_fields)
            artifacts.save_loss_plot(
                {"ctc": history["train_ctc"], "wer": history["train_wer"]},
                {"ctc": history["eval_clean_ctc"], "wer": history["eval_clean_wer"]},
                {"ctc": history["eval_pert_ctc"], "wer": history["eval_pert_wer"]},
                save_dir, cfg.norm_type,
            )
            artifacts.save_json_results(
                save_dir, cfg.norm_type, size_str,
                epoch=epoch, finished_training=False,
                eval_score_clean={"ctc": clean.ctc, "wer": clean.wer},
                **_running_scores(history, cfg.attack_mode),
                steps_per_sec=(1000.0 / step_ms if step_ms else None),
            )

        # the branch below gates collectives (inspection's eval steps, the
        # next epoch): rank 0's score decides it on every rank
        (current,) = mesh_lib.agree([pert.wer if targeted else pert.ctc])
        if scoring.is_better(current, best_eval_score, cfg.attack_mode):
            no_improve = 0
            best_eval_score = current
            best_epoch = epoch
            best_p = p.detach().cpu().numpy()
            if writer:
                checkpoint.save_perturbation(pert_path, best_p)
                artifacts.save_epoch_bundle(save_dir, best_p[0], cfg)
                if debug_plots:
                    artifacts.save_debug_plots(save_dir, best_p, cfg, cparams, runner.tables,
                                               tag=f"epoch{epoch}")
            if num_items_to_inspect > 0:
                samples = runner.inspect_samples(p, num_items_to_inspect)
                if writer:
                    artifacts.inspect_samples(save_dir, samples, cfg.attack_mode, cfg.target,
                                              cfg.sr)
        else:
            no_improve += 1

        if writer:
            checkpoint.save_checkpoint(ckpt_path, {
                "p": p,
                "opt_state": None if opt_state is None else opt_state._asdict(),
                "epoch": epoch, "best_epoch": best_epoch, "no_improve": no_improve,
                "best_eval_score": best_eval_score, "best_p": best_p,
                "history": {k: torch.tensor(v, dtype=torch.float64) for k, v in history.items()},
            })
        if no_improve >= cfg.early_stopping:
            logger.info("No improvements in %d epochs. Stopping early.", no_improve)
            break

    # -- finalize: the best p on the test split
    p = torch.from_numpy(best_p).to(device)
    test_emis = None
    if targeted:
        pert_test, test_preds = runner.evaluate(pipe.test, p, perturbed=True, return_preds=True)
        clean_test, clean_preds = runner.evaluate(pipe.test, p, perturbed=False,
                                                  return_preds=True)
        test_emis = {
            "perturbed": scoring.emission_metrics(test_preds, cfg.target, cfg.target_reps),
            # clean emission is the false-positive floor
            "clean": scoring.emission_metrics(clean_preds, cfg.target, cfg.target_reps),
        }
        logger.info("targeted test: emission_rate=%.4f (clean floor %.4f) wer_to_target=%.4f",
                    test_emis["perturbed"]["emission_rate"],
                    test_emis["clean"]["emission_rate"],
                    test_emis["perturbed"]["wer_to_target"])
    else:
        pert_test = runner.evaluate(pipe.test, p, perturbed=True)
        clean_test = runner.evaluate(pipe.test, p, perturbed=False)

    if writer:
        artifacts.save_loss_plot(
            {"ctc": history["train_ctc"], "wer": history["train_wer"]},
            {"ctc": history["eval_clean_ctc"], "wer": history["eval_clean_wer"]},
            {"ctc": history["eval_pert_ctc"], "wer": history["eval_pert_wer"]},
            save_dir, cfg.norm_type,
            clean_test_loss={"ctc": clean_test.ctc, "wer": clean_test.wer},
            perturbed_test_loss={"ctc": pert_test.ctc, "wer": pert_test.wer},
        )
        artifacts.save_json_results(
            save_dir, cfg.norm_type, size_str,
            epoch=best_epoch, finished_training=True, best_epoch=best_epoch,
            best_train_score=_running_scores(history, cfg.attack_mode)["train_score"],
            eval_score_clean={"ctc": clean_test.ctc, "wer": clean_test.wer},
            eval_score_perturbed={"ctc": pert_test.ctc, "wer": pert_test.wer},
            final_test_clean={"ctc": clean_test.ctc, "wer": clean_test.wer},
            final_test_perturbed={"ctc": pert_test.ctc, "wer": pert_test.wer},
            steps_per_sec=(1000.0 / step_ms if step_ms else None),
            **({"targeted_metrics": test_emis} if test_emis is not None else {}),
        )
    log_helpers.log_summary_metrics(
        norm_type=cfg.norm_type, attack_size_string=str(size_str),
        clean_ctc_test=clean_test.ctc, clean_wer_test=clean_test.wer,
        pert_ctc_test=pert_test.ctc, pert_wer_test=pert_test.wer,
        best_epoch=best_epoch,
    )
    if tb_writer is not None:
        tb_writer.scalars({
            "test/clean_ctc": clean_test.ctc, "test/clean_wer": clean_test.wer,
            "test/pert_ctc": pert_test.ctc, "test/pert_wer": pert_test.wer,
        }, step=best_epoch)
        tb_writer.close()
    return RunResult(best_epoch=best_epoch, test_clean=clean_test, test_perturbed=pert_test,
                     perturbation=best_p, history=history)
