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
    function of (seed, epoch);
  * the ε sweep (cli/sweep.py) runs its epochs through the same train and
    eval passes with its own steps, and keeps one :class:`CellRecord`, the
    run's record, per cell.

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
from paa_tpu_torch.models import presets
from paa_tpu_torch.ops import projections, psycho
from paa_tpu_torch.parallel import mesh as mesh_lib, tp as tp_lib
from paa_tpu_torch.spans import span
from paa_tpu_torch.train import checkpoint

logger = logging.getLogger("paa_tpu")

# the series every cell records an epoch of, and those a targeted run adds
HISTORY_KEYS = ("train_ctc", "train_wer", "eval_clean_ctc", "eval_clean_wer",
                "eval_pert_ctc", "eval_pert_wer")
TARGETED_KEYS = ("eval_emission_rate", "eval_wer_to_target")


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
        frames = presets.get_config(cfg.model_name).feat_extract_output_length(audio_len)
        row = labels[0][paddings[0] < 0.5]
        need = len(row) + int(np.sum(row[1:] == row[:-1]))
        if need > frames:
            raise ValueError(
                f"targeted label ({cfg.target!r} × {cfg.target_reps}) needs {need} CTC "
                f"frames but the model emits only {frames} for {audio_len}-sample audio — "
                "every step's loss would be inf. Reduce --target_reps or shorten --target.")
    return labels, paddings


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
    with span("paa.score"):
        for m, w, indices in pending:
            with span("paa.score.wait"):
                ctc_scores.append(float(m.ctc_loss))
            with span("paa.score.wait"):
                ids = m.greedy_ids.cpu()
            batch_wer, batch_preds = _batch_wer(ids.numpy()[w], [texts[i] for i in indices[w]])
            wer_scores.append(batch_wer)
            if preds is not None:
                preds.extend(batch_preds)
    avg = lambda v: sum(v) / len(v) if v else empty
    return scoring.Scores(avg(ctc_scores), avg(wer_scores))


def cell_scores(pending: list, texts: list[str], empty: float, cells) -> list[scoring.Scores]:
    """The Scores of each cell of ``cells`` from the ``pending`` of a pass of
    a sweep step, whose metrics stack along the cell axis."""
    return [_scores([(attack_step.cell(m, j), w, idx) for m, w, idx in pending], texts, empty)
            for j in cells]


def _epoch_of(line: str, default: int) -> int:
    """The epoch of a metrics.jsonl line; ``default`` for one without."""
    try:
        return json.loads(line).get("epoch", default)
    except json.JSONDecodeError:
        return default


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CellRecord:
    """One attack cell's record and run directory: the history of the
    epochs it trained, its best score, epoch and perturbation, and its
    early-stop count. :func:`run_attack` keeps one; the sweep keeps one per
    cell. Only the writer rank writes; ``rate_key`` names results.json's
    throughput field."""

    def __init__(self, cfg: AttackConfig, save_dir: str, size, p: torch.Tensor,
                 keys=HISTORY_KEYS, rate_key: str = "steps_per_sec"):
        self.cfg, self.save_dir, self.size, self.rate_key = cfg, save_dir, size, rate_key
        self.writer = mesh_lib.is_writer()
        if self.writer:
            os.makedirs(save_dir, exist_ok=True)
        self.history = {k: [] for k in keys}
        self.best_score = scoring.initial_best(cfg.attack_mode)
        self.best_epoch, self.no_improve = -1, 0
        self.best_p = p.detach().cpu().numpy().copy()
        self.tb = None

    @property
    def stopped(self) -> bool:
        return self.no_improve >= self.cfg.early_stopping

    def state(self) -> dict:
        """The record's part of a checkpoint."""
        return {"best_epoch": self.best_epoch, "no_improve": self.no_improve,
                "best_eval_score": self.best_score, "best_p": self.best_p,
                "history": {k: torch.tensor(v, dtype=torch.float64)
                            for k, v in self.history.items()}}

    def load(self, state: dict) -> None:
        """Take the record's part of a loaded checkpoint."""
        self.best_epoch = int(state["best_epoch"])
        self.no_improve = int(state["no_improve"])
        self.best_score = float(state["best_eval_score"])
        self.best_p = state["best_p"].numpy()
        self.history = {k: state["history"][k].tolist() for k in self.history}

    def open(self, start_epoch: int, tensorboard: bool) -> None:
        """Keep only the metrics.jsonl lines of epochs before
        ``start_epoch``; with ``tensorboard``, mirror the scalars to
        ``save_dir/tb/``."""
        if not self.writer:
            return
        path = os.path.join(self.save_dir, "metrics.jsonl")
        if os.path.exists(path) and start_epoch <= 0:
            os.remove(path)
        elif os.path.exists(path):
            with open(path) as f:
                kept = [line for line in f if _epoch_of(line, start_epoch) < start_epoch]
            with open(path, "w") as f:
                f.writelines(kept)
        if tensorboard:
            from paa_tpu_torch.train import tb_events

            self.tb = tb_events.EventWriter(os.path.join(self.save_dir, "tb"))

    def running_scores(self) -> dict:
        """results.json's best-so-far perturbed-eval and train scores."""
        agg = lambda key: scoring.best_agg(self.history[key], self.cfg.attack_mode)
        return {"eval_score_perturbed": {"ctc": agg("eval_pert_ctc"), "wer": agg("eval_pert_wer")},
                "train_score": {"ctc": agg("train_ctc"), "wer": agg("train_wer")}}

    def add_epoch(self, epoch: int, train: scoring.Scores, clean: scoring.Scores,
                  pert: scoring.Scores, step_ms: float, lr: float, rate: float | None,
                  extra: dict | None = None) -> None:
        """An epoch's scores into the history, its metrics.jsonl line and
        TensorBoard scalars, and the running results.json; ``extra`` holds
        further ``eval_*`` series."""
        extra = extra or {}
        row = dict(zip(HISTORY_KEYS, (train.ctc, train.wer, clean.ctc, clean.wer,
                                      pert.ctc, pert.wer)))
        for k, v in {**row, **extra}.items():
            self.history[k].append(v)
        if not self.writer:
            return
        with open(os.path.join(self.save_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch, **row, "step_time_ms": step_ms, "lr": lr,
                                **extra}) + "\n")
        if self.tb is not None:
            # train_ctc is train/ctc, eval_clean_ctc eval/clean_ctc
            tags = lambda d: {k.replace("_", "/", 1): v for k, v in d.items()}
            self.tb.scalars({**tags(row), "train/step_time_ms": step_ms, "train/lr": lr,
                             **tags(extra)}, step=epoch)
            self.tb.flush()
        artifacts.save_json_results(
            self.save_dir, self.cfg.norm_type, self.size, epoch=epoch, finished_training=False,
            eval_score_clean=dataclasses.asdict(clean), **self.running_scores(),
            **{self.rate_key: rate})

    def judge(self, epoch: int, score: float, p: torch.Tensor) -> bool:
        """Whether ``score`` beats the best so far; if so ``p`` becomes the
        best and is written to perturbation.npy, else the early-stop count
        grows."""
        if not scoring.is_better(score, self.best_score, self.cfg.attack_mode):
            self.no_improve += 1
            return False
        self.no_improve, self.best_score, self.best_epoch = 0, score, epoch
        self.best_p = p.detach().cpu().numpy().copy()
        if self.writer:
            checkpoint.save_perturbation(os.path.join(self.save_dir, "perturbation.npy"),
                                         self.best_p)
        return True

    def save_loss_plot(self, clean_test: scoring.Scores | None = None,
                       pert_test: scoring.Scores | None = None) -> None:
        """The CTC and WER curves so far, with the test scores' levels if
        given."""
        if self.writer:
            h = self.history
            curves = ({"ctc": h[f"{k}_ctc"], "wer": h[f"{k}_wer"]}
                      for k in ("train", "eval_clean", "eval_pert"))
            tests = {} if clean_test is None else {
                "clean_test_loss": dataclasses.asdict(clean_test),
                "perturbed_test_loss": dataclasses.asdict(pert_test)}
            artifacts.save_loss_plot(*curves, self.save_dir, self.cfg.norm_type, **tests)

    def finish(self, clean_test: scoring.Scores, pert_test: scoring.Scores, rate: float | None,
               **extra) -> None:
        """The final results.json of the best p's test scores, and their
        TensorBoard scalars at the best epoch; ``extra`` holds further
        fields."""
        clean, pert = dataclasses.asdict(clean_test), dataclasses.asdict(pert_test)
        if self.writer:
            artifacts.save_json_results(
                self.save_dir, self.cfg.norm_type, self.size,
                epoch=self.best_epoch, finished_training=True, best_epoch=self.best_epoch,
                best_train_score=self.running_scores()["train_score"],
                eval_score_clean=clean, eval_score_perturbed=pert,
                final_test_clean=clean, final_test_perturbed=pert,
                **{self.rate_key: rate}, **extra)
        if self.tb is not None:
            self.tb.scalars({f"test/{name}_{k}": v for name, s in (("clean", clean), ("pert", pert))
                             for k, v in s.items()}, step=self.best_epoch)
            self.tb.close()


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
                tp_lib.check_model_axis(presets.get_config(cfg.model_name), cfg.tp)
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

    def train_pass(self, step, p, opt_state, lr: float, shuffle_rng, *cell_args) -> tuple:
        """One pass of ``step(p, opt_state, audio, labels, label_paddings,
        weights, *cell_args, lr)`` over the train split in ``shuffle_rng``'s
        order; targeted runs swap the loss labels. Returns the new p and
        optimizer state, each batch's metrics (left on the device until every
        step is queued) with its host row mask and row indices, and the
        pass's wall seconds."""
        pending = []
        _sync(self.device)
        t0 = time.perf_counter()
        for batch in self.corpora.batches(self.pipe.train, self.cfg.batch_size,
                                          shuffle_rng=shuffle_rng):
            labels, pads = self._tgt or (batch.labels, batch.label_paddings)
            p, opt_state, m = step(p, opt_state, batch.audio, labels, pads, batch.weights,
                                   *cell_args, lr)
            pending.append((m, pipeline_lib.host_mask(batch), batch.indices))
        _sync(self.device)
        return p, opt_state, pending, time.perf_counter() - t0

    def eval_pass(self, step, split: pipeline_lib.Split, p) -> list:
        """``step(p, audio, labels, label_paddings, weights)`` over ``split``:
        each batch's metrics with its host row mask and row indices."""
        pending = []
        for batch in self.corpora.batches(split, self.cfg.batch_size):
            labels, pads = self._tgt or (batch.labels, batch.label_paddings)
            m = step(p, batch.audio, labels, pads, batch.weights)
            pending.append((m, pipeline_lib.host_mask(batch), batch.indices))
        return pending

    def train_epoch(self, p, opt_state, epoch: int, shuffle_rng) -> tuple:
        p, opt_state, pending, seconds = self.train_pass(
            self.train_step, p, opt_state, optimizers.step_lr(self.cfg, epoch), shuffle_rng,
            self.cparams)
        step_time = seconds / max(len(pending), 1)
        return p, opt_state, _scores(pending, self.pipe.train.texts, 0.0), step_time

    def evaluate(self, split: pipeline_lib.Split, p, perturbed: bool, return_preds: bool = False):
        """Clean pass with p = 0; perturbed adds p unclamped. Targeted runs
        swap the loss labels; WER stays against the ground truth. With
        ``return_preds`` returns ``(Scores, preds)``, the lowercased greedy
        decodes in split order."""
        pending = self.eval_pass(self.eval_step, split, p if perturbed else torch.zeros_like(p))
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
    runner = AttackRunner(cfg, model, pipe, cparams)
    cparams, device = runner.cparams, runner.device

    if init_p is not None:
        if init_p.shape[-1] != pipe.audio_len:
            raise ValueError(
                f"Loaded perturbation length {init_p.shape[-1]} != expected {pipe.audio_len}")
        p = torch.from_numpy(np.asarray(init_p, np.float32).reshape(1, -1)).to(device)
    else:
        p = runner.init_perturbation(cfg.seed)
    p = mesh_lib.broadcast(p.contiguous(), src=0)
    opt_state = optimizers.init_opt_state(cfg, p)

    targeted = cfg.attack_mode == "targeted"
    record = CellRecord(cfg, save_dir, attack_size_value(cfg, cparams), p,
                        HISTORY_KEYS + (TARGETED_KEYS if targeted else ()))
    start_epoch = 0
    ckpt_path = os.path.join(save_dir, checkpoint.STATE_FILE)
    found, path = checkpoint.discover_resume(save_dir)
    if resume and found:
        state = checkpoint.load_checkpoint(path, {"history": record.history})
        p = state["p"].to(device)
        if state["opt_state"] is not None:
            opt_state = optimizers.AdamState(
                *(state["opt_state"][k].to(device) for k in optimizers.AdamState._fields))
        start_epoch = int(state["epoch"]) + 1
        record.load(state)
        logger.info("Resuming from checkpoint: %s (epoch=%d)", path, start_epoch)
    # every rank has read the state before rank 0 writes the next one
    mesh_lib.barrier()
    # the metric stream keeps only epochs before the resume point
    record.open(start_epoch, tensorboard)

    clean = rate = None
    for epoch in range(start_epoch, cfg.num_epochs):
        if record.stopped:
            logger.info("resumed run already early-stopped; finalizing")
            break
        logger.info("starting epoch: %d", epoch)
        data_rng = np.random.default_rng((cfg.seed, epoch))
        p, opt_state, train_scores, step_time = runner.train_epoch(
            p, opt_state, epoch, shuffle_rng=data_rng)
        step_ms = 1000.0 * step_time
        # the clean pass does not depend on p: evaluate once
        if clean is None:
            clean = runner.evaluate(pipe.eval, p, perturbed=False)
        pert, pert_preds = runner.evaluate(pipe.eval, p, perturbed=True, return_preds=True)
        emis = {}
        if targeted:
            m = scoring.emission_metrics(pert_preds, cfg.target, cfg.target_reps)
            emis = {f"eval_{k}": m[k] for k in ("emission_rate", "wer_to_target")}
            logger.info("targeted: emission_rate=%.4f wer_to_target=%.4f",
                        m["emission_rate"], m["wer_to_target"])

        log_helpers.log_epoch_metrics(
            epoch, cfg.num_epochs,
            train_ctc=train_scores.ctc, eval_ctc_clean=clean.ctc,
            eval_ctc_perturbed=pert.ctc, train_wer=train_scores.wer,
            eval_wer_clean=clean.wer, eval_wer_perturbed=pert.wer,
            step_time_ms=step_ms,
        )
        rate = 1000.0 / step_ms if step_ms else None
        record.add_epoch(epoch, train_scores, clean, pert, step_ms,
                         optimizers.step_lr(cfg, epoch), rate, emis)
        record.save_loss_plot()

        # the branch below gates collectives (inspection's eval steps, the
        # next epoch): rank 0's score decides it on every rank
        (current,) = mesh_lib.agree([pert.wer if targeted else pert.ctc])
        if record.judge(epoch, current, p):
            if writer:
                artifacts.save_epoch_bundle(save_dir, record.best_p[0], cfg)
                if debug_plots:
                    artifacts.save_debug_plots(save_dir, record.best_p, cfg, cparams,
                                               runner.tables, tag=f"epoch{epoch}")
            if num_items_to_inspect > 0:
                samples = runner.inspect_samples(p, num_items_to_inspect)
                if writer:
                    artifacts.inspect_samples(save_dir, samples, cfg.attack_mode, cfg.target,
                                              cfg.sr)

        if writer:
            checkpoint.save_checkpoint(ckpt_path, {
                "p": p, "opt_state": None if opt_state is None else opt_state._asdict(),
                "epoch": epoch, **record.state()})
        if record.stopped:
            logger.info("No improvements in %d epochs. Stopping early.", record.no_improve)
            break

    # -- finalize: the best p on the test split
    p = torch.from_numpy(record.best_p).to(device)
    pert_test, test_preds = runner.evaluate(pipe.test, p, perturbed=True, return_preds=True)
    clean_test, clean_preds = runner.evaluate(pipe.test, p, perturbed=False, return_preds=True)
    test_emis = None
    if targeted:
        test_emis = {
            "perturbed": scoring.emission_metrics(test_preds, cfg.target, cfg.target_reps),
            # clean emission is the false-positive floor
            "clean": scoring.emission_metrics(clean_preds, cfg.target, cfg.target_reps),
        }
        logger.info("targeted test: emission_rate=%.4f (clean floor %.4f) wer_to_target=%.4f",
                    test_emis["perturbed"]["emission_rate"],
                    test_emis["clean"]["emission_rate"],
                    test_emis["perturbed"]["wer_to_target"])

    record.save_loss_plot(clean_test, pert_test)
    record.finish(clean_test, pert_test, rate, targeted_metrics=test_emis)
    log_helpers.log_summary_metrics(
        norm_type=cfg.norm_type, attack_size_string=str(record.size),
        clean_ctc_test=clean_test.ctc, clean_wer_test=clean_test.wer,
        pert_ctc_test=pert_test.ctc, pert_wer_test=pert_test.wer,
        best_epoch=record.best_epoch,
    )
    return RunResult(best_epoch=record.best_epoch, test_clean=clean_test,
                     test_perturbed=pert_test, perturbation=record.best_p,
                     history=record.history)
