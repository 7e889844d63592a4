"""The ε sweep — ``python -m paa_tpu_torch.cli.sweep <flags>``.

The port of ``paa_tpu/cli/sweep.py``. The reference farms the (norm_type
× epsilon) grid to sbatch, one GPU per cell, and each cell runs the full
attack loop (reference: submit_scan_range.py:8-143 driving
src/run_attack.py:61-183). Here a sweep runs in one program with the same
per-cell semantics:

  * all epsilons of one norm type train together on a ``(sweep, data)``
    mesh of the ranks (one process without ``torchrun``): with one sweep
    slice per cell (``_ns_for``) each slice trains its own cell, the batch
    split over the slice's data axis; otherwise every shared batch runs the
    single-cell step once per live cell over all the ranks
    (attack/step.py:make_sweep_step, the host-multiplexed form), so data and
    model are shared and one cell's activations are alive at a time. Every
    rank holds every cell's state after each step, so a rebuild over the
    surviving cells finds each cell's p and optimizer state on its new
    owner;
  * the feed is the single run's (``AttackRunner``'s, ``--device_cache``
    or auto), with each split staged once for the whole sweep, every norm
    and every rebuild over fewer cells included;
  * every cell starts from the perturbation a standalone run with this
    seed starts from (``AttackRunner.init_perturbation``: torch's RNG, then
    the cell's projection);
  * per epoch, every cell is evaluated on the eval split (one clean pass,
    ``AttackRunner.evaluate``, then the sweep eval step over the cells),
    with per-cell best-p tracking and early stopping; a stopped cell leaves
    the device state at once in the multiplexed form, and once at most half
    the cells survive in the sharded one;
  * the sweep checkpoints per epoch and resumes exactly (the batch order is
    a pure function of (seed, epoch), as in train/loop.py), and refuses a
    checkpoint written under another configuration;
  * each epoch is the single run's train pass and eval pass
    (``AttackRunner.train_pass``, ``eval_pass``) with the sweep's steps, and
    each cell keeps the single run's record (``loop.CellRecord``: history,
    best p, early stop, ``metrics.jsonl`` and ``results.json``), so the two
    loops cannot drift; ``sweep_results.json`` sums the norm up. Under
    ``torchrun`` rank 0 alone writes.

The sweep state is ``sweep_state_<norm>.pt`` (``torch.save`` of CPU
tensors, read with ``weights_only=True``); the JAX package writes flax
msgpack, ``sweep_state_<norm>.msgpack``, and neither resumes the other's.
``--tp > 1`` is refused, as the reference refuses it: the sweep's mesh has
no ``model`` axis. Default grids mirror submit_scan_range.py:80-88 (grids
left empty there get the flag defaults as a single cell).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from paa_tpu_torch.attack import optimizers, step as attack_step
from paa_tpu_torch.cli import parser as parser_lib, run_attack as run_attack_cli
from paa_tpu_torch.config import ConstraintParams, with_sweep_value
from paa_tpu_torch.data import pipeline as pipeline_lib
from paa_tpu_torch.parallel import mesh as mesh_lib
from paa_tpu_torch.train import artifacts, checkpoint, log_helpers, loop, scoring

# Reference grids: submit_scan_range.py:80-88.
DEFAULT_GRIDS = {
    "snr": [60.0, 65.0],
    "min_max_freqs": [100.0, 125.0],
    "fletcher_munson": [2.0],  # reference grid empty → flag default
    "l2": [0.04, 0.06, 0.08],
    "linf": [1e-4],  # reference grid empty → flag default
    "tv": [0.001, 0.002],
    "max_phon": [15.0, 20.0, 25.0, 30.0, 35.0],
}

# each cell record's part of a checkpoint, stacked over the cells: the sweep
# state's name and dtype (None: a list)
STACKED = {"best_eval_score": ("best_score_s", np.float64), "best_p": ("best_p_s", np.float32),
           "best_epoch": ("best_epoch_s", np.int64), "no_improve": ("no_improve_s", np.int64),
           "history": ("history_s", None)}


def create_sweep_parser() -> argparse.ArgumentParser:
    parser = parser_lib.create_arg_parser()
    parser.add_argument(
        "--norms", type=str, default=",".join(DEFAULT_GRIDS),
        help="comma-separated norm types to sweep",
    )
    parser.add_argument(
        "--grid", type=str, default=None,
        help="JSON dict {norm_type: [sizes...]} overriding the default grids",
    )
    parser.add_argument(
        "--epochs_per_cell", type=int, default=None,
        help="override --num_epochs for sweep cells",
    )
    parser.add_argument(
        "--cell_artifacts", action="store_true",
        help="emit the FULL per-cell artifact bundle at finalize (loss "
             "plots, sample-inspection triples, perceptual debug panels) "
             "— everything a standalone run_attack would write; off by "
             "default since it costs an extra eval pass and S×plots",
    )
    return parser


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse ``argv``; a flag the port refuses is a usage error (exit code 2),
    as in ``cli/parser.py:parse_args``. ``--profile`` too: the JAX sweep
    accepts it and never traces; and ``--tp > 1``, which the JAX sweep
    refuses when it runs."""
    parser = create_sweep_parser()
    args = parser.parse_args(argv)
    refused = parser_lib.refusals(args)
    if args.profile:
        refused.append("--profile: the sweep does not trace; profile one cell with "
                       "cli.run_attack --profile")
    if args.tp > 1:
        refused.append("--tp > 1: the sweep's mesh axes are (sweep, data); run cells one by "
                       "one through cli.run_attack --tp")
    if refused:
        parser.error("; ".join(refused))
    return args


def _ns_for(s: int, n_dev: int) -> int:
    """Sweep-axis size for an ``s``-cell sweep on ``n_dev`` devices:
    shard cells across ranks when they divide evenly, else the
    host-multiplexed sweep-axis-1 form (attack/step.py:make_sweep_step)."""
    return s if n_dev % s == 0 and s <= n_dev else 1


def _should_drop(n_live: int, n_cur: int, n_dev: int) -> bool:
    """Rebuild the device state over the surviving cells now?

    The host-multiplexed form runs the same single-cell step for any cell
    count, so dropping is free and happens the moment any cell freezes —
    a frozen cell would otherwise pay a discarded forward and backward per
    batch. The reference's vmapped form pays a rebuild and compile per new
    cell count, so it waits until at most half the cells survive.
    """
    if not 0 < n_live < n_cur:
        return False
    if _ns_for(n_cur, n_dev) == 1 and _ns_for(n_live, n_dev) == 1:
        return True
    return n_live <= n_cur // 2


def _rate(n_steps: int, wall: float) -> float | None:
    """Cell steps per second, or None before any step."""
    return n_steps / wall if (wall and n_steps) else None


def _cell_dir(root: str, args, cfg, norm_type: str, size: float) -> str:
    # same layout as the reference's per-job save_dir (build.py:249-254)
    return os.path.join(
        root, cfg.attack_mode, args.dataset,
        f"{norm_type}_{size}_{cfg.attack_mode}_{cfg.optimizer_type}",
    )


def run_sweep(args, device: torch.device | None = None) -> dict:
    """Every norm of ``args.norms`` over its grid, on ``device`` (default:
    ``--platform``'s); writes ``sweep_results.json`` at the save root and
    returns its content."""
    log = logging.getLogger("paa_tpu")
    if getattr(args, "tp", 1) > 1:
        # the sweep's mesh is (sweep, data): no model axis to shard over;
        # run cells one by one through run_attack --tp (or cli.launch_grid)
        raise SystemExit(
            "--tp > 1 is not supported by cli.sweep (its mesh axes are "
            "(sweep, data)); run cells individually via run_attack --tp"
        )
    device = device if device is not None else run_attack_cli.select_device(args.platform)
    grids = dict(DEFAULT_GRIDS)
    if args.grid:
        grids.update(json.loads(args.grid))
    norms = [n.strip() for n in args.norms.split(",") if n.strip()]
    if args.epochs_per_cell:
        args.num_epochs = args.epochs_per_cell

    # shared data and model for every cell (the reference re-loads per job);
    # each split is staged once for the whole sweep
    pipe = parser_lib.pipeline_from_args(args)
    model = run_attack_cli.load_model(args, device)
    corpora = pipeline_lib.CorpusCache(parser_lib.config_from_args(args).cache_data_on_device,
                                       device)

    summary = {}
    root = args.save_root or os.path.join(os.getcwd(), "logs")
    if mesh_lib.is_writer():
        os.makedirs(root, exist_ok=True)
    for norm_type in norms:
        sizes = grids.get(norm_type, [])
        if not sizes:
            continue
        summary[norm_type] = _run_norm_sweep(
            args, norm_type, [float(s) for s in sizes], pipe, model, root, corpora)

    out_path = os.path.join(root, "sweep_results.json")
    if mesh_lib.is_writer():
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
        log.info("sweep summary written to %s", out_path)
    return summary


def _run_norm_sweep(args, norm_type, sizes, pipe, model, root, corpora) -> dict:
    """All epsilons of one norm type, each cell a full attack run
    (reference: one SLURM job per cell running run_attack.py:13-279)."""
    log = logging.getLogger("paa_tpu")
    writer = mesh_lib.is_writer()
    S = len(sizes)
    cfg = parser_lib.config_from_args(args).replace(norm_type=norm_type)
    device = next(model.parameters()).device
    base = parser_lib.constraint_params_from_args(args, device=device)
    cparams_s = with_sweep_value(ConstraintParams(*(x.expand(S) for x in base)),
                                 norm_type, sizes)
    n_dev = mesh_lib.world_size()
    meshes: dict = {}
    programs: dict = {}

    def mesh_for(s_dev: int):
        """The (sweep, data) mesh of ``s_dev`` cells, made once per cell
        count (making a mesh is collective: every rank makes the same ones
        in the same order)."""
        if s_dev not in meshes:
            ns = _ns_for(s_dev, n_dev)
            meshes[s_dev] = mesh_lib.sweep_mesh(n_sweep=ns, n_devices=n_dev)
            n_data = meshes[s_dev].shape["data"]
            if n_data > 1 and cfg.batch_size % n_data:
                raise ValueError(f"batch_size {cfg.batch_size} must divide over the data axis "
                                 f"({n_data} = {n_dev} devices / sweep {ns})")
        return meshes[s_dev]

    # the runner's feed, targeted labels, clean eval and inspection are the
    # single run's, over the first mesh's data axis; the sweep adds the
    # per-cell steps. Every rank stages the whole split, so the feed does not
    # change when the cells are rebuilt over another mesh.
    runner = loop.AttackRunner(cfg, model, pipe, base, mesh=mesh_for(S), corpora=corpora)

    def program(s_dev: int) -> tuple:
        """(train step, eval step) for ``s_dev`` cells."""
        if s_dev not in programs:
            mesh = mesh_for(s_dev)
            programs[s_dev] = (attack_step.make_sweep_step(cfg, model, runner.tables, mesh),
                               attack_step.make_sweep_eval_step(cfg, model, mesh))
        return programs[s_dev]

    step, sweep_eval = program(S)
    n_sweep = mesh_for(S).shape["sweep"]

    # -- init: every cell starts from the standalone-run perturbation, the
    # same randn draw for every cell, then the cell's own projection
    p_full = torch.stack([runner.init_perturbation(cfg.seed, attack_step.cell(cparams_s, i))
                          for i in range(S)])
    p_full = mesh_lib.broadcast(p_full, src=0)
    opt_full = attack_step.stack_cells(
        [optimizers.init_opt_state(cfg, p_full[i]) for i in range(S)])
    # a cell's record holds only the epochs it trained: a stopped cell's
    # frozen-p epochs must not enter its aggregates
    records = [loop.CellRecord(cfg, _cell_dir(root, args, cfg, norm_type, size), size, p_full[i],
                               rate_key="sweep_steps_per_sec")
               for i, size in enumerate(sizes)]
    start_epoch = 0
    clean_eval = None  # Scores — the same for every epoch and cell

    # -- checkpoint/resume (replaces SLURM --requeue; build.py:266-286) ---
    # Guarded by a config fingerprint: resuming under a changed grid, seed,
    # optimizer, shape or corpus would continue stale state under freshly
    # labeled cell dirs. ``--no_resume`` (and ``--small_data``, as in
    # run_attack) discards leftover state. A FINISHED norm keeps its
    # checkpoint, so a requeued multi-norm sweep goes straight to finalize.
    ckpt_path = os.path.join(root, f"sweep_state_{norm_type}.pt")
    fp_path = ckpt_path + ".json"
    cfg_fp = dataclasses.asdict(cfg)
    for transient in ("num_epochs", "early_stopping"):
        # run-length knobs may change across a resume (a requeued job gets
        # a new walltime); everything else must match
        cfg_fp.pop(transient)
    fingerprint = {
        "cfg": cfg_fp,
        "sizes": [float(s) for s in sizes],
        "audio_len": int(pipe.audio_len),
        "dataset": args.dataset,
        "data_root": getattr(args, "data_root", None),
        "synthetic_samples": getattr(args, "synthetic_samples", None),
        "synthetic_words": getattr(args, "synthetic_words", None),
        "n_train": len(pipe.train),
    }
    discard = args.no_resume or args.small_data
    if discard and writer:
        for stale in (ckpt_path, fp_path):
            if os.path.exists(stale):
                os.remove(stale)
    mesh_lib.barrier()  # rank 0 has discarded stale state before anyone reads it
    if not discard and os.path.exists(ckpt_path):
        saved_fp = None
        if os.path.exists(fp_path):
            with open(fp_path) as fh:
                saved_fp = json.load(fh)
        if saved_fp != fingerprint:
            raise RuntimeError(
                f"Sweep checkpoint {ckpt_path!r} was written under a "
                "different configuration (grid/seed/optimizer/shapes "
                "changed). Pass --no_resume to discard it, or restore the "
                "original flags to resume."
            )
        state = checkpoint.load_checkpoint(ckpt_path, {})
        p_full = state["p_s"].to(device)
        if state["opt_s"] is not None:
            opt_full = optimizers.AdamState(
                *(state["opt_s"][k].to(device) for k in optimizers.AdamState._fields))
        start_epoch = int(state["epoch"]) + 1
        for i, r in enumerate(records):
            r.load({k: state[name][i] for k, (name, _) in STACKED.items()})
        ce = state["clean_eval"].numpy()
        clean_eval = scoring.Scores(float(ce[0]), float(ce[1])) if np.isfinite(ce[0]) else None
        log.info("[sweep %s] resuming at epoch %d", norm_type, start_epoch)
    mesh_lib.barrier()  # every rank has read the state before rank 0 writes
    # the per-cell metric streams keep only epochs before the resume point
    for r in records:
        r.open(start_epoch, args.tensorboard)

    # -- live-cell device state --------------------------------------------
    # The device state holds only the cells still training; the full-S
    # copies back the checkpoint and best tracking.
    dev_idx = np.arange(S)
    p_s, opt_s, cparams_dev = p_full, opt_full, cparams_s

    # -- epochs ------------------------------------------------------------
    t_start = time.perf_counter()
    n_cell_steps = 0  # Σ over steps of cells actually TRAINING that step
    for epoch in range(start_epoch, cfg.num_epochs):
        live_mask = np.array([not r.stopped for r in records])
        if not live_mask.any():
            # resumed where every cell had already early-stopped: finalize
            log.info("[sweep %s] resumed fully early-stopped; finalizing", norm_type)
            break
        n_live = int(live_mask.sum())
        if _should_drop(n_live, len(dev_idx), n_dev):
            dev_idx = np.flatnonzero(live_mask)
            step, sweep_eval = program(len(dev_idx))
            keep = torch.from_numpy(dev_idx).to(device)
            p_s, opt_s, cparams_dev = (attack_step.cell(x, keep)
                                       for x in (p_full, opt_full, cparams_s))
            log.info("[sweep %s] dropping frozen cells: training %d/%d cells from epoch %d",
                     norm_type, len(dev_idx), S, epoch)
        # batch order is a pure function of (seed, epoch) — resume-exact,
        # as in train/loop.py
        data_rng = np.random.default_rng((cfg.seed, epoch))
        lr = optimizers.step_lr(cfg, epoch)
        p_s, opt_s, pending, seconds = runner.train_pass(
            step, p_s, opt_s, lr, data_rng, cparams_dev, live_mask[dev_idx].astype(np.float32))
        # one cell's step: the epoch's train wall over its cell steps
        cell_step_ms = 1000.0 * seconds / max(len(pending) * n_live, 1)
        n_cell_steps += len(pending) * n_live
        # scatter the trained cells back into the full-S state
        keep = torch.from_numpy(dev_idx).to(device)
        p_full = p_full.index_copy(0, keep, p_s)
        if opt_full is not None:
            opt_full = type(opt_full)(*(f.index_copy(0, keep, o) for f, o in zip(opt_full, opt_s)))

        # per live cell: its train scores from its slice of the stacked step
        # metrics, and its perturbed eval scores
        if clean_eval is None:
            clean_eval = runner.evaluate(pipe.eval, p_s[0], perturbed=False)
        slots = np.flatnonzero(live_mask[dev_idx])
        live = dev_idx[slots].tolist()
        pert = dict(zip(live, loop.cell_scores(runner.eval_pass(sweep_eval, pipe.eval, p_s),
                                               pipe.eval.texts, float("inf"), slots)))
        train = dict(zip(live, loop.cell_scores(pending, pipe.train.texts, 0.0, slots)))
        log.info(
            "[sweep %s] epoch %d train_ctc=%s eval_pert_ctc=%s eval_pert_wer=%s active=%s "
            "cell_step_ms=%.1f", norm_type, epoch,
            {sizes[i]: round(t.ctc, 1) for i, t in train.items()},
            {sizes[i]: round(e.ctc, 1) for i, e in pert.items()},
            {sizes[i]: round(e.wer, 3) for i, e in pert.items()},
            live_mask.astype(np.int32), cell_step_ms,
        )

        # per-cell records, best tracking and early stopping
        # (run_attack.py:149-183), the single run's; the decisions gate
        # collectives, so rank 0's scores decide them
        rate = _rate(n_cell_steps, time.perf_counter() - t_start)
        current = mesh_lib.agree([pert[i].wer if cfg.attack_mode == "targeted" else pert[i].ctc
                                  for i in live])
        for i, score in zip(live, current):
            records[i].add_epoch(epoch, train[i], clean_eval, pert[i], cell_step_ms, lr, rate)
            records[i].judge(epoch, score, p_full[i])

        if writer:
            # written unconditionally WITH every checkpoint: an `only if
            # absent` write would let a stale fingerprint from an earlier
            # aborted run guard a checkpoint of a different configuration
            with open(fp_path, "w") as fh:
                json.dump(fingerprint, fh)
            parts = [r.state() for r in records]
            checkpoint.save_checkpoint(ckpt_path, {
                "p_s": p_full, "opt_s": None if opt_full is None else opt_full._asdict(),
                "epoch": epoch,
                **{name: [q[k] for q in parts] if dtype is None
                   else np.asarray([q[k] for q in parts], dtype)
                   for k, (name, dtype) in STACKED.items()},
                "clean_eval": np.asarray(
                    (clean_eval.ctc, clean_eval.wer) if clean_eval else (np.inf, np.inf),
                    np.float64),
            })
        if all(r.stopped for r in records):
            log.info("[sweep %s] every cell early-stopped at epoch %d", norm_type, epoch)
            break
    wall = time.perf_counter() - t_start

    # -- finalize: best p per cell on the test split (run_attack.py:185-261)
    _, sweep_eval = program(S)
    best_p_dev = torch.from_numpy(np.stack([r.best_p for r in records])).to(device)
    test_clean = runner.evaluate(pipe.test, best_p_dev[0], perturbed=False)
    pert_tests = loop.cell_scores(runner.eval_pass(sweep_eval, pipe.test, best_p_dev),
                                  pipe.test.texts, float("inf"), range(S))
    norm_summary = []
    for i, (r, test_pert) in enumerate(zip(records, pert_tests)):
        if writer:
            artifacts.save_epoch_bundle(r.save_dir, r.best_p[0], cfg)
        if getattr(args, "cell_artifacts", False):
            # the full per-cell bundle a reference SLURM cell emits from its
            # own `main` (run_attack.py:61-183, save.py:49-199)
            samples = (runner.inspect_samples(best_p_dev[i], args.num_items_to_inspect)
                       if args.num_items_to_inspect > 0 else None)
            r.save_loss_plot(test_clean, test_pert)
            if writer:
                if samples is not None:
                    artifacts.inspect_samples(r.save_dir, samples, cfg.attack_mode,
                                              cfg.target, cfg.sr)
                artifacts.save_debug_plots(r.save_dir, r.best_p, cfg,
                                           attack_step.cell(cparams_s, i), runner.tables,
                                           tag="final")
        r.finish(test_clean, test_pert, _rate(n_cell_steps, wall))
        running = r.running_scores()
        norm_summary.append({
            "size": float(r.size),
            "best_epoch": r.best_epoch,
            "best_eval_score": float(r.best_score),
            "best_eval_pert_ctc": running["eval_score_perturbed"]["ctc"],
            "best_eval_pert_wer": running["eval_score_perturbed"]["wer"],
            "final_ctc": r.history["train_ctc"][-1] if r.history["train_ctc"] else None,
            "test_clean_ctc": test_clean.ctc, "test_clean_wer": test_clean.wer,
            "test_pert_ctc": test_pert.ctc, "test_pert_wer": test_pert.wer,
            "dir": r.save_dir,
        })
    return {
        "cells": norm_summary,
        # ACTIVE-cell steps only: frozen cells are no live throughput
        "cell_steps_per_sec": _rate(n_cell_steps, wall),
        "n_cell_steps": n_cell_steps,
        # the cell counts the device state was built for — a second entry
        # < S means the drop of frozen cells engaged
        "programs_built": sorted(programs),
        "mesh": f"(sweep={n_sweep}, data={n_dev // n_sweep})",
    }


def main(argv: list[str] | None = None) -> int:
    """The sweep as ``python -m`` runs it; under ``torchrun`` every rank
    runs it, over the ranks' ``(sweep, data)`` meshes, and rank 0 writes."""
    args = parse_args(argv)
    root = args.save_root or os.path.join(os.getcwd(), "logs")
    log = run_attack_cli.setup_logging(root, log_name="sweep.log")
    log_helpers.log_args(log, vars(args))
    # Without the device the run asks for, leave a machine-readable marker
    # (no per-cell results.json gets written) and exit 1, as run_attack's
    # failure contract does; it never carries on on the CPU.
    try:
        device = run_attack_cli.select_device(args.platform)
    except RuntimeError as e:
        log.error("device selection failed: %s", e)
        if mesh_lib.is_writer():
            with open(os.path.join(root, "sweep_failure.json"), "w") as f:
                json.dump({"finished_training": False, "error": str(e)}, f, indent=2)
        return 1
    joined = mesh_lib.init_process_group(device)
    try:
        run_sweep(args, device)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
