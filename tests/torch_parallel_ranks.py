"""Rank processes for the port's parallel tests, with no JAX in them.

``launch(n, mode, workdir)`` starts ``n`` ranks of this file under
``torchrun`` (``--standalone``: its rendezvous on localhost), each joining a
gloo process group on the CPU, and waits for them with a timeout. Modes:

  * ``steps``: the sharded train, eval and sweep steps of the tiny model on
    the inputs the parent wrote to ``workdir/inputs.pt``, for the layouts of
    :data:`LAYOUTS` (with a model axis also ∂loss/∂p under full remat, and
    under ``fused_qkv`` from the parent's 2-way shards of the weights);
    each rank writes its results to ``workdir/rank<r>.pt``;
  * ``cli``: ``paa_tpu_torch.cli.<module>.main(argv)`` with the argv in
    ``workdir/argv.json``; ranks other than 0 record every file they open for
    writing under the save root, and every rank records the JAX modules it
    imported, in ``workdir/rank<r>.json``.

The parent (the test) computes the JAX references; this file and the port
import no JAX.
"""

from __future__ import annotations

import builtins
import json
import os
import signal
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, LR = 8, 8000, 1e-3

# (config, steps, constraint params): the step cases; "tv" binds its ball
# at 1e-4 of the clean batch's total variation, "snr" at the default 64 dB
CASES = {
    "fm_pgd": (dict(norm_type="fletcher_munson", optimizer_type="pgd"), 1, {}),
    "l2_adam": (dict(norm_type="l2", optimizer_type="adam"), 2, {}),
    "snr_pgd": (dict(norm_type="snr", optimizer_type="pgd"), 1, {}),
    "tv_pgd": (dict(norm_type="tv", optimizer_type="pgd"), 1, {"tv_epsilon": 1e-4}),
    "fm_pgd_accum2": (dict(norm_type="fletcher_munson", optimizer_type="pgd", accum_steps=2),
                      1, {}),
}
# per world size: (layout name, tp, the cases it runs); every layout also
# runs the eval step and ∂loss/∂p at p0
LAYOUTS = {
    2: [("dp2", 1, list(CASES)), ("tp2", 2, ["fm_pgd", "l2_adam"])],
    4: [("dp2tp2", 2, ["fm_pgd", "snr_pgd"])],
}
# the sweep's cells: l2 Adam at two radii, one per sweep slice, the second
# frozen by the active mask
SWEEP_SIZES, SWEEP_ACTIVE = [0.05, 0.02], [1.0, 0.0]


def launch(n: int, mode: str, workdir: str, timeout: float = 240.0) -> None:
    """``python -m torch.distributed.run --standalone --nproc_per_node n`` of
    this file's ``mode``, and wait; raise with the ranks' output if one
    fails or the launch outlives ``timeout`` seconds (then its whole process
    group is killed)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), mode, workdir]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    log_path = os.path.join(workdir, "torchrun.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            code = "timeout"
    if code != 0:
        with open(log_path) as f:
            raise RuntimeError(f"{mode} ranks exited {code}:\n{f.read()[-6000:]}")


def _jax_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "paa_tpu"))


def _steps(workdir: str) -> dict:
    from paa_tpu_torch.attack import optimizers, step
    from paa_tpu_torch.config import AttackConfig, ConstraintParams, with_sweep_value
    from paa_tpu_torch.models import wav2vec2
    from paa_tpu_torch.ops import psycho
    from paa_tpu_torch.parallel import mesh as mesh_lib, tp

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)

    def full_model(**over):
        model = wav2vec2.Wav2Vec2ForCTC(wav2vec2.get_config("wav2vec2-tiny", **over))
        model.load_state_dict(inp["state_dict"])
        return model.requires_grad_(False).eval()

    full = full_model()
    batch = [inp[k] for k in ("audio", "labels", "pads", "weights")]
    p0 = inp["p0"]
    out = {}
    for layout, tp_size, cases in LAYOUTS[mesh_lib.world_size()]:
        mesh = mesh_lib.decide_mesh(tp_size, B)
        model = tp.shard_model(full, mesh)
        cfg0 = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=LR)
        loss, ids, grad = step._grad_fn(model, cfg0, mesh)(p0, *batch)
        m = step.make_sharded_eval_step(cfg0, model, mesh)(p0, *batch)
        out[layout] = {"mesh": mesh.shape, "grad": grad, "grad_loss": loss, "grad_ids": ids,
                       "eval_loss": m.ctc_loss, "eval_ids": m.greedy_ids}
        if tp_size > 1:  # the same under full remat: the recompute replays the collectives
            remat = tp.shard_model(full_model(remat=True, remat_policy="full"), mesh)
            out[layout]["remat_full"] = step._grad_fn(remat, cfg0, mesh)(p0, *batch)
            # fused_qkv on this rank's slice of the JAX weights, converted by
            # the parent (convert.sharded_params_from_jax)
            axis = tp.model_axis(mesh)
            fused = wav2vec2.Wav2Vec2ForCTC(
                wav2vec2.get_config("wav2vec2-tiny", fused_qkv=True), model_axis=axis)
            fused.load_state_dict(inp["tp_shards"][axis.rank])
            fused = fused.requires_grad_(False).eval()
            out[layout]["fused_qkv"] = step._grad_fn(fused, cfg0, mesh)(p0, *batch)
        for name in cases:
            kw, steps, cp = CASES[name]
            cfg = AttackConfig(lr=LR, **kw)
            cparams = ConstraintParams.create(**cp)
            train = step.make_sharded_step(cfg, model, psycho.build_tables(cfg), mesh)
            p, opt = p0.clone(), optimizers.init_opt_state(cfg, p0)
            losses, all_ids = [], []
            for _ in range(steps):
                p, opt, m = train(p, opt, *batch, cparams, LR)
                losses.append(m.ctc_loss)
                all_ids.append(m.greedy_ids)
            out[layout][name] = {"p": p, "opt": None if opt is None else list(opt),
                                 "losses": torch.stack(losses), "ids": torch.stack(all_ids)}
    # the sweep, one cell per sweep slice, its batch over the slice's data axis
    n = mesh_lib.world_size()
    mesh = mesh_lib.sweep_mesh(n_sweep=len(SWEEP_SIZES), n_devices=n)
    cfg = AttackConfig(norm_type="l2", optimizer_type="adam", lr=LR)
    S = len(SWEEP_SIZES)
    base = ConstraintParams.create()
    cparams_s = with_sweep_value(ConstraintParams(*(x.expand(S) for x in base)), "l2",
                                 SWEEP_SIZES)
    p_s, opt_s = inp["sweep_p"], optimizers.AdamState(*inp["sweep_opt"])
    sweep_step = step.make_sweep_step(cfg, full, psycho.build_tables(cfg), mesh)
    new_p, new_opt, m = sweep_step(p_s, opt_s, *batch, cparams_s, SWEEP_ACTIVE, LR)
    me = step.make_sweep_eval_step(cfg, full, mesh)(p_s, *batch)
    out["sweep"] = {"mesh": mesh.shape, "p": new_p, "opt": list(new_opt), "loss": m.ctc_loss,
                    "ids": m.greedy_ids, "eval_loss": me.ctc_loss, "eval_ids": me.greedy_ids}
    return out


def _cli(workdir: str) -> dict:
    import importlib

    with open(os.path.join(workdir, "argv.json")) as f:
        spec = json.load(f)
    module = importlib.import_module(f"paa_tpu_torch.cli.{spec['module']}")
    root = os.path.realpath(spec["save_root"])
    written = []
    if int(os.environ["RANK"]) != 0:  # record what another rank would write
        real_open, real_makedirs = builtins.open, os.makedirs

        def under_root(path) -> bool:
            if not isinstance(path, (str, os.PathLike)):
                return False
            real = os.path.realpath(os.fspath(path))
            return real == root or real.startswith(root + os.sep)

        def audited_open(file, mode="r", *a, **kw):
            if any(c in mode for c in "wax+") and under_root(file):
                written.append(os.fspath(file))
            return real_open(file, mode, *a, **kw)

        def audited_makedirs(name, *a, **kw):
            if under_root(name) and not os.path.isdir(name):
                written.append(os.fspath(name))
            return real_makedirs(name, *a, **kw)

        builtins.open, os.makedirs = audited_open, audited_makedirs
    if spec["module"] == "run_attack":
        code = module.main(module.parser_lib.parse_args(spec["argv"]))
    else:
        code = module.main(spec["argv"])
    if code != 0:
        raise SystemExit(code)
    return {"written": written}


def main(mode: str, workdir: str) -> None:
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    if mode == "steps":
        import torch.distributed as dist

        from paa_tpu_torch.parallel import mesh as mesh_lib

        mesh_lib.init_process_group(torch.device("cpu"), timeout_s=120.0)
        out = _steps(workdir)
        out["jax_modules"] = _jax_modules()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    else:
        out = _cli(workdir)
        out["jax_modules"] = _jax_modules()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
