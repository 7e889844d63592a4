"""The system under test: the port's own objects, built as
``python -m paa_tpu_torch.cli.run_attack`` builds them, on the benchmark's
inputs.

A cell gets ``paa_tpu_torch.train.loop.AttackRunner(cfg, model, pipe)`` on
one device: an ``AttackConfig`` with fletcher_munson PGD, untargeted, the
traffic's batch, microbatches and learning rate and the other fields at
their defaults; the model of the configuration's family
(``families/<family>.py``'s ``build_model``: the configuration's widths,
built on the device with its matmul and conv weights stored as the
configuration serves them, loaded with the benchmark's weights); and a
``DataPipeline`` of the benchmark's splits. Its feed is the default one:
on a CUDA device each split that stages in the auto budget becomes a
``DeviceCorpus``.

The program is imported here, in the families' builders, in the scopes of
:mod:`portbench.trace` and in the planted faults of :mod:`portbench.faults`;
the reference imports none of it.
"""

from __future__ import annotations

import torch

from paa_tpu_torch import runtime
from paa_tpu_torch.attack import optimizers
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.data import pipeline
from paa_tpu_torch.train import loop

from portbench import family
from portbench.inputs import Clips


def device() -> torch.device:
    """The CUDA device, with the program's float32 policy (TF32 off)."""
    return runtime.require_cuda()


def split(c: Clips) -> pipeline.Split:
    return pipeline.Split(waveforms=list(c.audio), texts=list(c.texts), labels=c.labels,
                          label_paddings=c.paddings, audio_len=c.audio.shape[1])


def build_runner(cfg: dict, traffic: dict, weights: dict, train: Clips, evals: Clips,
                 dev: torch.device) -> loop.AttackRunner:
    """The runner of one cell. An eval cell has no train split; its
    pipeline names the eval split in every slot."""
    acfg = AttackConfig(norm_type=traffic["norm"], attack_mode="untargeted",
                        optimizer_type=traffic["optimizer"], lr=traffic["lr"],
                        batch_size=traffic["batch_size"],
                        accum_steps=traffic.get("accum_steps", 1),
                        model_name=cfg["program_preset"],
                        compute_dtype=cfg["assumed"]["compute_dtype"])
    ev = split(evals) if evals is not None else None
    tr = split(train) if train is not None else ev
    pipe = pipeline.DataPipeline(train=tr, eval=ev or tr, test=ev or tr,
                                 audio_len=tr.audio_len)
    cparams = ConstraintParams.create(fm_epsilon=traffic["fm_epsilon"], device=dev)
    model = family.program(cfg).build_model(cfg, weights, dev)
    return loop.AttackRunner(acfg, model, pipe, cparams, mesh=None)


def init_opt_state(runner: loop.AttackRunner, p: torch.Tensor):
    return optimizers.init_opt_state(runner.cfg, p)


def warm_up(runner: loop.AttackRunner, p: torch.Tensor, opt_state, mode: str) -> None:
    """One train step (attack) or one perturbed eval batch (eval) of the
    cell's own shapes, fed as the loop feeds it (which stages the split),
    through the runner's own step; its outputs are read back as the loop's
    scoring reads them, then dropped."""
    split = runner.pipe.train if mode == "attack" else runner.pipe.eval
    batch = next(iter(runner.corpora.batches(split, runner.cfg.batch_size)))
    args = (batch.audio, batch.labels, batch.label_paddings, batch.weights)
    if mode == "attack":
        lr = optimizers.step_lr(runner.cfg, 0)
        _, _, m = runner.train_step(p, opt_state, *args, runner.cparams, lr)
    else:
        m = runner.eval_step(p, *args)
    float(m.ctc_loss)
    m.greedy_ids.cpu()

