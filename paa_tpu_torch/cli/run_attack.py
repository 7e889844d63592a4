"""Attack run entry point — ``python -m paa_tpu_torch.cli.run_attack <flags>``.

The port of ``paa_tpu/cli/run_attack.py``: setup → data → frozen model →
perturbation → epoch loop → finalize, with the same run directory
(``logs/{attack_mode}/{dataset}/{norm}_{size}_{mode}_{opt}``), resume
discovery, ``results.json``, metrics log and ``perturbation.npy``, and the
same exit codes: 0 on success, 1 on a failure, which also writes a failure
``results.json``. It runs on the CUDA device by default and on the CPU with
``--platform cpu``; without a CUDA device the default run fails.
``--profile`` traces the attack loop with ``torch.profiler`` into
``<save_dir>/profile/trace.json`` (a Chrome trace), where the JAX CLI
writes its ``jax.profiler`` trace.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
paa_tpu_torch.cli.run_attack <flags>``) every rank runs this entry point:
each joins the process group (``parallel/mesh.py:init_process_group``),
takes its card (``cuda:(LOCAL_RANK mod device_count)``) and runs the loop
over the run's mesh: data parallelism when the batch divides over the
ranks, dp × tp with ``--tp``. Rank 0 alone writes the run directory and the
log file; the other ranks log warnings and errors to the console.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys

import torch
import torch.distributed as dist

from paa_tpu_torch.train import artifacts, log_helpers
from paa_tpu_torch import runtime
from paa_tpu_torch.parallel import mesh as mesh_lib
from paa_tpu_torch.cli import parser as parser_lib
from paa_tpu_torch.config import SWEEP_ARG
from paa_tpu_torch.models import checkpoint_io, hf_cache, presets
from paa_tpu_torch.train import checkpoint, loop


def make_save_dir(args) -> str:
    """logs/{attack_mode}/{dataset}/{norm}_{size}_{mode}_{opt}."""
    args.attack_size_string = f"{getattr(args, SWEEP_ARG[args.norm_type])}"
    root = args.save_root or os.path.join(os.getcwd(), "logs")
    return os.path.join(
        root, args.attack_mode, args.dataset,
        f"{args.norm_type}_{args.attack_size_string}_{args.attack_mode}_{args.optimizer_type}",
    )


def select_device(platform: str) -> torch.device:
    """``cuda``: the CUDA device, or an error when there is none."""
    return runtime.require_cuda() if platform == "cuda" else torch.device("cpu")


def load_model(args, device: torch.device) -> torch.nn.Module:
    """The frozen CTC model of preset ``--model`` (``models/presets.py``) on
    ``device``. Weight sources, in the
    reference's order (``paa_tpu/cli/run_attack.py`` ``load_model_bundle``):

      1. ``--checkpoint_path``: a local HF ``model.safetensors`` or
         ``pytorch_model.bin``, read without torch's unpickler; errors are
         fatal;
      2. the preset's pretrained weights in the local HF hub cache
         (``models/hf_cache.py``), never for ``wav2vec2-tiny``, which is
         test-only; any failure to find or read them logs a warning;
      3. random weights drawn from ``--seed``.

    The reference's last resort, ``transformers.from_pretrained``, has no
    counterpart: the port has no ``transformers``."""
    log = logging.getLogger("paa_tpu")
    overrides = {"do_normalize": False} if args.no_input_normalize else {}
    remat, remat_policy = parser_lib.resolve_remat(args)
    mcfg = presets.get_config(args.model, compute_dtype=args.compute_dtype,
                              fe_gelu=args.fe_gelu, conv_impl=args.conv_impl, remat=remat,
                              remat_policy=remat_policy, **overrides)

    def from_state_dict(sd: dict) -> torch.nn.Module:
        model = presets.build(mcfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return model.requires_grad_(False).eval()

    model = None
    if args.checkpoint_path:
        model = from_state_dict(checkpoint_io.load_state_dict(args.checkpoint_path))
        log.info("loaded weights from %s", args.checkpoint_path)
    elif args.model != "wav2vec2-tiny":  # tiny is test-only, never pretrained
        try:
            path, sd = hf_cache.load_cached_state_dict(args.model)
            model = from_state_dict(sd)
            log.info("loaded pretrained HF weights for %s from %s", args.model, path)
        except Exception as e:
            log.warning("pretrained weights unavailable (%s); using random init", e)
    if model is None:
        log.info("%s weights drawn at random from --seed %d", args.model, args.seed)
        model = presets.init_model(mcfg, seed=args.seed)
    storage = args.param_storage or args.compute_dtype
    if storage != "float32":
        model.cast_param_storage(getattr(torch, storage))
        log.info("matmul and conv weights stored as %s", storage)
    return model.to(device)


def setup_logging(save_dir: str, log_name: str = "train.log") -> logging.Logger:
    """Rank 0: the run's log file and the console; any other rank:
    warnings and errors on the console, marked with the rank."""
    if mesh_lib.is_writer():
        return log_helpers.setup_logging(save_dir, log_name)
    log = logging.getLogger("paa_tpu")
    log.setLevel(logging.WARNING)
    log.handlers.clear()
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(f"rank {mesh_lib.rank()} | %(levelname)s | %(message)s"))
    log.addHandler(handler)
    return log


@contextlib.contextmanager
def profile_run(save_dir: str, device: torch.device):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA on the card)
    and write ``<save_dir>/profile/trace.json``, also when the block
    raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        trace = os.path.join(save_dir, "profile", "trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        logging.getLogger("paa_tpu").info("profiler trace written to %s", trace)


def main(args) -> int:
    save_dir = make_save_dir(args)
    log = setup_logging(save_dir)
    log_helpers.log_args(log, vars(args))
    log.info("norm_type=%s | attack_size=%s", args.norm_type, args.attack_size_string)

    joined = False
    try:
        device = select_device(args.platform)
        joined = mesh_lib.init_process_group(device)
        log.info("device: %s%s", device,
                 f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        cfg = parser_lib.config_from_args(args)
        cparams = parser_lib.constraint_params_from_args(args, device=device)

        pipe = parser_lib.pipeline_from_args(args)
        model = load_model(args, device)
        init_p = None
        if args.resume_from:
            log.info("Resuming perturbation from: %s", args.resume_from)
            init_p = checkpoint.load_perturbation(args.resume_from)
        with profile_run(save_dir, device) if args.profile else contextlib.nullcontext():
            loop.run_attack(
                cfg, model, pipe, save_dir,
                cparams=cparams,
                num_items_to_inspect=args.num_items_to_inspect,
                resume=not args.no_resume and not args.small_data,
                init_p=init_p,
                debug_plots=args.debug_plots,
                tensorboard=args.tensorboard,
            )
        return 0
    except Exception as e:  # the failure report
        log.exception("Run failed with an exception: %s", e)
        if mesh_lib.is_writer():
            try:
                artifacts.save_json_results(
                    save_dir, args.norm_type, args.attack_size_string,
                    epoch=-1, finished_training=False, error=str(e),
                )
            except OSError:
                log.exception("could not write the failure results.json")
        return 1
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(parser_lib.parse_args()))
