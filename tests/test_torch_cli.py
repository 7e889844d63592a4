"""The port's command line against paa_tpu.cli: the same argv gives the same
AttackConfig, ConstraintParams and run directory; every TPU-only flag the
port cannot honour is refused; the entry point runs on the CPU with
``--platform cpu`` and fails without a CUDA device by default."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paa_tpu.cli import parser as jparser
from paa_tpu.cli import run_attack as jrun
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.cli import sweep as tsweep
from paa_tpu_torch.train import artifacts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(REPO, "checkpoints", "wav2vec2-tiny-synthetic.safetensors")

ARGVS = [
    [],
    # the reference's own flags
    ["--batch_size", "1", "--lr", "1e-4", "--early_stopping", "4", "--num_epochs", "5",
     "--gamma", "0.9", "--step_size", "2", "--dataset", "LibreeSpeech", "--resume_from",
     "x.npy", "--target_reps", "5", "--target", "delete", "--fm_epsilon", "2", "--l2_size",
     "0.05", "--linf_size", "1e-4", "--snr_db", "64", "--min_freq_attack", "120",
     "--max_freq_attack", "20000", "--tv_epsilon", "1e-3", "--max_phon_level", "20",
     "--phon_reference_db", "65", "--sr", "16000", "--n_fft", "1024", "--hop_length", "256",
     "--win_length", "1024", "--relative_audio_length", "0.8", "--seed", "5", "--small_data",
     "--num_items_to_inspect", "12"],
    ["--norm_type", "snr", "--snr_db", "42", "--attack_mode", "targeted", "--optimizer_type",
     "pgd", "--model", "wav2vec2-tiny", "--compute_dtype", "float32"],
    # the lv60 long-clip run, with the flags the port accepts as they are
    ["--model", "wav2vec2-large-lv60", "--dataset", "synthetic", "--synthetic_words", "44,52",
     "--batch_size", "16", "--accum_steps", "2", "--norm_type", "fletcher_munson",
     "--optimizer_type", "pgd", "--use_pallas_fm", "--no_remat", "--no_device_cache",
     "--attention_impl", "flash", "--fe_gelu", "exact", "--l1_size", "3"],
]


@pytest.mark.parametrize("argv", ARGVS + [["--device_cache"]],
                         ids=["defaults", "reference_flags", "targeted_snr", "lv60_long",
                              "device_cache"])
def test_same_argv_same_config(argv):
    jargs = jparser.create_arg_parser().parse_args(argv)
    targs = tparser.parse_args(argv)
    want = jparser.config_from_args(jargs)
    got = tparser.config_from_args(targs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jcp = jparser.constraint_params_from_args(jargs)
    tcp = tparser.constraint_params_from_args(targs)
    for name in jcp._fields:
        assert float(getattr(tcp, name)) == float(getattr(jcp, name)), name
    assert trun.make_save_dir(targs) == jrun.make_save_dir(jargs)
    # every flag the reference parser knows exists in the port's, with its default
    jdefaults = vars(jparser.create_arg_parser().parse_args([]))
    tdefaults = vars(tparser.create_arg_parser().parse_args([]))
    assert set(jdefaults) == set(tdefaults)
    differ = {k for k in jdefaults if jdefaults[k] != tdefaults[k]}
    assert differ == {"platform", "device_probe_timeout"}


@pytest.mark.parametrize("argv", [
    ["--attention_impl", "xla"],
    ["--no_pallas_fm"],
    ["--device_probe_timeout", "60"],
    ["--platform", "tpu"],
])
def test_tpu_only_flags_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tparser.parse_args(argv)
    assert e.value.code == 2
    assert argv[0] in capsys.readouterr().err


@pytest.mark.parametrize("entry", ["run_attack", "sweep"])
@pytest.mark.parametrize("impl", ["hybrid", "pairdot", "im2col", "tapdot"])
def test_conv_impl_flags_run(entry, impl):
    """Every ``--conv_impl`` lowering parses on both entry points (they were
    refused before the lowerings were ported), and ``load_model`` builds the
    model with it."""
    parse = tparser.parse_args if entry == "run_attack" else tsweep.parse_args
    args = parse(["--conv_impl", impl, "--model", "wav2vec2-tiny", "--platform", "cpu"])
    assert trun.load_model(args, torch.device("cpu")).cfg.conv_impl == impl


REMAT_FLAGS = [(["--remat"], True, "save_cheap"),
               (["--remat_policy", "save_cheap"], False, "save_cheap"),
               (["--remat", "--no_remat"], False, "full")]
REMAT_FLAGS += [(["--remat", "--remat_policy", p], True, p)
                for p in ("full", "save_cheap", "no_probs", "save_resid")]


@pytest.mark.parametrize("entry", ["run_attack", "sweep"])
@pytest.mark.parametrize("argv, remat, policy", REMAT_FLAGS,
                         ids=[" ".join(a) for a, _, _ in REMAT_FLAGS])
def test_remat_flags_run(entry, argv, remat, policy):
    """``--remat``, ``--no_remat`` and each ``--remat_policy`` parse on both
    entry points (they were refused before remat was ported);
    ``config_from_args`` sets ``remat``, and ``load_model`` builds the model
    with the policy."""
    parse = tparser.parse_args if entry == "run_attack" else tsweep.parse_args
    args = parse(argv + ["--model", "wav2vec2-tiny", "--platform", "cpu"])
    assert tparser.config_from_args(args).remat is remat
    model = trun.load_model(args, torch.device("cpu"))
    assert (model.cfg.remat, model.cfg.remat_policy) == (remat, policy)


@pytest.mark.parametrize("entry", ["run_attack", "sweep"])
@pytest.mark.parametrize("argv,want", [(["--device_cache"], True),
                                       (["--no_device_cache"], False), ([], None)],
                         ids=["device_cache", "no_device_cache", "auto"])
def test_device_cache_flag_resolves(entry, argv, want):
    """``--device_cache`` parses on both entry points and stages the splits
    (True), ``--no_device_cache`` keeps the host feed (False), and without
    either the feed is decided by the device (None)."""
    parse = tparser.parse_args if entry == "run_attack" else tsweep.parse_args
    assert tparser.config_from_args(parse(argv)).cache_data_on_device is want


@pytest.mark.parametrize("tp", [2, 3])
def test_tp_flag_as_the_reference_takes_it(tp):
    """``--tp`` parses as the JAX CLI's; a size that the ranks do not
    divide (3 over one process here) fails where the reference's does, in
    ``decide_mesh``, with its message; base's 12 heads and 3072 FFN columns
    pass the model-axis check for both."""
    from paa_tpu.parallel import mesh as jmesh
    from paa_tpu_torch.train import loop

    argv = ["--model", "wav2vec2-base", "--tp", str(tp), "--batch_size", "8"]
    targs = tparser.parse_args(argv)
    cfg = tparser.config_from_args(targs)
    assert cfg.tp == tp == jparser.config_from_args(jparser.create_arg_parser().parse_args(argv)).tp
    with pytest.raises(ValueError) as want:
        jmesh.decide_mesh(tp, 8, n_devices=1)
    with pytest.raises(ValueError) as got:
        loop.AttackRunner(cfg, model=None, pipe=None)
    assert str(got.value) == str(want.value) == f"--tp {tp} must divide the device count 1"


def test_dense_attention_is_accepted_on_the_cpu():
    assert tparser.parse_args(["--attention_impl", "xla", "--platform", "cpu"]).platform == "cpu"


def test_entry_point_runs_on_the_cpu(tmp_path):
    """``--platform cpu``: one epoch on the tiny checkpoint writes the run
    directory of the JAX CLI, the STFT spectrograms of the improving epoch
    included."""
    args = tparser.parse_args([
        "--platform", "cpu", "--model", "wav2vec2-tiny", "--checkpoint_path", TINY_CKPT,
        "--dataset", "synthetic", "--synthetic_samples", "48", "--batch_size", "8",
        "--num_epochs", "1", "--norm_type", "fletcher_munson", "--optimizer_type", "pgd",
        "--accum_steps", "2", "--num_items_to_inspect", "0", "--save_root", str(tmp_path),
        "--tensorboard"])
    assert trun.main(args) == 0
    run_dir = trun.make_save_dir(args)
    assert run_dir == str(tmp_path / "untargeted" / "synthetic" / "fletcher_munson_2_untargeted_pgd")
    results = json.loads(open(os.path.join(run_dir, "results.json")).read())
    assert results["finished_training"] is True and results["attack_size"] == 2.0
    for f in ("perturbation.npy", "metrics.jsonl", "train.log", "attack_state.pt", "tb"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    if artifacts.HAVE_MPL:
        for f in ("perturbation.png", "perturbation_stft_linear.png", "perturbation_stft_log.png"):
            assert os.path.exists(os.path.join(run_dir, f)), f


@pytest.mark.parametrize("norm, panel", [("max_phon", "phon_projection_debug_epoch0.png"),
                                         ("fletcher_munson", "fm_weights_epoch0.png")])
def test_debug_plots_are_written(tmp_path, norm, panel):
    """``--debug_plots`` is accepted and draws the reference's panel on the
    improving epoch."""
    if not artifacts.HAVE_MPL:
        pytest.skip("matplotlib unavailable")
    args = tparser.parse_args([
        "--platform", "cpu", "--model", "wav2vec2-tiny", "--dataset", "synthetic",
        "--synthetic_samples", "24", "--synthetic_words", "3,4", "--batch_size", "8",
        "--num_epochs", "1", "--norm_type", norm, "--optimizer_type", "pgd",
        "--compute_dtype", "float32", "--num_items_to_inspect", "0", "--debug_plots",
        "--save_root", str(tmp_path)])
    assert trun.main(args) == 0
    assert os.path.exists(os.path.join(trun.make_save_dir(args), panel))


PROFILE_ARGV = ["--platform", "cpu", "--model", "wav2vec2-tiny", "--checkpoint_path", TINY_CKPT,
                "--dataset", "synthetic", "--synthetic_samples", "48", "--small_data",
                "--batch_size", "8", "--num_epochs", "1", "--optimizer_type", "pgd",
                "--num_items_to_inspect", "0"]


def test_profile_writes_a_trace_and_leaves_the_run_unchanged(tmp_path):
    """``--profile`` traces the attack loop into <save_dir>/profile/ (a
    Chrome trace with CPU events); results.json, its wall-clock rate
    aside, and the perturbation equal the same run's without it."""
    runs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile"])):
        args = tparser.parse_args(PROFILE_ARGV + extra + ["--save_root", str(tmp_path / name)])
        assert trun.main(args) == 0
        runs[name] = trun.make_save_dir(args)
    trace = os.path.join(runs["profiled"], "profile", "trace.json")
    events = json.loads(open(trace).read())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not os.path.exists(os.path.join(runs["plain"], "profile"))
    results = {k: json.loads(open(os.path.join(d, "results.json")).read()) for k, d in runs.items()}
    for r in results.values():
        assert r.pop("steps_per_sec") > 0
    assert results["profiled"] == results["plain"]
    p = {k: np.load(os.path.join(d, "perturbation.npy")) for k, d in runs.items()}
    assert np.array_equal(p["profiled"], p["plain"])


def test_sweep_refuses_profile(capsys):
    """The JAX sweep accepts --profile and never traces; the port's refuses it."""
    with pytest.raises(SystemExit) as e:
        tsweep.parse_args(["--profile"])
    assert e.value.code == 2 and "--profile" in capsys.readouterr().err


def test_default_platform_without_a_gpu_fails(tmp_path):
    """``python -m paa_tpu_torch.cli.run_attack`` on the default
    ``--platform cuda`` with no CUDA device exits 1 with a failure
    results.json; it does not carry on on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.cli.run_attack", "--model", "wav2vec2-tiny",
         "--dataset", "synthetic", "--synthetic_samples", "48", "--norm_type", "linf",
         "--save_root", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    results = json.loads((tmp_path / "untargeted" / "synthetic" / "linf_0.0001_untargeted_adam"
                          / "results.json").read_text())
    assert "no CUDA device" in results["error"] and results["finished_training"] is False
