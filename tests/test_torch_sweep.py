"""The port's ε sweep (``paa_tpu_torch.cli.sweep``) against paa_tpu's.

Pure functions and the sweep steps are held against the JAX package on the
same inputs; the sweep's semantics follow the slow-marked
``tests/test_sweep_cli.py`` on the port alone: a 1-cell sweep is a
``run_attack`` run, a resumed sweep equals an uninterrupted one, a changed
configuration is refused, frozen cells leave at once, ``--cell_artifacts``
writes the full bundle. Tiny preset, float32, synthetic data, on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.attack import optimizers as jopt
from paa_tpu.attack import step as jstep
from paa_tpu.cli import sweep as jsweep
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.ops import dsp as jdsp
from paa_tpu.ops import psycho as jpsycho
from paa_tpu.ops import text
from paa_tpu.parallel import mesh as jmesh
from paa_tpu_torch import config as tcfg
from paa_tpu_torch.attack import optimizers as topt
from paa_tpu_torch.attack import step as tstep
from paa_tpu_torch.cli import aggregate, sweep
from paa_tpu_torch.cli import parser as tparser
from paa_tpu_torch.data import datasets, pipeline
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.cli import run_attack as trun
from paa_tpu_torch.ops import psycho as tpsycho
from paa_tpu_torch.train import artifacts, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(REPO, "benchmarks", "quality_r5", "cells",
                          "adam_ab_sweep_results.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work. When several pytest
    workers share the cores, torch's thread pools in each of them contend
    for the same cores and a tiny sweep runs about 100× slower than alone;
    at these sizes one thread costs little."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# pure functions against the JAX package's
# ---------------------------------------------------------------------------


def test_default_grids_match():
    assert sweep.DEFAULT_GRIDS == jsweep.DEFAULT_GRIDS


DROP_TABLE = [(live, cur, dev) for dev in (1, 2, 4, 8) for cur in range(0, 9)
              for live in range(0, cur + 2)]


def test_ns_for_and_should_drop_match():
    for s in range(1, 9):
        for dev in (1, 2, 4, 8):
            assert sweep._ns_for(s, dev) == jsweep._ns_for(s, dev), (s, dev)
    for live, cur, dev in DROP_TABLE:
        assert sweep._should_drop(live, cur, dev) == jsweep._should_drop(live, cur, dev), \
            (live, cur, dev)
    # one device, the port's case: drop the moment any cell freezes
    assert all(sweep._should_drop(live, cur, 1) for cur in range(2, 9) for live in range(1, cur))


@pytest.mark.parametrize("mode, opt, norm, size", [
    ("untargeted", "pgd", "max_phon", 25.0), ("targeted", "adam", "linf", 1e-4),
    ("untargeted", "adam", "min_max_freqs", 100.0)])
def test_cell_dir_matches(mode, opt, norm, size):
    argv = ["--attack_mode", mode, "--optimizer_type", opt, "--dataset", "synthetic"]
    targs = sweep.create_sweep_parser().parse_args(argv)
    jargs = jsweep.create_sweep_parser().parse_args(argv)
    got = sweep._cell_dir("/r", targs, tparser.config_from_args(targs), norm, size)
    want = jsweep._cell_dir("/r", jargs, jcfg.AttackConfig(attack_mode=mode, optimizer_type=opt),
                            norm, size)
    assert got == want


@pytest.mark.parametrize("norm", sorted(tcfg.SWEEP_FIELD))
@pytest.mark.parametrize("value", [0.25, [2.0, 4.0, 8.0]], ids=["scalar", "vector"])
def test_with_sweep_value_matches(norm, value):
    want = jcfg.with_sweep_value(jcfg.ConstraintParams.create(), norm, value)
    got = tcfg.with_sweep_value(tcfg.ConstraintParams.create(), norm, value)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w)


def test_sweep_parser_matches_and_refuses():
    """The sweep's flags parse as the JAX sweep's (the port's own refusals
    aside); --tp > 1 is refused."""
    jdef = vars(jsweep.create_sweep_parser().parse_args([]))
    tdef = vars(sweep.create_sweep_parser().parse_args([]))
    assert set(jdef) == set(tdef)
    assert {k for k in jdef if jdef[k] != tdef[k]} == {"platform", "device_probe_timeout"}
    with pytest.raises(SystemExit):
        sweep.parse_args(["--tp", "2"])
    with pytest.raises(SystemExit, match="--tp > 1"):
        sweep.run_sweep(sweep.create_sweep_parser().parse_args(["--tp", "2"]))


# ---------------------------------------------------------------------------
# one sweep step and one sweep eval against JAX's multiplexed form
# ---------------------------------------------------------------------------

T = 8000
LR = 1e-3
SIZES = [0.05, 0.02, 0.1]
ACTIVE = np.array([1.0, 0.0, 1.0], np.float32)  # cell 1 is frozen


@pytest.fixture(scope="module")
def step_setup():
    jc = jw2v.get_config("wav2vec2-tiny")
    params = jw2v.init_params(jc, seed=2, example_len=2000)
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jmodel.apply({"params": prm}, a)
    model = tw2v.Wav2Vec2ForCTC(tw2v.get_config("wav2vec2-tiny"))
    model.load_state_dict(convert.params_from_jax(params, model.cfg))
    rng = np.random.default_rng(13)
    audio = (rng.standard_normal((3, T)) * 0.3).astype(np.float32)
    audio[0, :100] = 1.5  # clamped samples
    labels, pads = text.encode_batch(["hello world", "delete", "test tone"])
    weights = np.array([1.0, 1.0, 0.0], np.float32)  # a padding row
    S = len(SIZES)
    p_s = (rng.standard_normal((S, 1, T)) * 1e-3).astype(np.float32)
    mu = (rng.standard_normal((S, 1, T)) * 1e-2).astype(np.float32)
    nu = (mu ** 2 + rng.uniform(1e-6, 1e-4, (S, 1, T))).astype(np.float32)
    count = np.array([3, 5, 1], np.int32)
    return params, japply, model, audio, labels, pads, weights, p_s, (count, mu, nu)


def _cparams_s(mod, S):
    base = mod.ConstraintParams.create()
    if mod is jcfg:
        return mod.with_sweep_value(jax.tree.map(lambda x: jnp.broadcast_to(x, (S,)), base),
                                    "l2", np.asarray(SIZES, np.float32))
    return mod.with_sweep_value(mod.ConstraintParams(*(x.expand(S) for x in base)), "l2", SIZES)


def test_sweep_step_matches_jax_with_a_frozen_cell(step_setup):
    params, japply, model, audio, labels, pads, weights, p_s, (count, mu, nu) = step_setup
    S = len(SIZES)
    kw = dict(norm_type="l2", optimizer_type="adam", lr=LR)
    jc, tc = jcfg.AttackConfig(**kw), tcfg.AttackConfig(**kw)
    mesh = jmesh.sweep_mesh(n_sweep=1, n_devices=1)
    jstep_fn = jstep.make_sweep_step(jc, japply, jpsycho.build_tables(jc), mesh)
    tstep_fn = tstep.make_sweep_step(tc, model, tpsycho.build_tables(tc))
    jopt_s = jopt.OptState(inner=optax.ScaleByAdamState(
        count=jnp.asarray(count), mu=jnp.asarray(mu), nu=jnp.asarray(nu)))
    topt_s = topt.AdamState(*(torch.from_numpy(a.copy()) for a in (count, mu, nu)))
    tp_in = torch.from_numpy(p_s.copy())
    jp, jst, jm = jstep_fn(params, jnp.asarray(p_s), jopt_s,
                           *(jnp.asarray(a) for a in (audio, labels, pads, weights)),
                           _cparams_s(jcfg, S), jnp.asarray(ACTIVE), jnp.float32(LR))
    tp, tst, tm = tstep_fn(tp_in, topt_s, *(torch.from_numpy(a) for a in (audio, labels, pads, weights)),
                           _cparams_s(tcfg, S), ACTIVE, LR)
    assert tuple(tp.shape) == (S, 1, T) and tuple(tm.ctc_loss.shape) == (S,)
    np.testing.assert_allclose(tm.ctc_loss.numpy(), np.asarray(jm.ctc_loss), rtol=1e-4)
    np.testing.assert_array_equal(tm.greedy_ids.numpy(), np.asarray(jm.greedy_ids))
    # the frozen cell: its state comes back bit for bit
    assert torch.equal(tp[1], torch.from_numpy(p_s[1]))
    for got, want in zip(tst, (count, mu, nu)):
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    # the live cells at test_torch_step's Adam tolerances
    inner = jst.inner
    np.testing.assert_array_equal(tst.count.numpy(), np.asarray(inner.count))
    np.testing.assert_array_equal(tst.count.numpy(), count + ACTIVE.astype(np.int32))
    for i in (0, 2):
        scale = np.abs(np.asarray(inner.mu[i])).max()
        np.testing.assert_allclose(tst.mu[i].numpy(), np.asarray(inner.mu[i]), atol=1e-3 * scale)
        np.testing.assert_allclose(tst.nu[i].numpy(), np.asarray(inner.nu[i]), rtol=2e-3,
                                   atol=1e-3 * np.abs(np.asarray(inner.nu[i])).max())
        diff = np.abs(tp[i].numpy() - np.asarray(jp[i]))
        assert np.mean(diff < 1e-2 * LR) >= 0.99
        assert diff.max() <= 2 * LR * 1.01
    np.testing.assert_array_equal(np.asarray(jp[1]), p_s[1])


def test_sweep_eval_matches_jax(step_setup):
    """The JAX multiplexed sweep eval against the port's, the single-cell
    eval step once per cell (as the driver runs it through
    ``AttackRunner.evaluate``)."""
    params, japply, model, audio, labels, pads, weights, p_s, _ = step_setup
    mesh = jmesh.sweep_mesh(n_sweep=1, n_devices=1)
    jm = jstep.make_sweep_eval_step(jcfg.AttackConfig(), japply, mesh)(
        params, jnp.asarray(p_s), *(jnp.asarray(a) for a in (audio, labels, pads, weights)))
    evaluate = tstep.make_eval_step(tcfg.AttackConfig(), model)
    batch = [torch.from_numpy(a) for a in (audio, labels, pads, weights)]
    tm = [evaluate(torch.from_numpy(p), *batch) for p in p_s]
    np.testing.assert_allclose([float(m.ctc_loss) for m in tm], np.asarray(jm.ctc_loss),
                               rtol=1e-4)
    np.testing.assert_array_equal(np.stack([m.greedy_ids.numpy() for m in tm]),
                                  np.asarray(jm.greedy_ids))


# ---------------------------------------------------------------------------
# the sweep CLI on the port alone
# ---------------------------------------------------------------------------

BASE = {
    "platform": "cpu",
    "dataset": "synthetic",
    "synthetic_samples": 24,
    "synthetic_words": "3,4",
    "model": "wav2vec2-tiny",
    "compute_dtype": "float32",
    "batch_size": 8,
    "num_epochs": 1,
    "optimizer_type": "pgd",
    "lr": 5e-3,
    "num_items_to_inspect": 0,
}


def _argv(save_root, **kw):
    flags = dict(BASE, save_root=str(save_root), **kw)
    argv = []
    for k, v in flags.items():
        if isinstance(v, bool):  # store_true flags take no value
            argv += [f"--{k}"] if v else []
        else:
            argv += [f"--{k}", str(v)]
    return argv


def _sweep_args(save_root, **kw):
    return sweep.parse_args(_argv(save_root, **kw))


@pytest.fixture
def no_plots(monkeypatch):
    """The tests of what the sweep computes draw no PNG (matplotlib takes
    most of a tiny sweep's time); the bundle's plots are checked above."""
    monkeypatch.setattr(artifacts, "HAVE_MPL", False)


@pytest.fixture(scope="module")
def cli_sweep(tmp_path_factory):
    """A 2-norm, 3-cell sweep through the entry point, with the full
    per-cell bundle."""
    root = tmp_path_factory.mktemp("sweep")
    argv = _argv(root, norms="linf,max_phon", grid=json.dumps({"linf": [1e-3, 1e-2],
                                                              "max_phon": [25.0]}),
                 cell_artifacts=True, num_items_to_inspect=2, tensorboard=True)
    assert sweep.main(argv) == 0
    with open(root / "sweep_results.json") as f:
        return root, json.load(f)


def test_cli_sweep_writes_cells_and_summary(cli_sweep):
    root, summary = cli_sweep
    assert [len(summary[n]["cells"]) for n in ("linf", "max_phon")] == [2, 1]
    assert os.path.exists(root / "sweep.log")
    for entry in summary.values():
        assert entry["mesh"] == "(sweep=1, data=1)"
        for cell in entry["cells"]:
            r = json.load(open(os.path.join(cell["dir"], "results.json")))
            assert r["finished_training"] is True
            for f in ("perturbation.npy", "metrics.jsonl", "perturbation.wav",
                      "perturbation_5x.wav", "tb"):
                assert os.path.exists(os.path.join(cell["dir"], f)), f
            for key in ("final_ctc", "test_pert_ctc", "test_pert_wer", "best_eval_pert_ctc",
                        "test_clean_ctc"):
                assert np.isfinite(cell[key]), key
            assert cell["best_epoch"] == 0
    for cell in summary["linf"]["cells"]:
        p = np.load(os.path.join(cell["dir"], "perturbation.npy"))
        assert np.abs(p).max() <= cell["size"] * (1 + 1e-5)


def test_cli_sweep_results_keys_equal_the_jax_record(cli_sweep):
    _, summary = cli_sweep
    with open(JAX_RECORD) as f:
        record = json.load(f)
    want_norm = {k for entry in record.values() for k in entry}
    want_cell = {k for entry in record.values() for c in entry["cells"] for k in c}
    for entry in summary.values():
        assert set(entry) == want_norm
        for cell in entry["cells"]:
            assert set(cell) == want_cell


def test_cli_sweep_cell_artifacts_full_bundle(cli_sweep):
    """--cell_artifacts: the loss plots, inspected sample triples, and the
    max_phon debug panel."""
    _, summary = cli_sweep
    for entry in summary.values():
        for cell in entry["cells"]:
            d = cell["dir"]
            samples = [s for s in os.listdir(d) if s.startswith(("sample_", "sus_sample_"))]
            assert len(samples) == 2, d
            assert os.path.exists(os.path.join(d, sorted(samples)[0], "perturbed.wav"))
            if artifacts.HAVE_MPL:
                for f in ("loss_plot_ctc.png", "loss_plot_wer.png", "perturbation.png",
                          "perturbation_stft_linear.png", "perturbation_stft_log.png"):
                    assert os.path.exists(os.path.join(d, f)), f
    if artifacts.HAVE_MPL:
        d = summary["max_phon"]["cells"][0]["dir"]
        assert os.path.exists(os.path.join(d, "phon_projection_debug_final.png"))


def test_aggregate_renders_the_sweep(cli_sweep, capsys, monkeypatch):
    root, _ = cli_sweep
    rows = aggregate.collect(str(root))
    assert sorted(r["norm_type"] for r in rows) == ["linf", "linf", "max_phon"]
    assert all(r["finished"] and np.isfinite(r["pert_ctc"]) for r in rows)
    monkeypatch.setattr("sys.argv", ["aggregate", "--root", str(root)])
    assert aggregate.main() == 0
    table = capsys.readouterr().out
    assert "linf" in table and "max_phon" in table and "0.001" in table


def test_sweep_without_a_gpu_fails(tmp_path):
    """The default --platform cuda without a CUDA device: exit 1 and
    sweep_failure.json, no run on the CPU."""
    argv = [a for a in _argv(tmp_path) if a not in ("--platform", "cpu")]
    assert sweep.main(argv) == 1
    failure = json.load(open(tmp_path / "sweep_failure.json"))
    assert failure["finished_training"] is False and "no CUDA device" in failure["error"]


@pytest.mark.usefixtures("no_plots")
def test_one_cell_sweep_matches_run_attack(tmp_path):
    """A 1-cell sweep is a run_attack run of that epsilon: the same best
    epoch, perturbation and test scores."""
    eps = 0.02
    args = _sweep_args(tmp_path / "sweep", norms="linf", grid=json.dumps({"linf": [eps]}),
                       num_epochs=2, optimizer_type="adam")
    cell = sweep.run_sweep(args)["linf"]["cells"][0]

    cfg = tparser.config_from_args(args).replace(norm_type="linf")
    cparams = tcfg.with_sweep_value(tparser.constraint_params_from_args(args), "linf", eps)
    samples = datasets.load_dataset_tuples(
        "synthetic", seed=args.seed, synthetic_samples=args.synthetic_samples,
        synthetic_words=(3, 4))
    pipe = pipeline.build_pipeline(samples, seed=args.seed)
    res = loop.run_attack(cfg, trun.load_model(args, torch.device("cpu")), pipe,
                          str(tmp_path / "single"), cparams=cparams, num_items_to_inspect=0,
                          resume=False)

    assert cell["best_epoch"] == res.best_epoch
    np.testing.assert_allclose(np.load(os.path.join(cell["dir"], "perturbation.npy")),
                               res.perturbation, rtol=2e-3, atol=1e-6)
    r = json.load(open(os.path.join(cell["dir"], "results.json")))
    assert r["finished_training"] is True
    np.testing.assert_allclose(r["final_test_perturbed"]["ctc"], res.test_perturbed.ctc,
                               rtol=1e-3)
    np.testing.assert_allclose(r["final_test_clean"]["ctc"], res.test_clean.ctc, rtol=1e-3)


def _preempt_after_epochs(args):
    """A sweep that dies at finalize, after its last epoch's checkpoint."""
    def boom(*a, **k):
        raise RuntimeError("preempted")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(artifacts, "save_epoch_bundle", boom)
        with pytest.raises(RuntimeError, match="preempted"):
            sweep.run_sweep(args)


@pytest.mark.usefixtures("no_plots")
def test_sweep_resume_is_exact(tmp_path):
    """1 epoch, preemption, 1 more resumed == 2 uninterrupted epochs, with
    Adam state in the checkpoint; a finished sweep run again goes straight
    to finalize."""
    kw = dict(norms="linf", grid=json.dumps({"linf": [5e-3, 2e-2]}), early_stopping=99,
              optimizer_type="adam")
    s1 = sweep.run_sweep(_sweep_args(tmp_path / "straight", num_epochs=2, **kw))
    assert os.path.exists(tmp_path / "straight" / "sweep_state_linf.pt")

    _preempt_after_epochs(_sweep_args(tmp_path / "resumed", num_epochs=1, **kw))
    assert os.path.exists(tmp_path / "resumed" / "sweep_state_linf.pt")
    s2 = sweep.run_sweep(_sweep_args(tmp_path / "resumed", num_epochs=2, **kw))

    for c1, c2 in zip(s1["linf"]["cells"], s2["linf"]["cells"]):
        np.testing.assert_array_equal(np.load(os.path.join(c1["dir"], "perturbation.npy")),
                                      np.load(os.path.join(c2["dir"], "perturbation.npy")))
        assert c1["test_pert_ctc"] == c2["test_pert_ctc"]
        lines = [json.loads(line) for line in open(os.path.join(c2["dir"], "metrics.jsonl"))]
        assert [line["epoch"] for line in lines] == [0, 1]

    d1 = s1["linf"]["cells"][0]["dir"]
    metrics_before = open(os.path.join(d1, "metrics.jsonl")).read()
    s3 = sweep.run_sweep(_sweep_args(tmp_path / "straight", num_epochs=2, **kw))
    assert s3["linf"]["n_cell_steps"] == 0
    assert open(os.path.join(d1, "metrics.jsonl")).read() == metrics_before
    r = json.load(open(os.path.join(d1, "results.json")))
    assert r.get("sweep_steps_per_sec") not in (None, 0, 0.0)


@pytest.mark.usefixtures("no_plots")
def test_sweep_resume_refuses_changed_config(tmp_path):
    kw = dict(norms="linf", early_stopping=99)
    _preempt_after_epochs(_sweep_args(tmp_path, grid=json.dumps({"linf": [5e-3]}), **kw))
    with pytest.raises(RuntimeError, match="different configuration"):
        sweep.run_sweep(_sweep_args(tmp_path, grid=json.dumps({"linf": [1e-3]}), **kw))
    summary = sweep.run_sweep(_sweep_args(tmp_path, grid=json.dumps({"linf": [1e-3]}),
                                          no_resume=True, **kw))
    assert summary["linf"]["cells"][0]["size"] == 1e-3


@pytest.mark.usefixtures("no_plots")
def test_sweep_drops_frozen_cells_and_counts_active_steps(tmp_path):
    """linf ε=0 projects p to 0 every step: the cell improves once (epoch 0)
    and early-stops after ``early_stopping`` flat epochs. It leaves the
    device state at once, and only active cells count as steps."""
    args = _sweep_args(tmp_path, norms="linf", grid=json.dumps({"linf": [0.0, 1e-2, 2e-2]}),
                       num_epochs=4, early_stopping=2)
    entry = sweep.run_sweep(args)["linf"]
    dead = [c for c in entry["cells"] if c["size"] == 0.0][0]
    assert len(open(os.path.join(dead["dir"], "metrics.jsonl")).read().splitlines()) == 3
    assert dead["best_epoch"] == 0
    assert np.all(np.load(os.path.join(dead["dir"], "perturbation.npy")) == 0)
    assert 2 in entry["programs_built"] and 3 in entry["programs_built"]

    pipe = pipeline.build_pipeline(datasets.load_dataset_tuples(
        "synthetic", seed=args.seed, synthetic_samples=args.synthetic_samples,
        synthetic_words=(3, 4)), seed=args.seed)
    n_batches = -(-len(pipe.train) // args.batch_size)
    per_cell = [len(open(os.path.join(c["dir"], "metrics.jsonl")).read().splitlines())
                for c in entry["cells"]]
    assert entry["n_cell_steps"] == n_batches * sum(per_cell)
    assert entry["n_cell_steps"] < n_batches * max(per_cell) * len(per_cell)


# ---------------------------------------------------------------------------
# the plots' arrays against the JAX computation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plot_p():
    return (np.random.default_rng(3).standard_normal((1, 16000)) * 0.01).astype(np.float32)


def test_stft_db_matches_jax(plot_p, tmp_path):
    cfg = tcfg.AttackConfig()
    mag = np.asarray(jnp.abs(jdsp.stft(jnp.asarray(plot_p), cfg.n_fft, cfg.hop_length,
                                       cfg.win_length)))
    want = 20.0 * np.log10(mag + 1e-8)
    got = artifacts.stft_db(plot_p[0], cfg)
    assert got.shape == want.shape == (1, 513, 63)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    artifacts.stft_plot(str(tmp_path / "p"), plot_p[0], cfg)
    if artifacts.HAVE_MPL:
        assert os.path.exists(tmp_path / "p_linear.png")
        assert os.path.exists(tmp_path / "p_log.png")


@pytest.mark.parametrize("level", [12.5, 25.0])
def test_debug_phon_arrays_match_jax(plot_p, level):
    cfg = tcfg.AttackConfig(norm_type="max_phon")
    jc = jcfg.AttackConfig(norm_type="max_phon")
    jcp = jcfg.ConstraintParams.create(max_phon_level=level)
    mag = np.asarray(jnp.abs(jdsp.stft(jnp.asarray(plot_p), jc.n_fft, jc.hop_length,
                                       jc.win_length)))
    mag_db = 20.0 * np.log10(mag + 1e-8)
    contour = np.asarray(jpsycho.phon_contour(jpsycho.build_tables(jc), jcp.max_phon_level))
    want_thresh = contour - contour.max() + jc.phon_reference_db
    want_clipped = np.minimum(mag_db, want_thresh[:, None])
    got_db, got_clipped, got_thresh = artifacts.debug_phon_arrays(
        plot_p, cfg, tcfg.ConstraintParams.create(max_phon_level=level),
        tpsycho.build_tables(cfg))
    np.testing.assert_allclose(got_thresh, want_thresh, atol=1e-4)
    np.testing.assert_allclose(got_clipped, want_clipped, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_db, mag_db, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("norm, png", [("max_phon", "phon_projection_debug_epoch3.png"),
                                       ("fletcher_munson", "fm_weights_epoch3.png")])
def test_debug_plots_written(plot_p, tmp_path, norm, png):
    if not artifacts.HAVE_MPL:
        pytest.skip("matplotlib unavailable")
    cfg = tcfg.AttackConfig(norm_type=norm)
    artifacts.save_debug_plots(str(tmp_path), plot_p, cfg,
                               tcfg.ConstraintParams.create(max_phon_level=25.0),
                               tpsycho.build_tables(cfg), tag="epoch3")
    assert os.path.exists(tmp_path / png)
