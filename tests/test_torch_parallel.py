"""The port's data and tensor parallelism against paa_tpu.parallel and the
JAX package's sharded steps.

The mesh and tp helpers are held against JAX's over a grid of sizes. The
sharded steps run in gloo rank processes on the CPU (``torch_parallel_ranks``,
which imports no JAX): 2 ranks as dp=2 and as tp=2, 4 ranks as dp=2 × tp=2,
and the sweep with one cell per sweep slice on 2 and on 4 ranks. This
process computes the JAX package's ``make_sharded_step`` and
``make_sharded_eval_step`` on its dp=2 × tp=2 mesh and ``make_sweep_step``
on a (sweep=2, data=2) mesh of its 8-device virtual mesh
(``tests/conftest.py``), once per case, while the ranks run: every layout
computes the same function, in another order of its sums. Tiny model in
float32, at ``tests/test_torch_step.py``'s tolerances: loss rtol 1e-4,
∂loss/∂p atol 1e-3 of its largest value, equal greedy ids.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paa_tpu import config as jcfg
from paa_tpu.attack import optimizers as jopt
from paa_tpu.attack import step as jstep
from paa_tpu.models import wav2vec2 as jw2v
from paa_tpu.ops import psycho as jpsycho
from paa_tpu.ops import text
from paa_tpu.parallel import mesh as jmesh
from paa_tpu.parallel import tp as jtp
from paa_tpu_torch.models import convert
from paa_tpu_torch.models import wav2vec2 as tw2v
from paa_tpu_torch.parallel import mesh as tmesh
from paa_tpu_torch.parallel import tp as ttp
import torch_parallel_ranks as ranks  # tests/ is on sys.path

B, T, LR = ranks.B, ranks.T, ranks.LR

# ---------------------------------------------------------------------------
# mesh and tp helpers
# ---------------------------------------------------------------------------


def _outcome(fn, *args, **kw):
    """(axis names, sizes) of the mesh ``fn`` makes, None, or the error."""
    try:
        m = fn(*args, **kw)
    except ValueError as e:
        return ("error", str(e))
    if m is None:
        return None
    return tuple(m.axis_names), tuple(int(m.shape[a]) for a in m.axis_names)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_decide_and_tp_mesh_match_jax(world, tp):
    for batch in (6, 8, 12):
        assert (_outcome(tmesh.decide_mesh, tp, batch, n_devices=world)
                == _outcome(jmesh.decide_mesh, tp, batch, n_devices=world)), (tp, batch)
    assert _outcome(tmesh.tp_mesh, tp, n_devices=world) == _outcome(jmesh.tp_mesh, tp,
                                                                     n_devices=world)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_sweep_and_data_mesh_match_jax(world):
    for n_sweep in (1, 2, 3, 4, 8):
        assert (_outcome(tmesh.sweep_mesh, n_sweep, n_devices=world)
                == _outcome(jmesh.sweep_mesh, n_sweep, n_devices=world)), n_sweep
    assert _outcome(tmesh.data_mesh, world) == _outcome(jmesh.data_mesh, world)


def _jax_leaf_names(params) -> dict:
    """Each port state-dict name → the path of the JAX leaf it comes from:
    every leaf filled with its own index goes through ``params_from_jax``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i, np.float32) for i, (_, x) in enumerate(flat)])
    return marked, [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in flat]


@pytest.mark.parametrize("preset", ["wav2vec2-tiny", "wav2vec2-base"])
def test_param_spec_matches_jax(preset):
    """Every parameter is column-split, row-split or replicated as its JAX
    leaf is, through convert's name map; the split dim is the JAX split
    dim's counterpart in the port's (out, in) layout."""
    jc = jw2v.get_config(preset)
    params = jax.eval_shape(lambda: jw2v.init_params(jc, example_len=2000))
    marked, paths = _jax_leaf_names(params)
    sd = convert.params_from_jax(marked, tw2v.get_config(preset))
    kinds = {"col": 0, "row": 0, "repl": 0}
    for name, t in sd.items():
        path = paths[int(t.flatten()[0])]
        spec = jtp.param_spec(path, len(_leaf_shape(params, path)))
        split = [i for i, s in enumerate(spec) if s == "model"]
        if not split:
            want, kind = None, "repl"
        elif split[0] == len(spec) - 1:
            want, kind = 0, "col"  # the JAX out features: dim 0 of (out, in) and (out,)
        else:
            want, kind = 1, "row"  # the JAX in features: dim 1 of (out, in)
        assert ttp.param_spec(name) == want, (name, path, spec)
        kinds[kind] += 1
    L = jc.num_hidden_layers
    assert kinds["col"] == 8 * L and kinds["row"] == 2 * L and kinds["repl"] > 0


def _leaf_shape(tree, path):
    for key in path:
        tree = tree[key]
    return tree.shape


@pytest.mark.parametrize("preset, n", [("wav2vec2-tiny", 8), ("wav2vec2-tiny", 3),
                                       ("wav2vec2-base", 5), ("wav2vec2-base", 4)])
def test_check_model_axis_matches_jax(preset, n):
    def outcome(check, cfg):
        try:
            check(cfg, n)
            return None
        except ValueError as e:
            return str(e)

    want = outcome(jtp.check_model_axis, jw2v.get_config(preset))
    assert outcome(ttp.check_model_axis, tw2v.get_config(preset)) == want


def test_sharded_conversion_slices_the_full_one():
    """``convert.sharded_params_from_jax`` is the full conversion cut by
    ``param_spec``: the slices of every rank put back together are the full
    tensors, and they load into the sharded model."""
    jc = jw2v.get_config("wav2vec2-tiny")
    params = jax.tree.map(np.asarray, jw2v.init_params(jc, seed=1, example_len=2000))
    cfg = tw2v.get_config("wav2vec2-tiny")
    full = convert.params_from_jax(params, cfg)
    shards = [convert.sharded_params_from_jax(params, cfg, r, 2) for r in range(2)]
    for name, t in full.items():
        dim = ttp.param_spec(name)
        if dim is None:
            assert all(torch.equal(s[name], t) for s in shards), name
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim), t), name
    axis = ttp.ModelAxis(group=None, size=2, rank=1)
    model = tw2v.Wav2Vec2ForCTC(cfg, model_axis=axis)
    model.load_state_dict(shards[1])
    attn = model.wav2vec2.encoder.layers[0].attention
    assert attn.heads == 2 and tuple(attn.q_proj.weight.shape) == (32, 64)
    assert tuple(model.wav2vec2.encoder.layers[0].feed_forward.output_dense.weight.shape) == (64, 64)


# ---------------------------------------------------------------------------
# the sharded steps in rank processes against JAX's
# ---------------------------------------------------------------------------

def _jax_mesh():
    """The JAX package's dp=2 × tp=2 mesh, the reference of every layout:
    its sharded steps partition the batch and the encoder both."""
    return jmesh.tp_mesh(2, n_devices=4)


@pytest.fixture(scope="module")
def setup():
    jc = jw2v.get_config("wav2vec2-tiny")
    params = jw2v.init_params(jc, seed=2, example_len=2000)
    jmodel = jw2v.Wav2Vec2ForCTC(jc)
    japply = lambda prm, a: jmodel.apply({"params": prm}, a)
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    audio[0, :100] = 1.5  # clamped samples
    labels, pads = text.encode_batch(["hello world", "delete", "test tone", "a b c"] * 2)
    weights = np.ones(B, np.float32)
    weights[-1] = 0.0  # a padding row
    p0 = (rng.standard_normal((1, T)) * 1e-3).astype(np.float32)
    S = len(ranks.SWEEP_SIZES)
    sweep_p = (rng.standard_normal((S, 1, T)) * 1e-3).astype(np.float32)
    mu = (rng.standard_normal((S, 1, T)) * 1e-2).astype(np.float32)
    nu = (mu ** 2 + rng.uniform(1e-6, 1e-4, (S, 1, T))).astype(np.float32)
    count = np.array([3, 5], np.int32)
    arrays = dict(audio=audio, labels=labels, pads=pads, weights=weights, p0=p0,
                  sweep_p=sweep_p, sweep_opt=(count, mu, nu))
    return params, japply, arrays


def _torch_inputs(params, arrays) -> dict:
    cfg = tw2v.get_config("wav2vec2-tiny")
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()
           if k != "sweep_opt"}
    inp["sweep_opt"] = [torch.from_numpy(a.copy()) for a in arrays["sweep_opt"]]
    params = jax.tree.map(np.asarray, params)
    inp["state_dict"] = convert.params_from_jax(params, cfg)
    # each model rank's slice on a 2-way model axis, for fused_qkv
    inp["tp_shards"] = [convert.sharded_params_from_jax(params, cfg, r, 2) for r in range(2)]
    return inp


def _jax_reference(params, japply, arrays) -> dict:
    """JAX's sharded steps on its dp=2 × tp=2 mesh, once per case (each
    compiles once; the port's layouts all answer to it), its sweep on a
    (sweep=2, data=2) mesh, and ∂loss/∂p of the one-device step."""
    batch = [jnp.asarray(arrays[k]) for k in ("audio", "labels", "pads", "weights")]
    p0 = jnp.asarray(arrays["p0"])
    cfg0 = jcfg.AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=LR)
    loss, ids, grad = jax.jit(lambda *a: jstep._grad_and_metrics(*a, japply, params, cfg0))(
        p0, *batch)
    out = {"grad": np.asarray(grad), "grad_loss": float(loss), "grad_ids": np.asarray(ids)}
    fused = jw2v.Wav2Vec2ForCTC(jw2v.get_config("wav2vec2-tiny", fused_qkv=True))
    loss, ids, grad = jax.jit(lambda *a: jstep._grad_and_metrics(
        *a, lambda prm, x: fused.apply({"params": prm}, x), params, cfg0))(p0, *batch)
    out["fused_qkv"] = {"grad": np.asarray(grad), "grad_loss": float(loss),
                        "grad_ids": np.asarray(ids)}
    mesh = _jax_mesh()
    psh = jtp.param_shardings(params, mesh)
    prm = jtp.shard_params(params, mesh, shardings=psh)
    m = jstep.make_sharded_eval_step(cfg0, japply, mesh, params_sharding=psh)(prm, p0, *batch)
    out["eval_loss"], out["eval_ids"] = float(m.ctc_loss), np.asarray(m.greedy_ids)
    for name, (ckw, steps, cp) in ranks.CASES.items():
        cfg = jcfg.AttackConfig(lr=LR, **ckw)
        train = jstep.make_sharded_step(cfg, japply, jpsycho.build_tables(cfg), mesh,
                                        params_sharding=psh)
        p = jnp.asarray(arrays["p0"])  # a fresh buffer: the step donates p
        opt = jopt.init_opt_state(cfg, p)
        losses, all_ids = [], []
        for _ in range(steps):
            p, opt, m = train(prm, p, opt, *batch, jcfg.ConstraintParams.create(**cp),
                              jnp.float32(LR))
            losses.append(float(m.ctc_loss))
            all_ids.append(np.asarray(m.greedy_ids))
        out[name] = {"p": np.asarray(p), "losses": np.asarray(losses),
                     "ids": np.stack(all_ids), "opt": opt}
    # the sweep: l2 Adam, two cells, one per sweep slice, the batch over data
    S = len(ranks.SWEEP_SIZES)
    cfg = jcfg.AttackConfig(norm_type="l2", optimizer_type="adam", lr=LR)
    cparams_s = jcfg.with_sweep_value(
        jax.tree.map(lambda x: jnp.broadcast_to(x, (S,)), jcfg.ConstraintParams.create()),
        "l2", np.asarray(ranks.SWEEP_SIZES, np.float32))
    count, mu, nu = arrays["sweep_opt"]
    mesh = jmesh.sweep_mesh(n_sweep=S, n_devices=4)
    opt = jopt.OptState(inner=optax.ScaleByAdamState(
        count=jnp.asarray(count), mu=jnp.asarray(mu), nu=jnp.asarray(nu)))
    step = jstep.make_sweep_step(cfg, japply, jpsycho.build_tables(cfg), mesh)
    p, opt, m = step(params, jnp.asarray(arrays["sweep_p"]), opt, *batch, cparams_s,
                     jnp.asarray(ranks.SWEEP_ACTIVE, jnp.float32), jnp.float32(LR))
    me = jstep.make_sweep_eval_step(cfg, japply, mesh)(params, jnp.asarray(arrays["sweep_p"]),
                                                       *batch)
    out["sweep"] = {"p": np.asarray(p), "mu": np.asarray(opt.inner.mu),
                    "nu": np.asarray(opt.inner.nu), "count": np.asarray(opt.inner.count),
                    "loss": np.asarray(m.ctc_loss), "ids": np.asarray(m.greedy_ids),
                    "eval_loss": np.asarray(me.ctc_loss), "eval_ids": np.asarray(me.greedy_ids)}
    return out


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    """The rank processes' results (2 and 4 ranks, launched together) and
    the JAX reference, computed here while they run."""
    params, japply, arrays = setup
    inp = _torch_inputs(params, arrays)
    dirs, errors, threads = {}, {}, []
    for n in (2, 4):
        dirs[n] = str(tmp_path_factory.mktemp(f"ranks{n}"))
        torch.save(inp, os.path.join(dirs[n], "inputs.pt"))

        def run(n=n):
            try:
                ranks.launch(n, "steps", dirs[n], timeout=150.0)
            except RuntimeError as e:
                errors[n] = e

        threads.append(threading.Thread(target=run))
        threads[-1].start()
    want = _jax_reference(params, japply, arrays)
    for t in threads:
        t.join()
    assert not errors, errors
    got = {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"), weights_only=False)
               for r in range(n)] for n in (2, 4)}
    return got, want


def _layout_ranks(got, layout):
    n = 4 if layout == "dp2tp2" else 2
    return [g[layout] for g in got[n]]


def _close_p(got, want, steps):
    """A PGD or Adam step moves a sample by about ±lr; a gradient sign that
    flips near 0 moves it by up to 2·lr a step (test_torch_step.py)."""
    diff = np.abs(got - want)
    assert np.mean(diff < 1e-2 * LR) >= 0.99
    assert diff.max() <= 2 * steps * LR * 1.01


LAYOUT_NAMES = ["dp2", "tp2", "dp2tp2"]


@pytest.mark.parametrize("layout", LAYOUT_NAMES)
def test_sharded_grad_matches_jax(results, layout):
    """∂loss/∂p at p0 over the layout: the loss and gradient summed over
    ``data``, the ids gathered, the model's heads summed over ``model``."""
    got, want = results
    for r in _layout_ranks(got, layout):
        np.testing.assert_allclose(float(r["grad_loss"]), want["grad_loss"], rtol=1e-4)
        np.testing.assert_array_equal(r["grad_ids"].numpy(), want["grad_ids"])
        g, jg = r["grad"].numpy(), want["grad"]
        assert np.mean(np.sign(g) == np.sign(jg)) >= 0.99
        np.testing.assert_allclose(g, jg, atol=1e-3 * np.abs(jg).max())


@pytest.mark.parametrize("layout", ["tp2", "dp2tp2"])
def test_tp_full_remat_equals_remat_off(results, layout):
    """Under tensor parallelism the full-remat layer's recompute replays
    ``copy_to_model``'s and ``row_parallel``'s collectives in the backward,
    every rank in the same order: loss, ids and ∂loss/∂p equal remat off's
    bit for bit."""
    got, _ = results
    for r in _layout_ranks(got, layout):
        loss, ids, grad = r["remat_full"]
        assert torch.equal(loss, r["grad_loss"]) and torch.equal(ids, r["grad_ids"])
        assert torch.equal(grad, r["grad"])


@pytest.mark.parametrize("layout", ["tp2", "dp2tp2"])
def test_tp_fused_qkv_matches_jax(results, layout):
    """``fused_qkv`` under a 2-way model axis: each rank concatenates its own
    q, k and v slices (``convert.sharded_params_from_jax``) into one product;
    the loss, ids and ∂loss/∂p against JAX's ``fused_qkv=True`` model, at
    ``test_sharded_grad_matches_jax``'s tolerances."""
    got, want = results
    w = want["fused_qkv"]
    for r in _layout_ranks(got, layout):
        loss, ids, g = r["fused_qkv"]
        np.testing.assert_allclose(float(loss), w["grad_loss"], rtol=1e-4)
        np.testing.assert_array_equal(ids.numpy(), w["grad_ids"])
        g, jg = g.numpy(), w["grad"]
        assert np.mean(np.sign(g) == np.sign(jg)) >= 0.99
        np.testing.assert_allclose(g, jg, atol=1e-3 * np.abs(jg).max())


@pytest.mark.parametrize("layout", LAYOUT_NAMES)
def test_sharded_eval_matches_jax(results, layout):
    got, want = results
    for r in _layout_ranks(got, layout):
        np.testing.assert_allclose(float(r["eval_loss"]), want["eval_loss"], rtol=1e-4)
        np.testing.assert_array_equal(r["eval_ids"].numpy(), want["eval_ids"])


STEP_CASES = [(layout, name) for n in (2, 4) for layout, _, cases in ranks.LAYOUTS[n]
              for name in cases]


@pytest.mark.parametrize("layout, name", STEP_CASES, ids=[f"{a}-{b}" for a, b in STEP_CASES])
def test_sharded_step_matches_jax(results, layout, name):
    """The sharded train step against JAX's ``make_sharded_step`` on its
    mesh; every rank ends with the same bits of p (and Adam state)."""
    got, want = results
    w = want[name]
    steps = ranks.CASES[name][1]
    rs = [r[name] for r in _layout_ranks(got, layout)]
    for r in rs:
        np.testing.assert_allclose(r["losses"].numpy(), w["losses"], rtol=1e-4)
        np.testing.assert_array_equal(r["ids"].numpy(), w["ids"])
        _close_p(r["p"].numpy(), w["p"], steps)
        assert torch.equal(r["p"], rs[0]["p"])
        if r["opt"] is not None:
            inner = w["opt"].inner
            assert int(r["opt"][0]) == int(inner.count) == steps
            scale = np.abs(np.asarray(inner.mu)).max()
            np.testing.assert_allclose(r["opt"][1].numpy(), np.asarray(inner.mu),
                                       atol=1e-3 * scale)
            for a, b in zip(r["opt"], rs[0]["opt"]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_sweep_matches_jax(setup, results, n):
    """One cell per sweep slice (data 1 on 2 ranks, data 2 on 4): the vmapped
    sharded sweep step and eval of the JAX package; the frozen cell keeps its
    state bit for bit, and every rank returns every cell with equal bits."""
    got, want = results
    w = want["sweep"]
    rs = [g["sweep"] for g in got[n]]
    assert rs[0]["mesh"] == {"sweep": 2, "data": n // 2}
    for r in rs:
        np.testing.assert_allclose(r["loss"].numpy(), w["loss"], rtol=1e-4)
        np.testing.assert_array_equal(r["ids"].numpy(), w["ids"])
        np.testing.assert_allclose(r["eval_loss"].numpy(), w["eval_loss"], rtol=1e-4)
        np.testing.assert_array_equal(r["eval_ids"].numpy(), w["eval_ids"])
        _close_p(r["p"][0].numpy(), w["p"][0], 1)
        np.testing.assert_array_equal(r["opt"][0].numpy(), w["count"])
        for a, b in zip([r["p"]] + r["opt"], [rs[0]["p"]] + rs[0]["opt"]):
            assert torch.equal(a, b)
    # the frozen cell: its p and Adam state as they came in
    _, _, arrays = setup
    assert torch.equal(rs[0]["p"][1], torch.from_numpy(arrays["sweep_p"][1]))
    for got_leaf, want_leaf in zip(rs[0]["opt"], arrays["sweep_opt"]):
        np.testing.assert_array_equal(got_leaf[1].numpy(), want_leaf[1])


def test_ranks_import_no_jax(results):
    got, _ = results
    for n in (2, 4):
        for r in got[n]:
            assert r["jax_modules"] == []
