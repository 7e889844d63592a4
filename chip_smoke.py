"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and the tolerance it
held; any failed check raises, so the script exits non-zero before its last
line:

  1. build   — builds the CUDA kernels from ``paa_tpu_torch/csrc`` (nvcc,
               sm_90a) and prints the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the test shapes and at the main path's shapes, with times.
  3. tiny    — the committed tiny checkpoint: one fletcher_munson PGD train
               step and one eval step on the card (through the kernels),
               held against the same steps on the CPU (plain versions, f32).
  4. main    — wav2vec2-base at full width (12 layers, hidden 768, 12 heads),
               random weights from a seed, bf16: B=64 × 10 s of 16 kHz
               audio, 1 warm-up and 3 timed PGD train steps plus one eval
               step; the launch counters show the kernels ran in every layer.

Then ``{"kernels": [...]}``, and last ``{"ok": true, "device": {...}}``.
It exits non-zero when no CUDA device is present; it never runs on the CPU
instead.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from paa_tpu.data import synthetic
from paa_tpu.models import checkpoint_io
from paa_tpu.ops import text
from paa_tpu_torch import runtime
from paa_tpu_torch.attack import optimizers, step
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.models import wav2vec2
from paa_tpu_torch.ops import dsp, psycho
from paa_tpu_torch.ops.kernels import _lib, attention, fm_norm

SEED = 0
MAIN_B, MAIN_T = 64, 160_000  # bench.py's shape: batch 64 × 10 s at 16 kHz
TINY_CKPT = "checkpoints/wav2vec2-tiny-synthetic.safetensors"

# Tolerances, as max |kernel − plain| / max(max |plain|, 0.1) unless said
# otherwise.
# bf16: outputs and gradients are stored in bf16 (relative step 2^-8) and
# the kernels round p and ds where the plain version rounds p only.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_ABS_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
FM_TOL = 1e-5  # float32 sum of positive terms in another order


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), the scale floored at
    0.1, the order of the test outputs: some references are exactly 0 (at
    T=1, dq = dk = 0) and meet float32 rounding noise."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.float().abs().max()), 0.1)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def qkv(B, T, H, d, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((B, T, H * d), generator=g, device=dev) * 0.5).to(dtype)
            for _ in range(4)]


def check_attention(B, T, H, d, dtype, dev, iters=20) -> dict:
    q, k, v, do = qkv(B, T, H, d, dtype, dev, seed=T * 7 + d)
    o, lse = attention.attention_fwd(q, k, v, H)
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, H)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    (attention.attention_fwd_plain(*leaves, H)[0].float() * do.float()).sum().backward()
    grads = attention.attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    errs = {"o": rel_err(o, o_ref), "lse_abs": rel_err(lse, lse_ref)[0]}
    for name, got, leaf in zip(("dq", "dk", "dv"), grads, leaves):
        errs[name] = rel_err(got, leaf.grad)
    tol = ATTN_TOL[dtype]
    out = {"phase": "kernels", "kernel": "attention", "B": B, "T": T, "H": H, "d": d,
           "dtype": str(dtype).split(".")[1], "tol_rel": tol, "tol_lse_abs": LSE_ABS_TOL[dtype],
           "lse_max_abs_err": errs["lse_abs"]}
    for name in ("o", "dq", "dk", "dv"):
        out[f"{name}_max_abs_err"], out[f"{name}_rel_err"] = errs[name]
    fail = [n for n in ("o", "dq", "dk", "dv") if not errs[n][1] <= tol]
    if not errs["lse_abs"] <= LSE_ABS_TOL[dtype]:
        fail.append("lse")
    out["fwd_ms"] = time_ms(lambda: attention.attention_fwd(q, k, v, H), iters)
    out["fwd_plain_ms"] = time_ms(lambda: attention.attention_fwd_plain(q, k, v, H), iters)
    out["bwd_ms"] = time_ms(lambda: attention.attention_bwd(q, k, v, o, lse, do, H), iters)
    out["bwd_plain_ms"] = time_ms(
        lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, H), iters)
    # a library kernel for scale only: SDPA is no port of K1/K2
    to_bhtd = lambda t: t.view(B, T, H, d).transpose(1, 2).detach().requires_grad_(True)
    qs, ks, vs = to_bhtd(q), to_bhtd(k), to_bhtd(v)
    dos = do.view(B, T, H, d).transpose(1, 2)

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, scale=1.0).backward(dos)

    out["sdpa_fwd_bwd_ms"] = time_ms(sdpa, iters)
    out["failed"] = fail
    emit(out)
    return out


def fm_edge_stft(dev) -> torch.Tensor:
    """(1, 513, 130) STFT with cells at power 0, at SPL exactly 0 (power 1)
    and at SPL exactly 90 (power 1e9 = 1200² + 31600², exact in float32)."""
    x = torch.zeros((1, 513, 130, 2), dtype=torch.float32)
    x[0, 10:200, 5:60, 0] = 1.0
    x[0, 200:400, 60:120, 0] = 1200.0
    x[0, 200:400, 60:120, 1] = 31600.0
    x[0, 0, :, 0] = 1.0  # bin 0 Hz lies outside [20, 20000]: weight 1
    return torch.view_as_complex(x.to(dev))


def check_fm(stft_p: torch.Tensor, tables, label: str, iters=100) -> dict:
    got = fm_norm.fm_weighted_power_sum(stft_p, tables)
    want = fm_norm.fm_weighted_power_sum_plain(stft_p, tables)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    out = {"phase": "kernels", "kernel": "fm_norm", "case": label,
           "shape": list(stft_p.shape), "value": float(got), "plain_value": float(want),
           "max_abs_err": abs_err, "rel_err": rel, "tol_rel": FM_TOL,
           "ms": time_ms(lambda: fm_norm.fm_weighted_power_sum(stft_p, tables), iters),
           "plain_ms": time_ms(lambda: fm_norm.fm_weighted_power_sum_plain(stft_p, tables),
                               iters)}
    out["failed"] = [] if rel <= FM_TOL else ["sum"]
    emit(out)
    return out


def phase_kernels(dev) -> dict:
    """Every check runs; the phase fails after them if any was out of
    tolerance. Returns the checks at the main path's shapes."""
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for T in (1, 130, 499, 640):
            results.append(check_attention(2, T, 12, 64, dtype, dev))
        for T in (130, 499):
            results.append(check_attention(2, T, 4, 16, dtype, dev))
    at_main = {"attention": check_attention(MAIN_B, 499, 12, 64, torch.bfloat16, dev)}

    cfg = AttackConfig(norm_type="fletcher_munson")
    tables = psycho.build_tables(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    p_main = torch.randn((1, MAIN_T), generator=g, device=dev) * 0.01
    spec_main = dsp.stft(p_main, cfg.n_fft, cfg.hop_length, cfg.win_length)  # (1, 513, 626)
    at_main["fm_norm"] = check_fm(spec_main, tables, "main_path")
    spec_b2 = torch.complex(torch.randn((2, 513, 130), generator=g, device=dev) * 10,
                            torch.randn((2, 513, 130), generator=g, device=dev) * 10)
    results.append(check_fm(spec_b2, tables, "B2_T130"))
    results.append(check_fm(fm_edge_stft(dev), tables, "edges_power0_spl0_spl90"))
    bad = [r for r in results + list(at_main.values()) if r["failed"]]
    check(not bad, f"kernels out of tolerance: {bad}")
    return at_main


# ---------------------------------------------------------------------------
# phase 3: the tiny checkpoint, card against CPU
# ---------------------------------------------------------------------------


def tiny_inputs(B=4, T=32_000):
    audio = np.zeros((B, T), np.float32)
    texts = []
    for i, (wav, _sr, txt) in enumerate(synthetic.generate_corpus(B, seed=SEED)):
        n = min(T, len(wav))
        audio[i, :n] = wav[:n]
        texts.append(txt)
    labels, pads = text.encode_batch(texts)
    p0 = np.random.default_rng(SEED).standard_normal((1, T)).astype(np.float32) * 1e-3
    return audio, labels, pads, p0


def run_tiny(dev, sd, arrays):
    audio, labels, pads, p0 = (torch.from_numpy(a).to(dev) for a in arrays)
    model = wav2vec2.Wav2Vec2ForCTC(wav2vec2.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(dev)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd")
    tables = psycho.build_tables(cfg, dev)
    weights = torch.ones(audio.shape[0], device=dev)
    train = step.make_train_step(cfg, model, tables)
    evaluate = step.make_eval_step(cfg, model)
    loss, _, grad = step._grad_and_metrics(model, cfg, p0, audio, labels, pads, weights)
    new_p, _, m = train(p0, None, audio, labels, pads, weights,
                        ConstraintParams.create(device=dev), cfg.lr)
    e = evaluate(new_p, audio, labels, pads, weights)
    return {"loss": float(m.ctc_loss), "grad": grad.cpu(), "new_p": new_p.cpu(),
            "eval_loss": float(e.ctc_loss), "ids": m.greedy_ids.cpu(), "lr": cfg.lr}


def phase_tiny(dev) -> None:
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    arrays = tiny_inputs()
    _lib.reset_launches()
    gpu = run_tiny(dev, sd, arrays)
    launched = dict(_lib.launches)
    cpu = run_tiny(torch.device("cpu"), sd, arrays)
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    eval_rel = abs(gpu["eval_loss"] - cpu["eval_loss"]) / abs(cpu["eval_loss"])
    sign_agree = float((torch.sign(gpu["grad"]) == torch.sign(cpu["grad"])).float().mean())
    p_diff = float((gpu["new_p"] - cpu["new_p"]).abs().max())
    ids_agree = float((gpu["ids"] == cpu["ids"]).float().mean())
    tol = {"loss_rel": 1e-4, "sign_agreement_min": 0.99, "new_p_max_abs": 2 * gpu["lr"],
           "eval_loss_rel": 1e-4}
    emit({"phase": "tiny", "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
          "loss_rel_err": loss_rel, "eval_loss_cuda": gpu["eval_loss"],
          "eval_loss_cpu": cpu["eval_loss"], "eval_loss_rel_err": eval_rel,
          "grad_sign_agreement": sign_agree, "new_p_max_abs_diff": p_diff,
          "greedy_id_agreement": ids_agree, "launches_cuda": launched, "tolerance": tol})
    check(loss_rel <= tol["loss_rel"], f"tiny: train loss rel err {loss_rel}")
    check(eval_rel <= tol["eval_loss_rel"], f"tiny: eval loss rel err {eval_rel}")
    check(sign_agree >= tol["sign_agreement_min"], f"tiny: sign agreement {sign_agree}")
    check(p_diff <= tol["new_p_max_abs"], f"tiny: new p differs by {p_diff}")
    # the gradient, the train step and the eval step each run the layers
    # forward; the first two also backward; the train step projects once
    L = wav2vec2.get_config("wav2vec2-tiny").num_hidden_layers
    check(launched == {"attention_fwd": 3 * L, "attention_bwd": 2 * L, "fm_norm": 1},
          f"tiny: kernel launches on the card {launched}")


# ---------------------------------------------------------------------------
# phase 4: wav2vec2-base at full width
# ---------------------------------------------------------------------------


def phase_main(dev, card: str) -> dict:
    mcfg = wav2vec2.get_config("wav2vec2-base")
    L = mcfg.num_hidden_layers
    t0 = time.perf_counter()
    model = wav2vec2.init_model(mcfg, seed=SEED).cast_param_storage(torch.bfloat16).to(dev)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=1e-4)
    tables = psycho.build_tables(cfg, dev)
    cparams = ConstraintParams.create(device=dev)
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(rng.standard_normal((MAIN_B, MAIN_T)).astype(np.float32) * 0.1).to(dev)
    labels, pads = (torch.from_numpy(a).to(dev) for a in
                    text.encode_batch(["the quick brown fox jumps over the lazy dog"] * MAIN_B))
    weights = torch.ones(MAIN_B, device=dev)
    p = torch.zeros((1, MAIN_T), device=dev)
    opt = optimizers.init_opt_state(cfg, p)
    train = step.make_train_step(cfg, model, tables)
    evaluate = step.make_eval_step(cfg, model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launches()
    losses = []
    p, opt, m = train(p, opt, audio, labels, pads, weights, cparams, cfg.lr)  # warm-up
    losses.append(float(m.ctc_loss))
    check(_lib.launches == {"attention_fwd": L, "attention_bwd": L, "fm_norm": 1},
          f"main: warm-up step launched {_lib.launches}, want {L}/{L}/1")
    timed_steps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        p, opt, m = train(p, opt, audio, labels, pads, weights, cparams, cfg.lr)
    loss_last = m.ctc_loss
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed_steps
    losses.append(float(loss_last))
    n = timed_steps + 1
    train_launches = dict(_lib.launches)
    check(train_launches == {"attention_fwd": L * n, "attention_bwd": L * n, "fm_norm": n},
          f"main: {n} train steps launched {train_launches}")
    e = evaluate(p, audio, labels, pads, weights)
    eval_loss = float(e.ctc_loss)
    launches = dict(_lib.launches)
    check(launches == {"attention_fwd": L * (n + 1), "attention_bwd": L * n, "fm_norm": n},
          f"main: eval step launched {launches}")
    peak = torch.cuda.max_memory_allocated(dev)
    p_abs = float(p.abs().max())
    finite = all(np.isfinite(losses + [eval_loss])) and bool(torch.isfinite(p).all())
    emit({"phase": "main", "model": "wav2vec2-base", "layers": L, "hidden": mcfg.hidden_size,
          "heads": mcfg.num_attention_heads, "batch": MAIN_B, "samples": MAIN_T,
          "compute_dtype": mcfg.compute_dtype, "param_storage": "bfloat16",
          "norm": cfg.norm_type, "optimizer": cfg.optimizer_type, "setup_s": setup_s,
          "step_s": step_s, "steps_per_s": 1.0 / step_s, "timed_steps": timed_steps,
          "losses": losses, "eval_loss": eval_loss, "p_max_abs": p_abs,
          "peak_mem_bytes": peak, "peak_mem_gib": peak / 2**30, "card": card,
          "launches": launches, "launches_per_train_step": {
              k: train_launches[k] / n for k in train_launches}})
    check(finite, "main: non-finite loss or perturbation")
    check(p_abs > 0.0, "main: the perturbation did not change")
    return launches


KERNELS = (
    ("attention_fwd", "paa_tpu_torch/csrc/attention_fwd.cu",
     "paa_tpu/ops/pallas/attention.py:107 (_fwd_kernel, via _attend_fwd :196)"),
    ("attention_bwd", "paa_tpu_torch/csrc/attention_bwd.cu",
     "paa_tpu/ops/pallas/attention.py:133 (_bwd_kernel, via _attend_bwd :218)"),
    ("fm_norm", "paa_tpu_torch/csrc/fm_norm.cu",
     "paa_tpu/ops/pallas/fm_norm.py:40 (_kernel, via fm_weighted_power_sum :61)"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    dev = runtime.require_cuda()

    t0 = time.perf_counter()
    _lib.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda, "card": smi})
    print(smi, flush=True)

    at_main = phase_kernels(dev)
    phase_tiny(dev)
    launches = phase_main(dev, smi)

    att = at_main["attention"]
    fm = at_main["fm_norm"]
    numbers = {
        "attention_fwd": (att["o_max_abs_err"], att["fwd_ms"], att["fwd_plain_ms"]),
        "attention_bwd": (max(att["dq_max_abs_err"], att["dk_max_abs_err"],
                              att["dv_max_abs_err"]), att["bwd_ms"], att["bwd_plain_ms"]),
        "fm_norm": (fm["max_abs_err"], fm["ms"], fm["plain_ms"]),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": numbers[name][0],
         "ms": numbers[name][1], "plain_ms": numbers[name][2]}
        for name, src, rep in KERNELS]})
    check(not any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules),
          "JAX was imported")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
