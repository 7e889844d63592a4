"""A tiny cell for the CPU tests: the configurations' layouts at small
widths (2 layers of 64, 4 heads of 16, FE convs of 32 channels, a
positional conv of 16 taps in 4 groups), 1 s clips in batches of 4, and
limits read from the program and the control at this size on the CPU
(``test_portbench_check.py`` prints both)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=[32] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# at this size, over four seeds, the program reads p0_rel 0, loss_rel ≤ 5.3e-4,
# logit_gap ≤ 0.055, sign_miss ≤ 2.8e-4 and step_rel ≤ 0.22; the control at
# least 1.3e-3, 0.36, 1.1e-2 and 0.52
LIMITS = {"attack": {"p0_rel": 1e-4, "loss_rel": 2e-3, "logit_gap": 0.15, "sign_miss": 3e-3,
                     "step_rel": 0.45},
          "eval": {"loss_rel": 2e-3, "logit_gap": 0.15}}


def config(name: str, **overrides) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.update(TINY, **overrides)
    return cfg


def traffic(mode: str, accum_steps: int = 1) -> dict:
    t = {"mode": mode, "batch_size": 4, "samples": 16000, "sample_rate": 16000, "clips": 8,
         "words": [2, 3], "audio_std": 0.1, "norm": "fletcher_munson", "optimizer": "pgd",
         "lr": 1e-4, "fm_epsilon": 2.0, "stft": {"n_fft": 1024, "hop": 256, "win": 1024}}
    if mode == "attack":
        t["accum_steps"] = accum_steps
    return t


def cell(config_name: str, mode: str, accum_steps: int = 1) -> dict:
    """A cell as ``run.load_cell`` returns it, with the end-to-end metrics
    of ``BENCHMARK.json`` that the mode's cells report."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    moves = f"{mode}_audio_s_per_s"
    return {"entry": {"name": f"tiny.{mode}", "chips": 1}, "config": config(config_name),
            "traffic": traffic(mode, accum_steps),
            "cell": {"ref_rows": 2, "checked_batches": 2, "limits": LIMITS[mode]},
            "end_to_end": [m for m in bench["end_to_end"]
                           if "workloads" not in m or m["name"] == moves],
            "per_layer": [m for m in bench["per_layer"] if m["moves"] == moves]}
