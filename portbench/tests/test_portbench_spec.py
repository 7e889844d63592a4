"""``BENCHMARK.json`` against the rules its readers rely on: names, units and
keys; every file it names is there; every per-layer metric moves an
end-to-end metric that each of its cells reports; the configuration files
are what the program runs."""

from __future__ import annotations

import json
import re

import pytest

from portbench import family, run
from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.fullmatch(w["why"])
        assert NAME.fullmatch(w["traffic"]) and w["config"] in [c["name"] for c in BENCH["configs"]]
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert m["better"] in ("lower", "higher") and UNIT.fullmatch(m["unit"])
            assert m["source"] in SOURCES
            names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.fullmatch(m["layer"])
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_applies(m, w["name"]) for m in BENCH["per_layer"])


def test_moves_name_a_metric_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert _applies(e2e[m["moves"]], cell)


def test_files_found_by_name():
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        assert cell["limits"] and cell["ref_rows"] > 0
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert run.reader_path(m["name"], ROOT).is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_what_the_program_runs(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["source"] == config["source"] and cfg["reduced"] == config["reduced"]
    # its family's two files, found by the family's name
    assert NAME.fullmatch(cfg["family"])
    for part in ("families", "reference"):
        assert (ROOT / "portbench" / part / f"{cfg['family']}.py").is_file()
    # a key changed from the source holds what runs; the source's value is beside it
    for key in cfg["reduced"]:
        assert key in cfg and cfg["source_values"][key] != cfg[key]
    fam = family.program(cfg)
    assert fam.model_config(cfg) == fam.preset_config(cfg["program_preset"])
