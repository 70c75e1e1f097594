"""Every entry of BENCHMARK.json resolves to its files, and the file keeps
the shape the benchmark's format asks for."""

import json
import re

import pytest

from perfbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    cell = spec.load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.traffic["kind"] in ("train_fit", "serve_orbit")
    assert cell.limits["numbers"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e
    assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    assert c["file"].startswith("perfbench/")
    assert cfg["name"] == c["name"]
    for key in ("scene", "render", "pose", "fit", "work", "peaks"):
        assert key in cfg
    for key in c["reduced"]:
        assert key in cfg and key in cfg.get("published", {})
    if cfg.get("weights"):
        assert (spec.ROOT / cfg["weights"]).is_file()
        assert cfg["weights"].startswith("perfbench/")


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"kernels", "torch work around the kernels",
                      "kernel wrappers", "device", "whole step"}
