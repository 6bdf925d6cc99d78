"""BENCHMARK.json against the benchmark's contract: every cell found by
name in its files, names and units in their characters, the keys each
entry may have."""

import json
import re

import pytest

from gpubench import run
from gpubench.inputs import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG = {"name", "source", "file", "reduced", "why"}
CELL = {"name", "config", "traffic", "chips", "why"}
E2E = {"name", "unit", "better", "bound", "source"}
LAYER = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(line_ok(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == CONFIG and line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for w in bench["workloads"]:
        assert set(w) == CELL and w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E and m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER and m["source"] in SOURCES
        assert line_ok(m["layer"]) and m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in (bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_resolves_to_its_files(bench, cell):
    w = run.find_cell(bench, cell)
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
    assert cfg_file == f"gpubench/configs/{w['config']}.json"
    cfg = json.loads((ROOT / cfg_file).read_text())
    assert cfg["reduced"] == next(c["reduced"] for c in bench["configs"]
                                  if c["name"] == w["config"])
    mix = json.loads((ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "gpubench" / "entries" / f"{mix['entry']}.py").is_file()
    assert "limit" in json.loads((ROOT / "gpubench" / "cells" / f"{cell}.json")
                                 .read_text())["px_off_pct"]
    for trace in (False, True):
        for name, _ in run.metrics_of(bench, cell, trace):
            assert (ROOT / "gpubench" / "metrics" / f"{name}.py").is_file()
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [n for n, _ in run.metrics_of(bench, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2 and run.metrics_of(bench, cell, True)


def test_per_layer_cells_report_what_they_move(bench):
    for m in bench["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert m["moves"] in [n for n, _ in run.metrics_of(bench, cell, False)]


def test_harness_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    rc = run.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
