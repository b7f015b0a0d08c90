"""BENCHMARK.json against the benchmark's contract, and every file a
cell names found by its name."""

from __future__ import annotations

import json
import re

import pytest

from wsnbench import harness
from wsnbench.tests.tiny import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_token|"
                   r"^p$|region_p|halfwidth|^q$)")


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(b["command"]) <= 32 and all(_text(w) for w in
                                                 b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    b = bench()
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        for e in b[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert _text(e[k]), (e["name"], k)
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_cells_report_what_the_contract_asks():
    b = bench()
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) == set(CELLS)
    assert {c["name"] for c in b["configs"]} == {w["config"]
                                                 for w in cells.values()}
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for name, w in cells.items():
        assert w["chips"] in (1, 4) and _text(w["why"])
        mine = lambda ms: [m for m in ms
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in mine(b["end_to_end"])}
        assert "setup_s" in reported and len(reported) >= 2, name
        layer = mine(b["per_layer"])
        assert layer, name
        for m in layer:
            assert m["moves"] in reported, (name, m["name"])
        for m in b["end_to_end"] + b["per_layer"]:
            for c in m.get("workloads", []):
                assert c in cells


@pytest.mark.parametrize("name", CELLS)
def test_a_cells_files_are_found_by_name(name):
    b = bench()
    cell = harness.find_cell(name)
    w = {x["name"]: x for x in b["workloads"]}[name]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    assert conf["file"].startswith(b["paths"][0] + "/")
    assert cell.config["name"] == w["config"]
    assert harness.driver_module(cell).Driver
    for m in cell.metrics(False) + cell.metrics(True):
        assert callable(harness.metric_reader(cell, m["name"]).read)
    assert cell.limits["limits"], "a cell compares at least one number"
    for lim in cell.limits["limits"].values():
        assert {"limit", "why"} <= set(lim)


def test_configs_cut_no_width():
    for c in bench()["configs"]:
        with open(ROOT / c["file"]) as f:
            conf = json.load(f)
        assert len(c["reduced"]) <= 16
        assert conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in conf and not WIDTH.search(k), k
        assert conf["source"] == c["source"]
