"""BENCHMARK.json keeps to the contract the benchmark is checked against,
and every piece it names is a file the harness finds by name."""

import json
import os
import re

import pytest

from perfbench.tests.tiny import BENCH, ROOT

SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")
SPEC = json.load(open(SPEC_PATH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")
CELL_NAMES = {c["name"] for c in SPEC["workloads"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(SPEC_PATH) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert any(w.startswith(SPEC["paths"][0] + "/") for w in SPEC["command"])
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its allowance
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith(SPEC["paths"][0] + "/") and PATH.match(conf["file"])
    data = json.load(open(os.path.join(ROOT, conf["file"])))
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert NAME.match(key) and key in data and not WIDTH.search(key)
    assert any(c["config"] == conf["name"] for c in SPEC["workloads"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4) and cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = json.load(open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")))
    assert os.path.exists(os.path.join(BENCH, "stages", traffic["stage"] + ".py"))
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names) and len(CELL_NAMES) == len(SPEC["workloads"])
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m["workloads"]:
            assert w in CELL_NAMES and w in e2e[m["moves"]].get("workloads", [w])
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
