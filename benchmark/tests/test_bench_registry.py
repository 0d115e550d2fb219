"""``BENCHMARK.json`` against the contract: every cell, configuration,
driver and metric resolves to a file of its own by name, and the shapes,
names and limits are as the contract states them."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|^n_embd$|^n_inner$|"
                    r"per_tok|stage_widths|channels")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    script = BENCH["command"][1]
    assert script.startswith("benchmark/") and os.path.exists(
        os.path.join(harness.ROOT, script))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/")
    data = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
    assert data["source"] == cfg["source"]
    for kind in ("reference", "models"):
        harness.find(kind, data["family"], (harness.BENCH,), ".py")
    assert sum(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert len(cfg["why"]) <= 200 and "\n" not in cfg["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    data = harness.load_json(harness.find("workloads", cell,
                                          (harness.BENCH,), ".json"))
    assert data["config"] == entry["config"]
    harness.find("drivers", data["driver"], (harness.BENCH,), ".py")
    assert data["limits"]
    e2e = harness.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert per_layer
    for m in e2e:
        assert hasattr(harness.reader("end_to_end", m["name"],
                                      (harness.BENCH,)), "read")
    for m in per_layer:
        assert m["moves"] in names
        assert hasattr(harness.reader("layer_metrics", m["name"],
                                      (harness.BENCH,)), "read")


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
