"""The tiny cells of the tests: data files under ``tests/data``, run
through the harness exactly as ``BENCHMARK.json``'s cells are."""

import copy
import os
import time

from benchmark import harness

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELLS = {"tiny-resnet.train": ("tiny-resnet", "train_images_per_s"),
         "tiny-gpt2.train": ("tiny-gpt2", "train_tokens_per_s")}


def bench(cells=CELLS) -> dict:
    """``BENCHMARK.json`` with its cells replaced by ``cells``: each
    metric keeps its own, the listed ones for the end-to-end metric
    that it is or that it moves; a cell's end-to-end metric that
    ``BENCHMARK.json`` does not name is added, as a rate."""
    out = copy.deepcopy(harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")))
    out["workloads"] = [{"name": n, "config": c, "traffic": n, "chips": 1,
                         "why": "a test"} for n, (c, _) in cells.items()]
    named = {m["name"] for m in out["end_to_end"]}
    for e2e in sorted({e for _, e in cells.values()} - named):
        out["end_to_end"].append({"name": e2e, "unit": "rows/s",
                                  "better": "higher", "bound": 0.25,
                                  "source": "host_clock", "workloads": []})
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            e2e = m.get("moves", m["name"])
            m["workloads"] = [n for n, (_, e) in cells.items() if e == e2e]
    return out


def run(name: str, trace: bool = False, roots=(DATA, harness.BENCH),
        cells=CELLS, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
        device: str = "cpu") -> dict:
    return harness.run_cell(name, seed, seconds, trace, device,
                            time.perf_counter(), roots=roots,
                            bench=bench(cells))


def prepare(name: str, seed: int = 2 ** 31 + 7, device: str = "cpu"):
    return harness.prepare(name, seed, 1.0, False, device,
                           time.perf_counter(), roots=(DATA, harness.BENCH),
                           bench=bench())

