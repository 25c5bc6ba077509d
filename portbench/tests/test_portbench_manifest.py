"""The manifest and the files it names: every cell's configuration, traffic,
driver, limits and metric files exist, the names and units keep to the
allowed characters, every per-layer metric's cells report the end-to-end
metric it moves, and a configuration, a cell and a metric added as files
are found."""

from __future__ import annotations

import json
import os
import shutil

from conftest import ROOT
from portbench.lib.manifest import NAME, UNIT, Manifest

KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_every_name_resolves_to_its_files():
    m = Manifest(ROOT)
    assert set(m.data) == KEYS
    for cell in m.cells.values():
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert os.path.exists(os.path.join(ROOT, m.configs[cell["config"]]["file"]))
        assert m.config(cell)["name"] == cell["config"]
        assert callable(m.driver(cell).run)
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", f"{cell['name']}.json"))
        assert any(e["name"] == "setup_s" for e in m.end_to_end_of(cell["name"]))
        assert len(m.end_to_end_of(cell["name"])) >= 2
        assert m.per_layer_of(cell["name"])
    for metric in m.per_layer:
        assert callable(m.reader(metric).read)


def test_names_units_and_lines():
    m = Manifest(ROOT)
    names = [x["name"] for x in (*m.data["configs"], *m.data["workloads"],
                                 *m.data["end_to_end"], *m.data["per_layer"])]
    assert len(names) == len(set(names))
    for name in names + [c["traffic"] for c in m.cells.values()]:
        assert NAME.match(name), name
    for metric in (*m.data["end_to_end"], *m.data["per_layer"]):
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for entry in (*m.data["configs"], *m.data["workloads"]):
        assert 0 < len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for metric in m.data["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25


def test_each_per_layer_metric_moves_what_its_cells_report():
    m = Manifest(ROOT)
    layers = {}
    for metric in m.per_layer.values():
        assert metric["moves"] in m.end_to_end
        for cell in metric["workloads"]:
            assert metric["moves"] in {e["name"] for e in m.end_to_end_of(cell)}, (metric, cell)
        layers.setdefault(metric["layer"], []).append(metric["name"])


def test_a_configuration_a_cell_and_a_metric_are_added_by_files(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "book.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(name="book_l40", max_len=40)
    with open(os.path.join(bench, "configs", "book_l40.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "pretrain_short.json"), "w",
              encoding="utf-8") as f:
        json.dump({"driver": "pretrain", "check_steps": 3, "trace_from": 5, "trace_steps": 5,
                   "max_steps": 2000}, f)
    with open(os.path.join(bench, "metrics", "val_ms.pretrain_short.py"), "w",
              encoding="utf-8") as f:
        f.write("def read(r):\n    return r.get('val_ms')\n")
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        data = json.load(f)
    data["configs"].append({"name": "book_l40", "source": "a test", "reduced": ["max_len"],
                            "file": "portbench/configs/book_l40.json", "why": "a test"})
    data["workloads"].append({"name": "book_l40.pretrain_short", "config": "book_l40",
                              "traffic": "pretrain_short", "chips": 1, "why": "a test"})
    data["end_to_end"].append({"name": "pretrain_short_sent_per_s", "unit": "sentences/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["book_l40.pretrain_short"]})
    data["per_layer"].append({"name": "val_ms.pretrain_short", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "a test",
                              "moves": "pretrain_short_sent_per_s",
                              "workloads": ["book_l40.pretrain_short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(data, f)

    m = Manifest(root)
    cell = m.cell("book_l40.pretrain_short")
    assert m.config(cell)["max_len"] == 40
    assert m.traffic(cell)["trace_steps"] == 5
    assert m.driver(cell).__name__ == "driver_pretrain"
    assert "val_ms.pretrain_short" in {x["name"] for x in m.per_layer_of(cell["name"])}
    assert m.reader("val_ms.pretrain_short").read({"val_ms": 1.5}) == 1.5
    assert "val_ms.pretrain_short" not in {x["name"] for x in m.per_layer_of("book.pretrain")}
    assert {e["name"] for e in m.end_to_end_of(cell["name"])} == {"pretrain_short_sent_per_s",
                                                                   "setup_s"}

