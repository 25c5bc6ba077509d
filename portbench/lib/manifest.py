"""The benchmark's manifest, and the files it finds by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics. Everything specific to one of them sits in
a file of its own under ``portbench/``, found from a name alone:

- ``configs/<config>.json``: a configuration (its ``file`` in the manifest);
- ``traffic/<traffic>.json``: a traffic mix, which names its ``driver``;
- ``drivers/<driver>.py``: the code that sets up and drives that kind of
  traffic through the port;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

So a later change adds a configuration, a cell or a metric by adding
files and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.bench = os.path.join(root, "portbench")
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.end_to_end = {m["name"]: m for m in self.data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.data["per_layer"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return load_json(os.path.join(self.root, self.configs[cell["config"]]["file"]))

    def traffic(self, cell: dict) -> dict:
        return load_json(os.path.join(self.bench, "traffic", f"{cell['traffic']}.json"))

    def driver(self, cell: dict):
        name = self.traffic(cell)["driver"]
        return load_module(os.path.join(self.bench, "drivers", f"{name}.py"), f"driver_{name}")

    def end_to_end_of(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports: those without a
        ``workloads`` key and those that list it."""
        return [m for m in self.end_to_end.values()
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer_of(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a ``workloads`` key whose ``moves`` it reports."""
        moves = {m["name"] for m in self.end_to_end_of(cell)}
        return [m for m in self.per_layer.values()
                if cell in m.get("workloads", ()) or
                ("workloads" not in m and m["moves"] in moves)]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench, "metrics", f"{metric}.py"),
                           "metric_" + re.sub(r"\W", "_", metric))


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
