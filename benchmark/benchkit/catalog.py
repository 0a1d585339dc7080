"""Cells, configurations and metrics, found by the names in
``BENCHMARK.json``.

A configuration is ``configs/<name>.json`` (the file ``BENCHMARK.json``
names for it), a cell is ``workloads/<cell>.json`` and a metric is
``metrics/<name>.py`` under the benchmark's directory (the one that holds
the command's script), so a later change adds any of them as a new file
without editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Catalog:
    """What ``BENCHMARK.json`` at ``root`` names, read from the files of
    the benchmark's directory."""

    def __init__(self, root: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.bench_dir = os.path.join(
            root, os.path.dirname(self.spec["command"][1]))
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str):
        """(cell entry, its workload file, its configuration file); raises
        KeyError for a name ``BENCHMARK.json`` does not list and ValueError
        where the files disagree with it."""
        entry = self.cells[name]
        job = load_json(os.path.join(self.bench_dir, "workloads",
                                     f"{name}.json"))
        conf_entry = self.configs[entry["config"]]
        config = load_json(os.path.join(self.root, conf_entry["file"]))
        for key in ("config", "traffic"):
            if job[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json: {key} "
                                 f"{job[key]!r} != BENCHMARK.json's "
                                 f"{entry[key]!r}")
        if config["name"] != entry["config"]:
            raise ValueError(f"{conf_entry['file']}: name {config['name']!r}"
                             f" != {entry['config']!r}")
        return entry, job, config

    def metrics_for(self, cell: str, trace: bool):
        """The metric entries a run of ``cell`` reports: with ``trace`` the
        per-layer ones, else the end-to-end ones, each where its
        ``workloads`` list (when it has one) holds the cell."""
        section = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in section
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, entry: dict):
        """The module ``metrics/<name>.py`` of a metric entry; raises
        ValueError where its UNIT, or a per-layer metric's LAYER or MOVES,
        differs from the entry."""
        name = entry["name"]
        path = os.path.join(self.bench_dir, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        declared = {"unit": mod.UNIT}
        if "layer" in entry:
            declared.update(layer=mod.LAYER, moves=mod.MOVES)
        for key, value in declared.items():
            if entry[key] != value:
                raise ValueError(f"metrics/{name}.py: {key} {value!r} != "
                                 f"BENCHMARK.json's {entry[key]!r}")
        return mod
