"""``BENCHMARK.json`` and the files it names, found by name and checked.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found from its name:

  * ``perfbench/configs/<config>.json``: the configuration's sizes (the
    manifest entry's ``file``);
  * ``perfbench/mixes/<traffic>.json``: the traffic mix, whose ``driver``
    names the general driver in ``perfbench/drivers/`` that reads it;
  * ``perfbench/limits/<cell>.json``: the limits of the numbers that
    decide the cell's ``correct``;
  * ``perfbench/metrics/<metric>.py``: the reader of one per-layer metric.

A new cell, configuration, mix or metric is new files and a new manifest
entry; no file that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
_SOURCES_E2E = ("host_clock", "device_trace")
_SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
_TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
             "per_layer"}


class ManifestError(ValueError):
    pass


def _need(cond: bool, message: str) -> None:
    if not cond:
        raise ManifestError(message)


def _line(text, what: str) -> None:
    _need(isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text
          and "\t" not in text, f"{what}: 1 to 200 characters on one line, no tab")


def _name(value, what: str) -> None:
    _need(isinstance(value, str) and bool(_NAME.match(value)), f"{what}: bad name {value!r}")


def _json(path: str, what: str) -> Dict:
    _need(os.path.isfile(path), f"{what}: no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        value = json.load(f)
    _need(isinstance(value, dict), f"{what}: {path} holds no JSON object")
    return value


class Manifest:
    """The validated manifest, with the files of its entries loaded."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "perfbench")
        self.data = _json(os.path.join(root, "BENCHMARK.json"), "BENCHMARK.json")
        self._check()

    # ------------------------------------------------------------ lookups

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise ManifestError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return _json(os.path.join(self.root, entry["file"]), f"config {name}")
        raise ManifestError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> Dict:
        return _json(os.path.join(self.bench_dir, "mixes", f"{traffic}.json"),
                     f"traffic {traffic}")

    def limits(self, cell: str) -> Dict:
        return _json(os.path.join(self.bench_dir, "limits", f"{cell}.json"),
                     f"limits of {cell}")

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics a cell reports: those listing it, and
        those without a list whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]

    def reader(self, metric: str):
        """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        _need(os.path.isfile(path), f"metric {metric}: no reader {path}")
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _need(callable(getattr(module, "read", None)), f"metric {metric}: no read()")
        return module.read

    # ------------------------------------------------------------- checks

    def _check(self) -> None:
        d = self.data
        _need(set(d) == _TOP_KEYS, f"BENCHMARK.json keys must be {sorted(_TOP_KEYS)}")
        _need(isinstance(d["command"], list) and 1 <= len(d["command"]) <= 32
              and all(isinstance(w, str) for w in d["command"]), "command: 1-32 strings")
        for w in d["command"]:
            _line(w, "command word")
            _need(not w.startswith("/") and ".." not in w.split("/"), f"command: {w!r}")
        _need(isinstance(d["paths"], list) and 1 <= len(d["paths"]) <= 16, "paths: 1-16")
        _need(isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51,
              "run_seconds: a whole number from 1 to 51")

        configs = {}
        for c in d["configs"]:
            _need(set(c) == {"name", "source", "file", "reduced", "why"},
                  f"config entry keys: {sorted(c)}")
            _name(c["name"], "config")
            _line(c["source"], "config source")
            _line(c["why"], "config why")
            _need(c["file"].startswith("perfbench/"), f"config {c['name']}: file outside paths")
            _need(len(c["reduced"]) <= 16, "reduced: at most 16 keys")
            for key in c["reduced"]:
                _name(key, "reduced key")
            cfg = self.config(c["name"])
            for key in ("class_count", "level_count", "width_scaler", "min_filter_count",
                        "grayscale", "base_width", "compute_dtype"):
                _need(key in cfg, f"config {c['name']}: no {key}")
            configs[c["name"]] = c
        _need(1 <= len(configs) == len(d["configs"]) <= 24, "configs: 1-24, names unique")

        cells = set()
        pairs = set()
        for w in d["workloads"]:
            _need(set(w) == {"name", "config", "traffic", "chips", "why"},
                  f"workload entry keys: {sorted(w)}")
            for key in ("name", "config", "traffic"):
                _name(w[key], f"workload {key}")
            _line(w["why"], "workload why")
            _need(w["config"] in configs, f"workload {w['name']}: unknown config")
            _need(w["chips"] in (1, 4), f"workload {w['name']}: chips 1 or 4")
            _need(w["name"] not in cells, f"workload {w['name']} twice")
            _need((w["config"], w["traffic"]) not in pairs, f"{w['name']}: pair twice")
            cells.add(w["name"])
            pairs.add((w["config"], w["traffic"]))
            mix = self.mix(w["traffic"])
            driver = os.path.join(self.bench_dir, "drivers", f"{mix.get('driver')}.py")
            _need(os.path.isfile(driver), f"traffic {w['traffic']}: no driver {driver}")
            self.limits(w["name"])
        _need(1 <= len(cells) <= 24, "workloads: 1 to 24")
        _need(all(c in {w["config"] for w in d["workloads"]} for c in configs),
              "every config is used by a cell")

        names = set()
        for group, sources in (("end_to_end", _SOURCES_E2E), ("per_layer", _SOURCES)):
            keys = ({"name", "unit", "better", "bound", "source"} if group == "end_to_end"
                    else {"name", "unit", "better", "source", "layer", "moves"})
            for m in d[group]:
                _need(set(m) - {"workloads"} == keys, f"{group} entry keys: {sorted(m)}")
                _name(m["name"], f"{group} name")
                _need(m["name"] not in names, f"metric {m['name']} twice")
                names.add(m["name"])
                _need(bool(_UNIT.match(m["unit"])), f"{m['name']}: bad unit")
                _need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
                _need(m["source"] in sources, f"{m['name']}: source {m['source']}")
                for cell in m.get("workloads", []):
                    _need(cell in cells, f"{m['name']}: unknown cell {cell}")
                if group == "end_to_end":
                    _need(0.01 <= m["bound"] <= 0.25, f"{m['name']}: bound 0.01-0.25")
                else:
                    _line(m["layer"], f"{m['name']} layer")
                    self.reader(m["name"])
        e2e = {m["name"] for m in d["end_to_end"]}
        _need("setup_s" in e2e, "end_to_end: setup_s is required")
        for m in d["per_layer"]:
            _need(m["moves"] in e2e, f"{m['name']}: moves {m['moves']}")
            for cell in m.get("workloads", []):
                _need(m["moves"] in {x["name"] for x in self.end_to_end(cell)},
                      f"{m['name']}: {cell} does not report {m['moves']}")
        for cell in cells:
            reported = {m["name"] for m in self.end_to_end(cell)}
            _need("setup_s" in reported and len(reported) >= 2,
                  f"{cell}: setup_s and one more end-to-end metric")
            _need(bool(self.per_layer(cell)), f"{cell}: no per-layer metric")


def load(root: Optional[str] = None) -> Manifest:
    return Manifest(root or ROOT)
