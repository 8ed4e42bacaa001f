"""Finds what a run needs by the names in BENCHMARK.json: the cell, its
configuration file, its traffic mix (traffic/<name>.json), the circuit
module its configuration names (circuits/<module>.py) and each per-layer
metric's reader (metrics/<name>.py).  A later cell, mix, circuit or metric
is new files and new entries; nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = "plonkbench"


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(entries, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named "
                       f"{name!r}")
    return found[0]


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workloads")


def config(root: str, bench: dict, name: str) -> dict:
    entry = _entry(bench["configs"], name, "configs")
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, "
                         f"not {name!r}")
    return cfg


def traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, BENCH, "traffic", name + ".json")) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names {mix.get('name')!r}")
    return mix


def _module(root: str, kind: str, name: str):
    path = os.path.join(root, BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}_{kind}_{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def circuit(root: str, cfg: dict):
    return _module(root, "circuits", cfg["circuit"]["module"])


def metric(root: str, name: str):
    return _module(root, "metrics", name)


def applies(entry: dict, cell_name: str) -> bool:
    """Whether a metric entry is reported in the cell."""
    return "workloads" not in entry or cell_name in entry["workloads"]
