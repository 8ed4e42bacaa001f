"""Fixtures of the benchmark's own tests (run them with
`python3 -m pytest plonkbench/tests -q`; the ones marked `chip` need a CUDA
card and skip without one: on the card,
`python3 -m pytest plonkbench/tests -q -m chip`)."""

import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_K = 6


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def copy_bench(dst):
    """A copy of BENCHMARK.json and plonkbench/ under dst."""
    shutil.copytree(os.path.join(ROOT, "plonkbench"),
                    os.path.join(dst, "plonkbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return dst


def add_tiny_cell(root, k=TINY_K, traffic="stream", name="tiny"):
    """Add a configuration `name` (the bench circuit at 2^k with 8-bit
    checks) and a cell `<name>_<traffic>` that every per-layer metric
    lists; returns the cell's name."""
    with open(os.path.join(root, "plonkbench/configs/bench_k16.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, k=k, trace_proofs=1,
               reference={"proofs": 2, "srs_points": 4})
    cfg["circuit"]["params"].update(k=k, mul_gates_below_n=40,
                                    range_bits=8, logic_bits=8)
    with open(os.path.join(root, f"plonkbench/configs/{name}.json"),
              "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    cell = f"{name}_{traffic}"
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"plonkbench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)
    return cell


def run_cell(root, cell, seed, seconds=1.0, trace=False, device="cpu",
             prove_rng=None):
    """harness.run on a cell of the benchmark under root."""
    import torch
    from plonkbench import harness, spec
    torch.set_num_threads(4)
    bench = spec.load_benchmark(root)
    return harness.run(root, bench, spec.cell(bench, cell), seed, seconds,
                       trace, device, time.perf_counter(),
                       prove_rng=prove_rng)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_bench(str(tmp_path_factory.mktemp("bench")))
    add_tiny_cell(root)
    return root
