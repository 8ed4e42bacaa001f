"""What the benchmark imports, and that it is driven by data: a new
configuration, traffic mix and per-layer metric are new files and new
entries, and no file that is there changes."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, add_tiny_cell, copy_bench, run_cell

JAX = ("jax", "jaxlib", "flax", "dusk_plonk_tpu")

IMPORT_ALL = r"""
import glob, importlib, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
from plonkbench import spec
import plonkbench.run, plonkbench.harness, plonkbench.trace
import plonkbench.reference.check
bench = spec.load_benchmark(root)
for c in bench["configs"]:
    cfg = spec.config(root, bench, c["name"])
    spec.circuit(root, cfg)
for w in bench["workloads"]:
    spec.traffic(root, w["traffic"])
for m in bench["per_layer"]:
    spec.metric(root, m["name"])
import torch
import dusk_plonk_torch.prelude, dusk_plonk_torch.ops.msm
import dusk_plonk_torch.ops.ntt, dusk_plonk_torch.ops.kernels
print(json.dumps(sorted(sys.modules)))
"""

IMPORT_REFERENCE = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, sys.argv[1])
for path in sorted(glob.glob(os.path.join(sys.argv[1], "plonkbench",
                                          "reference", "*.py"))):
    name = os.path.basename(path)[:-3]
    if name != "__init__":
        importlib.import_module("plonkbench.reference." + name)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_nothing_the_benchmark_runs_imports_jax():
    tops = _modules(IMPORT_ALL)
    assert "dusk_plonk_torch" in tops and "plonkbench" in tops
    assert tops.isdisjoint(JAX)


def test_the_reference_imports_nothing_of_the_program():
    tops = _modules(IMPORT_REFERENCE)
    assert "plonkbench" in tops
    assert tops.isdisjoint(JAX + ("dusk_plonk_torch",))


def test_metric_files_match_their_entries():
    from plonkbench import spec
    bench = spec.load_benchmark(ROOT)
    for m in bench["per_layer"]:
        mod = spec.metric(ROOT, m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
            (m["layer"], m["unit"], m["moves"]), m["name"]


def test_the_run_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "plonkbench", "run.py"),
         "--workload", "k16_bench_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_run_refuses_a_checkout_without_the_program(tmp_path):
    """Only BENCHMARK.json and plonkbench/: the program is missing."""
    root = copy_bench(str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "plonkbench", "run.py"),
         "--workload", "k16_bench_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


NEW_METRIC = '''"""proofs_in_window: the window's completed proofs."""

LAYER = "prover API (proving/prover.py)"
UNIT = "proofs"
MOVES = "proof_s"


def read(run):
    return float(len(run.proof_seconds))
'''


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in base:
                continue
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_new_files(tmp_path):
    root = copy_bench(str(tmp_path))
    before = _digests(root)
    with open(os.path.join(root, "plonkbench/traffic/stream.json")) as f:
        mix = json.load(f)
    mix.update(name="burst", warmup=1)
    with open(os.path.join(root, "plonkbench/traffic/burst.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "plonkbench/metrics/proofs_in_window.py"),
              "w") as f:
        f.write(NEW_METRIC)
    cell = add_tiny_cell(root, traffic="burst", name="small")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "proofs_in_window", "unit": "proofs", "better": "higher",
        "source": "host_clock", "layer": "prover API (proving/prover.py)",
        "moves": "proof_s", "workloads": [cell]})
    with open(path, "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}
    result, checks = run_cell(root, cell, 7, seconds=1.0, trace=True)
    assert result["correct"] and sum(checks.values()) == 0
    assert result["metrics"]["proofs_in_window"]["value"] >= 1
    assert "synth_ms" in result["metrics"]


def _edit(root, rel, old, new):
    path = os.path.join(root, rel)
    with open(path) as f:
        text = f.read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def test_a_layer_entry_the_proofs_never_call_fails_the_traced_run(tmp_path):
    """As when the commits go through another MSM entry: the old entry
    still exists, but no traced proof calls it."""
    root = copy_bench(str(tmp_path))
    cell = add_tiny_cell(root)
    _edit(root, "plonkbench/metrics/msm_roofline.py",
          '("dusk_plonk_torch.ops.msm", "MsmPlan.msm_affine_batch", "msm",\n'
          '            _work)',
          '("dusk_plonk_torch.proving.keys", "compile_circuit_device", '
          '"msm")')
    with pytest.raises(RuntimeError, match=r"no call.*'msm'"):
        run_cell(root, cell, 11, seconds=0.5, trace=True)


def test_a_metric_that_reads_nothing_fails_the_traced_run(tmp_path):
    """As when the engine's 'synthesize' mark is renamed."""
    root = copy_bench(str(tmp_path))
    cell = add_tiny_cell(root)
    _edit(root, "plonkbench/metrics/synth_ms.py",
          'ROUNDS = ("synthesize", "wire_pack")',
          'ROUNDS = ("synthesise", "wire_pack")')
    with pytest.raises(RuntimeError, match="synth_ms read nothing"):
        run_cell(root, cell, 12, seconds=0.5, trace=True)
