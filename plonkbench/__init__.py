"""The benchmark of dusk_plonk_torch: `python3 plonkbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` runs one cell of
BENCHMARK.json on the CUDA card and prints one JSON line."""
