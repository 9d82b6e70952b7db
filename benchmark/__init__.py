"""The benchmark of lab4d_tpu_torch on NVIDIA GPUs: one run of one cell is
`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
(BENCHMARK.json at the root of the checkout lists the cells and metrics)."""
