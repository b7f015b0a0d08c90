"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
NVIDIA H100: ``python -m wsnbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the repository root
names the cells; each configuration, traffic mix, comparison limit and
metric is a file of its own under this folder, found by its name."""
