"""The PyTorch and CUDA port's benchmark: one cell of BENCHMARK.json a run
(`python3 perfbench/run.py --workload <cell> ...`; README.md)."""
