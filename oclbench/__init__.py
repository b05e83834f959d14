"""The benchmark of ocl_tpu_torch (the PyTorch and CUDA port) on one H100:
`python3 oclbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. BENCHMARK.json at the checkout's root names the cells."""
