"""The benchmark of the PyTorch/CUDA port (`supersurfel_fusion_tpu_torch`)
on one NVIDIA H100: `python -m slam_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, driven by `BENCHMARK.json` at the root."""
