# Frozen copy of supersurfel_fusion_tpu_torch/ops/__init__.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
