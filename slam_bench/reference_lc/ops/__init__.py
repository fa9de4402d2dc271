"""The loop-closure cell's own modules: ferns and loop closure (copies of
the program's at commit 193edc4) and the deformation graph (written from
the published method). The rest of the step is `slam_bench.reference`'s."""
