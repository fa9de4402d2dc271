"""Distributed deformation-graph solve: the loop-closure constraints
sharded over the ranks.

Port of `supersurfel_fusion_tpu/parallel/ba.py`. The single-rank solve is
`ops/deformation.py:optimise` (dense Gauss-Newton, Cholesky on the
device). Here the constraint set, the part that grows with keyframes and
loops, is block-sharded over the ranks and each rank linearizes its
shard; the node-local rot/reg residuals are computed on every rank and
scaled by 1/sqrt(D), so the sums over the ranks count them once. Each
Gauss-Newton iteration sums JtJ and Jtr ((12 N)^2 + 12 N values, in f64
as the port's single-rank solve forms them) and the two costs of the
step test, and every rank then solves the same system.
"""

from __future__ import annotations

from supersurfel_fusion_tpu_torch.ops.deformation import (
    DeformationGraph,
    VertexBinding,
    optimise,
)
from supersurfel_fusion_tpu_torch.parallel.mesh import Mesh, block


def make_distributed_optimise(mesh: Mesh, n_iters: int = 3,
                              damping: float = 1e-4):
    """The graph solve with this rank's shard of the constraints: run(
    graph, con_binding, con_src, con_tgt, con_valid) with the same returns
    as `optimise` ((rotations, translations, error, mean_cons_err), the
    same on every rank)."""

    def run(graph: DeformationGraph, con_binding: VertexBinding, con_src,
            con_tgt, con_valid):
        return optimise(graph, con_binding, con_src, con_tgt, con_valid,
                        n_iters=n_iters, damping=damping, mesh=mesh)

    return run


def shard_constraints(mesh: Mesh, con_binding: VertexBinding, con_src,
                      con_tgt, con_valid):
    """This rank's block of the constraint arrays, on its device (their
    length must divide by the number of ranks: pad with invalid rows)."""
    rows = block(con_src.shape[0], mesh)

    def put(x):
        return x[rows].to(mesh.device)

    return (VertexBinding(nodes=put(con_binding.nodes),
                          weights=put(con_binding.weights)),
            put(con_src), put(con_tgt), put(con_valid))
