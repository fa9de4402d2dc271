"""As-rigid-as-possible deformation graph (map correction on loop closure).

Port of `supersurfel_fusion_tpu/ops/deformation.py` (the ElasticFusion
formulation of the reference's `DeformationGraph`): up to `NODE_CAP` nodes
sampled from the model, 4 temporal neighbours each, Gauss-Newton over 12
variables per node minimizing

    wRot * ||R^T R - I||^2  +  wReg * sum_k ||R_j (g_k - g_j) + g_j + t_j
                                              - (g_k + t_k)||^2
    + wCon * sum_l || blend(source_l) - target_l ||^2

with wRot = 1, wReg = 10, wCon = 100. The normal equations stay dense
(12 * 256 = 3072 variables): the Jacobian comes from `torch.func.jacfwd`
of the residual, and each step is one dense product and one Cholesky
solve, both in f64 (the JAX package's are f32, whose rounding is as
large as the damping). A failed factorisation gives a non-finite step,
which is dropped, as in the JAX package; nothing waits on the host.

Over a capacity-sharded model (`parallel/`), `build_graph_sharded` samples
the nodes on every rank and gathers them, so the graph is the same on all
ranks; `parallel/ba.py` shards the solve's constraints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch.types import Supersurfels
from supersurfel_fusion_tpu_torch.utils.geometry import (
    mat_to_quat,
    mult_ABAt,
    normalize,
    quat_to_mat,
)

Tensor = torch.Tensor

NODE_CAP = 256
N_NEIGH = 4
LOOK_BACK = 15
W_ROT = 1.0
W_REG = 10.0
W_CON = 100.0
STAMP_SENTINEL = 2**30


class DeformationGraph(NamedTuple):
    positions: Tensor      # (NODE_CAP, 3) node anchor g_j
    rotations: Tensor      # (NODE_CAP, 3, 3) R_j
    translations: Tensor   # (NODE_CAP, 3) t_j
    stamps: Tensor         # (NODE_CAP,) int32, sorted ascending
    neighbours: Tensor     # (NODE_CAP, N_NEIGH) int64
    n_nodes: Tensor        # () int32


class VertexBinding(NamedTuple):
    nodes: Tensor     # (V, N_NEIGH) int64
    weights: Tensor   # (V, N_NEIGH) float32 (sum 1)


def _temporal_neighbours(n: Tensor) -> Tensor:
    """Temporal neighbours: the 5-node window around i (shifted inside the
    valid range at the borders) minus i itself."""
    dev = n.device
    n = n.to(torch.int64)
    i = torch.arange(NODE_CAP, device=dev)[:, None]
    lo = torch.minimum(torch.clamp(i - N_NEIGH // 2, min=0),
                       torch.clamp(n - (N_NEIGH + 1), min=0))
    cand = lo + torch.arange(N_NEIGH + 1, device=dev)[None, :]  # (N, 5)
    is_self = (cand == i).to(torch.int8)
    order = torch.argsort(is_self, dim=1, stable=True)
    nb = torch.gather(cand, 1, order[:, :N_NEIGH])
    return torch.minimum(nb, torch.clamp(n - 1, min=0))


def _sample(positions: Tensor, stamps: Tensor, nb_live: Tensor,
            per: int, n: Tensor):
    """`per` nodes strided over the live prefix [0, nb_live); those past
    the first `n` get the sentinel stamp. Returns (positions, stamps)."""
    C = positions.shape[0]
    k = torch.arange(per, device=positions.device)
    idx = torch.clamp((k * torch.clamp(nb_live.to(torch.int64), min=1))
                      // per, 0, C - 1)
    st = torch.where(k < n, stamps[idx].to(torch.int32),
                     torch.full_like(k, STAMP_SENTINEL, dtype=torch.int32))
    return positions[idx], st


def _finish_graph(pos: Tensor, st: Tensor, n: Tensor) -> DeformationGraph:
    dev = pos.device
    order = torch.argsort(st, stable=True)
    return DeformationGraph(
        positions=pos[order],
        rotations=torch.eye(3, dtype=torch.float32,
                            device=dev).repeat(NODE_CAP, 1, 1),
        translations=torch.zeros((NODE_CAP, 3), dtype=torch.float32,
                                 device=dev),
        stamps=st[order],
        neighbours=_temporal_neighbours(n),
        n_nodes=n.to(torch.int32),
    )


def build_graph(positions: Tensor, stamps: Tensor,
                nb_live: Tensor) -> DeformationGraph:
    """Sample up to NODE_CAP nodes uniformly over the live prefix of the
    model, ordered by birth stamp, with temporal neighbours (the JAX
    function's `valid` argument, which it does not read, is left out)."""
    n = torch.clamp(torch.clamp(nb_live.to(torch.int64), min=1),
                    max=NODE_CAP)
    pos, st = _sample(positions, stamps, nb_live, NODE_CAP, n)
    return _finish_graph(pos, st, n)


def build_graph_sharded(positions: Tensor, stamps: Tensor,
                        nb_live_local: Tensor, mesh) -> DeformationGraph:
    """Node sampling over a capacity-sharded model: each rank strides
    NODE_CAP / D candidates over its local live prefix, one gather of the
    (NODE_CAP / D, 3) positions and one of the stamps make the graph the
    same on every rank, and a sum gives the node count. Everything after
    it (bindings, the solve) runs replicated; applying the deformation
    stays local to each rank's block."""
    from supersurfel_fusion_tpu_torch.parallel.mesh import all_gather, psum

    per = NODE_CAP // mesh.axis_size
    n_loc = torch.clamp(nb_live_local.to(torch.int64), max=per)
    pos_l, st_l = _sample(positions, stamps, nb_live_local, per, n_loc)
    pos = all_gather(pos_l, mesh).reshape(NODE_CAP, 3)
    st = all_gather(st_l, mesh).reshape(NODE_CAP)
    n = torch.clamp(psum(n_loc.to(torch.int32).reshape(1), mesh)[0], min=1)
    return _finish_graph(pos, st, n.to(torch.int64))


def _norm3(v: Tensor) -> Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def bind_vertices(graph: DeformationGraph, v_pos: Tensor, v_stamp: Tensor,
                  v_valid: Tensor, look_back: int = LOOK_BACK
                  ) -> VertexBinding:
    """Bind each vertex to its N_NEIGH nearest nodes inside a time-local
    window, with squared-falloff weights (weightVerticesSeq). Where the
    window holds fewer than N_NEIGH + 1 nodes, the missing candidates are
    at infinite distance and get weight 0."""
    dev = v_pos.device
    n = graph.n_nodes.to(torch.int64)
    # stamp-nearest node: left-sided search of the sorted stamp array
    anchor = torch.searchsorted(graph.stamps, v_stamp.to(torch.int32)
                                .contiguous())
    anchor = torch.minimum(anchor, torch.clamp(n - 1, min=0))
    # the window of `look_back` nodes ending at the anchor
    start = torch.minimum(torch.clamp(anchor - (look_back - 1), min=0),
                          torch.clamp(n - look_back, min=0))
    widx = start[:, None] + torch.arange(look_back, device=dev)[None, :]
    widx = torch.clamp(widx, max=NODE_CAP - 1)
    npos = graph.positions[widx]                       # (V, L, 3)
    d = _norm3(npos - v_pos[:, None, :])
    d = torch.where(widx < n, d, torch.full_like(d, float("inf")))

    # the 4 nearest and the 5th for dmax
    neg_top, top_i = torch.topk(-d, N_NEIGH + 1, dim=-1)
    dists = -neg_top                                    # ascending
    dmax = torch.clamp(dists[:, N_NEIGH], min=1e-9)
    w = (1.0 - dists[:, :N_NEIGH] / dmax[:, None]) ** 2
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    w = w / wsum
    nodes = torch.gather(widx, 1, top_i[:, :N_NEIGH])
    valid = v_valid[:, None]
    return VertexBinding(nodes=torch.where(valid, nodes,
                                           torch.zeros_like(nodes)),
                         weights=torch.where(valid, w, torch.zeros_like(w)))


def blend_positions(graph_pos: Tensor, rot: Tensor, trans: Tensor,
                    binding: VertexBinding, v_pos: Tensor) -> Tensor:
    """Deformed position of vertices: sum_k w_k (R_k (v - g_k) + g_k + t_k)."""
    g = graph_pos[binding.nodes]          # (V, 4, 3)
    R = rot[binding.nodes]                # (V, 4, 3, 3)
    t = trans[binding.nodes]
    rel = v_pos[:, None, :] - g
    moved = torch.einsum("vkij,vkj->vki", R, rel) + g + t
    return torch.sum(binding.weights[..., None] * moved, dim=1)


def _residuals(rot: Tensor, trans: Tensor, graph: DeformationGraph,
               con_binding: VertexBinding, con_src: Tensor, con_tgt: Tensor,
               con_valid: Tensor) -> Tensor:
    """Stacked weighted residual vector (fixed shape, masked)."""
    dev = rot.device
    n_mask = (torch.arange(NODE_CAP, device=dev)
              < graph.n_nodes).to(torch.float32)

    # rot: R^T R - I (6 unique entries)
    E = torch.einsum("nij,nik->njk", rot, rot) \
        - torch.eye(3, dtype=torch.float32, device=dev)[None]
    r_rot = torch.stack([E[:, 0, 1], E[:, 0, 2], E[:, 1, 2], E[:, 0, 0],
                         E[:, 1, 1], E[:, 2, 2]], dim=-1) \
        * (W_ROT ** 0.5) * n_mask[:, None]

    # reg: R_j (g_k - g_j) + g_j + t_j - (g_k + t_k)
    gj = graph.positions[:, None, :]
    gk = graph.positions[graph.neighbours]             # (N, 4, 3)
    tj = trans[:, None, :]
    tk = trans[graph.neighbours]
    reg = (torch.einsum("nij,nkj->nki", rot, gk - gj) + gj + tj - (gk + tk)) \
        * (W_REG ** 0.5)
    nb_mask = (graph.neighbours < graph.n_nodes).to(torch.float32) \
        * n_mask[:, None]
    r_reg = reg * nb_mask[..., None]

    # con: blended source - target
    pred = blend_positions(graph.positions, rot, trans, con_binding, con_src)
    r_con = (pred - con_tgt) * (W_CON ** 0.5) \
        * con_valid[:, None].to(torch.float32)
    return torch.cat([r_rot.reshape(-1), r_reg.reshape(-1),
                      r_con.reshape(-1)])


def optimise(graph: DeformationGraph, con_binding: VertexBinding,
             con_src: Tensor, con_tgt: Tensor, con_valid: Tensor,
             n_iters: int = 3, damping: float = 1e-4, mesh=None):
    """Dense Gauss-Newton over (rotations, translations); a step is kept
    only where it does not raise the squared residual.

    `mesh` (`parallel/ba.py`): the con_* arrays are this rank's shard of
    the constraints and the graph is replicated. The node-local residuals
    are scaled by 1/sqrt(D), so the sums over the ranks of JtJ and Jtr
    (in f64) count them once, and every rank takes the same step.

    Returns (rotations, translations, error, mean_cons_err)."""
    from supersurfel_fusion_tpu_torch.parallel.mesh import psum_packed

    def total(*xs):
        return xs if mesh is None else psum_packed(xs, mesh)

    nrot = NODE_CAP * 9
    # the rot and reg residuals: the same on every rank
    n_reg = NODE_CAP * 6 + NODE_CAP * N_NEIGH * 3
    local_scale = 1.0 if mesh is None else mesh.axis_size ** -0.5

    def flat_residual(x: Tensor) -> Tensor:
        r = _residuals(x[:nrot].reshape(NODE_CAP, 3, 3),
                       x[nrot:].reshape(NODE_CAP, 3), graph, con_binding,
                       con_src, con_tgt, con_valid)
        if mesh is None:
            return r
        return torch.cat([r[:n_reg] * local_scale, r[n_reg:]])

    x = torch.cat([graph.rotations.reshape(-1),
                   graph.translations.reshape(-1)])
    eye = torch.eye(x.shape[0], dtype=torch.float64, device=x.device)
    jac = torch.func.jacfwd(flat_residual)
    for _ in range(n_iters):
        r = flat_residual(x)
        # the normal equations in f64: in f32 their rounding is as large as
        # the damping, and the step of the nodes far in time from both
        # constraint sets is rounding noise (PERF.md, section 6)
        J = jac(x).to(torch.float64)
        JtJ, Jtr = total(J.T @ J, J.T @ r.to(torch.float64))
        L, _ = torch.linalg.cholesky_ex(JtJ + damping * eye)
        dx = torch.cholesky_solve(-Jtr[:, None], L)[:, 0].to(torch.float32)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        x2 = x + dx
        c_new, c_old = total(torch.sum(flat_residual(x2) ** 2),
                             torch.sum(r ** 2))
        x = torch.where(c_new <= c_old, x2, x)
    rot = x[:nrot].reshape(NODE_CAP, 3, 3)
    trans = x[nrot:].reshape(NODE_CAP, 3)

    pred = blend_positions(graph.positions, rot, trans, con_binding, con_src)
    cerr = _norm3(pred - con_tgt)
    error, n_con, sum_cerr = total(
        torch.sum(flat_residual(x) ** 2),
        torch.sum(con_valid.to(torch.float32)),
        torch.sum(torch.where(con_valid, cerr, torch.zeros_like(cerr))))
    return rot, trans, error, sum_cerr / torch.clamp(n_con, min=1.0)


def warm_up(device: str | torch.device) -> None:
    """Run the graph solve once on a trivial problem. The first forward-mode
    derivative a process takes on a CUDA device sets itself up for seconds
    (6 s on an H100), which would otherwise stall the first closure frame;
    the frame step's start-up pays it instead."""
    i32 = dict(dtype=torch.int32, device=device)
    z = torch.zeros((1, 3), dtype=torch.float32, device=device)
    graph = build_graph(z, torch.zeros(1, **i32), torch.ones((), **i32))
    src = torch.zeros((100, 3), dtype=torch.float32, device=device)
    ok = torch.zeros(100, dtype=torch.bool, device=device)
    binding = bind_vertices(graph, src, torch.zeros(100, **i32), ok)
    optimise(graph, binding, src, src, ok, n_iters=1)


def apply_to_model(model: Supersurfels, graph_pos: Tensor, rot: Tensor,
                   trans: Tensor, binding: VertexBinding,
                   apply_mask: Tensor) -> Supersurfels:
    """Blend per-surfel 4-node transforms into positions, orientations and
    shapes (the reference's applyDeformation kernel)."""
    new_pos = blend_positions(graph_pos, rot, trans, binding, model.positions)
    q = mat_to_quat(rot)                                # (NODE_CAP, 4)
    bq = normalize(torch.sum(binding.weights[..., None] * q[binding.nodes],
                             dim=1))
    av_rot = quat_to_mat(bq)                            # (V, 3, 3)
    m = apply_mask[:, None]
    return model._replace(
        positions=torch.where(m, new_pos, model.positions),
        orientations=torch.where(m[..., None],
                                 model.orientations @ av_rot.transpose(-1, -2),
                                 model.orientations),
        shapes=torch.where(m[..., None], mult_ABAt(av_rot, model.shapes),
                           model.shapes),
    )
