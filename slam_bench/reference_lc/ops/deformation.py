# Written for the loop-closure cell's plain reference from the published
# method, not copied from the program: the embedded deformation graph of
# Sumner, Schmid and Pauly (SIGGRAPH 2007) as ElasticFusion uses it for map
# correction (Whelan et al., RSS 2015), with the reference's settings
# (`DeformationGraph`: 256 nodes, 4 temporal neighbours, wRot 1, wReg 10,
# wCon 100, 3 Gauss-Newton iterations). Its Jacobian is written out row by
# row; nothing is differentiated automatically. Departures from the C++
# reference, shared with the port: the normal equations are dense and
# solved by a dense Cholesky factorisation, where the reference keeps them
# sparse and factors them with CHOLMOD; they are formed and solved in
# float64 from float32 residuals and Jacobian rows, since in float32 their
# rounding is as large as the damping (1e-4) and moves the nodes that no
# constraint determines.
"""Deformation graph: node sampling, vertex binding, Gauss-Newton, apply.

The graph's nodes are sampled evenly over the live model and ordered by
birth stamp; node j has the 4 nodes nearest it in that order as
neighbours. A vertex is bound to its 4 nearest nodes among the `look_back`
nodes that end at its stamp, with weights (1 - d / d_max)^2 normalised to
sum 1 (d_max the distance to the 5th nearest). Node j carries an affine
R_j (3x3) and a translation t_j; a vertex v moves to

    sum_k w_k (R_k (v - g_k) + g_k + t_k).

Gauss-Newton minimises, over the 12 unknowns of every node,

    E = wRot sum_j ||R_j^T R_j - I||^2          (6 terms a node)
      + wReg sum_j sum_k ||R_j (g_k - g_j) + g_j + t_j - (g_k + t_k)||^2
      + wCon sum_l ||blend(s_l) - q_l||^2,

each residual scaled by the square root of its weight. The Jacobian rows:

* rot, entry (a, b) of R_j^T R_j - I: d/dR_j[i, a] = R_j[i, b] and
  d/dR_j[i, b] = R_j[i, a] (2 R_j[i, a] on the diagonal);
* reg, component c of edge (j, k): d/dR_j[c, m] = (g_k - g_j)_m,
  d/dt_j[c] = 1, d/dt_k[c] = -1;
* con, component c of constraint l bound to nodes k with weights w_k:
  d/dR_k[c, m] = w_k (s_l - g_k)_m, d/dt_k[c] = w_k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_bench.reference.types import Supersurfels
from slam_bench.reference.utils.geometry import (
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
# the entries of R^T R - I that the rot term holds, in its order
ROT_ENTRIES = ((0, 1), (0, 2), (1, 2), (0, 0), (1, 1), (2, 2))


class DeformationGraph(NamedTuple):
    positions: Tensor      # (NODE_CAP, 3) node anchor g_j
    rotations: Tensor      # (NODE_CAP, 3, 3) R_j
    translations: Tensor   # (NODE_CAP, 3) t_j
    stamps: Tensor         # (NODE_CAP,) int32, ascending
    neighbours: Tensor     # (NODE_CAP, N_NEIGH) int64
    n_nodes: Tensor        # () int32


class VertexBinding(NamedTuple):
    nodes: Tensor     # (V, N_NEIGH) int64
    weights: Tensor   # (V, N_NEIGH) float32, summing to 1


def _length(v: Tensor) -> Tensor:
    """Euclidean length over the last axis of (..., 3)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def build_graph(positions: Tensor, stamps: Tensor,
                nb_live: Tensor) -> DeformationGraph:
    """n = min(max(nb_live, 1), NODE_CAP) nodes: node k at model slot
    k * max(nb_live, 1) // NODE_CAP; the slots past n carry the sentinel
    stamp. Ordered by stamp (stable), each with its temporal neighbours:
    the other 4 nodes of the 5 consecutive ones centred on it, the window
    shifted to stay inside [0, n)."""
    dev = positions.device
    C = positions.shape[0]
    live = torch.clamp(nb_live.to(torch.int64), min=1)
    n = torch.clamp(live, max=NODE_CAP)
    k = torch.arange(NODE_CAP, device=dev)
    slot = torch.clamp(k * live // NODE_CAP, 0, C - 1)
    st = torch.where(k < n, stamps[slot].to(torch.int32),
                     torch.full((NODE_CAP,), STAMP_SENTINEL,
                                dtype=torch.int32, device=dev))
    order = torch.argsort(st, stable=True)

    # temporal neighbours: window [lo, lo + 5) without the node itself
    lo = torch.minimum(torch.clamp(k - N_NEIGH // 2, min=0),
                       torch.clamp(n - (N_NEIGH + 1), min=0))
    window = lo[:, None] + torch.arange(N_NEIGH + 1, device=dev)[None, :]
    past_self = (torch.arange(N_NEIGH, device=dev)[None, :]
                 >= (k - lo)[:, None])
    nb = torch.where(past_self, window[:, 1:], window[:, :N_NEIGH])
    nb = torch.minimum(nb, torch.clamp(n - 1, min=0))
    return DeformationGraph(
        positions=positions[slot][order],
        rotations=torch.eye(3, dtype=torch.float32,
                            device=dev).repeat(NODE_CAP, 1, 1),
        translations=torch.zeros((NODE_CAP, 3), dtype=torch.float32,
                                 device=dev),
        stamps=st[order],
        neighbours=nb,
        n_nodes=n.to(torch.int32),
    )


def bind_vertices(graph: DeformationGraph, v_pos: Tensor, v_stamp: Tensor,
                  v_valid: Tensor, look_back: int = LOOK_BACK
                  ) -> VertexBinding:
    """Each valid vertex's 4 nearest nodes among the `look_back` nodes
    ending at the first node whose stamp is not below the vertex's (the
    window kept inside [0, n)), weighted (1 - d / d_max)^2 and normalised;
    nodes past n are infinitely far and weigh 0. An invalid vertex is
    bound to node 0 with weight 0."""
    dev = v_pos.device
    n = graph.n_nodes.to(torch.int64)
    anchor = torch.searchsorted(graph.stamps,
                                v_stamp.to(torch.int32).contiguous())
    anchor = torch.minimum(anchor, torch.clamp(n - 1, min=0))
    start = torch.minimum(torch.clamp(anchor - (look_back - 1), min=0),
                          torch.clamp(n - look_back, min=0))
    cand = start[:, None] + torch.arange(look_back, device=dev)[None, :]
    cand = torch.clamp(cand, max=NODE_CAP - 1)
    d = _length(graph.positions[cand] - v_pos[:, None, :])
    d = torch.where(cand < n, d, torch.full_like(d, float("inf")))
    near, at = torch.topk(d, N_NEIGH + 1, dim=-1, largest=False)
    d_max = torch.clamp(near[:, N_NEIGH], min=1e-9)
    w = (1.0 - near[:, :N_NEIGH] / d_max[:, None]) ** 2
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    nodes = torch.gather(cand, 1, at[:, :N_NEIGH])
    ok = v_valid[:, None]
    return VertexBinding(
        nodes=torch.where(ok, nodes, torch.zeros_like(nodes)),
        weights=torch.where(ok, w, torch.zeros_like(w)))


def blend_positions(graph_pos: Tensor, rot: Tensor, trans: Tensor,
                    binding: VertexBinding, v_pos: Tensor) -> Tensor:
    """sum_k w_k (R_k (v - g_k) + g_k + t_k) for each vertex."""
    g = graph_pos[binding.nodes]                        # (V, 4, 3)
    rel = v_pos[:, None, :] - g
    moved = torch.einsum("vkij,vkj->vki", rot[binding.nodes], rel) + g \
        + trans[binding.nodes]
    return torch.sum(binding.weights[..., None] * moved, dim=1)


def _masks(graph: DeformationGraph):
    """(node mask (N,), edge mask (N, 4)) as float32: the nodes below n,
    and their edges to nodes below n."""
    dev = graph.positions.device
    node = (torch.arange(NODE_CAP, device=dev)
            < graph.n_nodes).to(torch.float32)
    edge = (graph.neighbours < graph.n_nodes).to(torch.float32) \
        * node[:, None]
    return node, edge


def residuals(rot: Tensor, trans: Tensor, graph: DeformationGraph,
              binding: VertexBinding, con_src: Tensor, con_tgt: Tensor,
              con_valid: Tensor) -> Tensor:
    """The residual vector [rot (N*6) | reg (N*4*3) | con (C*3)], each term
    scaled by the square root of its weight and masked."""
    node, edge = _masks(graph)
    E = torch.einsum("nij,nik->njk", rot, rot) \
        - torch.eye(3, dtype=torch.float32, device=rot.device)[None]
    r_rot = torch.stack([E[:, a, b] for a, b in ROT_ENTRIES], dim=-1) \
        * (W_ROT ** 0.5) * node[:, None]
    gj = graph.positions[:, None, :]
    gk = graph.positions[graph.neighbours]
    r_reg = (torch.einsum("nij,nkj->nki", rot, gk - gj) + gj
             + trans[:, None, :] - (gk + trans[graph.neighbours])) \
        * (W_REG ** 0.5) * edge[..., None]
    pred = blend_positions(graph.positions, rot, trans, binding, con_src)
    r_con = (pred - con_tgt) * (W_CON ** 0.5) \
        * con_valid[:, None].to(torch.float32)
    return torch.cat([r_rot.reshape(-1), r_reg.reshape(-1),
                      r_con.reshape(-1)])


def jacobian(rot: Tensor, graph: DeformationGraph, binding: VertexBinding,
             con_src: Tensor, con_valid: Tensor) -> Tensor:
    """The residual vector's Jacobian, (N*6 + N*12 + C*3, N*12) float32,
    over x = [R_0..R_N-1 row by row (N*9) | t_0..t_N-1 (N*3)], from the
    rows of the module's docstring. The translations enter linearly, so
    it does not depend on them."""
    dev = rot.device
    N, K = NODE_CAP, N_NEIGH
    C = con_src.shape[0]
    node, edge = _masks(graph)
    j = torch.arange(N, device=dev)

    def r_col(nd, a, b):              # column of R_nd[a, b]
        return 9 * nd + 3 * a + b

    def t_col(nd, c):                 # column of t_nd[c]
        return 9 * N + 3 * nd + c

    rows, cols, vals = [], [], []

    def put(r, c, v):
        rows.append(r.reshape(-1))
        cols.append(c.reshape(-1))
        vals.append(v.reshape(-1))

    # rot: d(R^T R)[a, b] / dR[i, a] = R[i, b], / dR[i, b] = R[i, a]
    s_rot = (W_ROT ** 0.5) * node
    for e, (a, b) in enumerate(ROT_ENTRIES):
        row = 6 * j + e
        for i in range(3):
            put(row, r_col(j, i, a), rot[:, i, b] * s_rot)
            put(row, r_col(j, i, b), rot[:, i, a] * s_rot)

    # reg: edge (j, k), component c
    base = 6 * N
    nb = graph.neighbours                               # (N, K)
    diff = graph.positions[nb] - graph.positions[:, None, :]   # g_k - g_j
    jj = j[:, None].expand(N, K)
    s_reg = W_REG ** 0.5
    for c in range(3):
        row = base + (jj * K + torch.arange(K, device=dev)[None, :]) * 3 + c
        for m in range(3):
            put(row, r_col(jj, c, m), diff[..., m] * s_reg * edge)
        put(row, t_col(jj, c), (torch.ones_like(edge) * s_reg) * edge)
        put(row, t_col(nb, c), (-torch.ones_like(edge) * s_reg) * edge)

    # con: constraint l, component c, bound to nodes k with weights w_k
    base = 6 * N + 3 * K * N
    s_con = W_CON ** 0.5
    valid = con_valid[:, None].to(torch.float32)          # (C, 1)
    nodes, w = binding.nodes, binding.weights             # (C, K)
    rel = con_src[:, None, :] - graph.positions[nodes]    # (C, K, 3)
    con = torch.arange(C, device=dev)[:, None].expand(C, K)
    for c in range(3):
        row = base + 3 * con + c
        for m in range(3):
            put(row, r_col(nodes, c, m), (w * rel[..., m]) * s_con * valid)
        put(row, t_col(nodes, c), w * s_con * valid)

    J = torch.zeros((6 * N + 3 * K * N + 3 * C, 12 * N),
                    dtype=torch.float32, device=dev)
    J.index_put_((torch.cat(rows), torch.cat(cols)), torch.cat(vals),
                 accumulate=True)
    return J


def optimise(graph: DeformationGraph, con_binding: VertexBinding,
             con_src: Tensor, con_tgt: Tensor, con_valid: Tensor,
             n_iters: int = 3, damping: float = 1e-4):
    """Damped Gauss-Newton from the identity graph: each step solves
    (J^T J + damping I) dx = -J^T r in float64, and is kept only where it
    does not raise the sum of squared residuals (a step that is not
    finite is none). Returns (rotations, translations, the final sum of
    squared residuals, the mean distance of the valid constraints'
    blended sources from their targets)."""
    rot, trans = graph.rotations, graph.translations
    nrot = NODE_CAP * 9
    eye = torch.eye(NODE_CAP * 12, dtype=torch.float64, device=rot.device)

    def res(R, t):
        return residuals(R, t, graph, con_binding, con_src, con_tgt,
                         con_valid)

    for _ in range(n_iters):
        r = res(rot, trans)
        J = jacobian(rot, graph, con_binding, con_src,
                     con_valid).to(torch.float64)
        L, _ = torch.linalg.cholesky_ex(J.T @ J + damping * eye)
        dx = torch.cholesky_solve(-(J.T @ r.to(torch.float64))[:, None],
                                  L)[:, 0].to(torch.float32)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        rot2 = (rot.reshape(-1) + dx[:nrot]).reshape(NODE_CAP, 3, 3)
        trans2 = (trans.reshape(-1) + dx[nrot:]).reshape(NODE_CAP, 3)
        keep = torch.sum(res(rot2, trans2) ** 2) <= torch.sum(r ** 2)
        rot = torch.where(keep, rot2, rot)
        trans = torch.where(keep, trans2, trans)

    pred = blend_positions(graph.positions, rot, trans, con_binding, con_src)
    gap = _length(pred - con_tgt)
    n_con = torch.sum(con_valid.to(torch.float32))
    mean_gap = torch.sum(torch.where(con_valid, gap, torch.zeros_like(gap))) \
        / torch.clamp(n_con, min=1.0)
    return rot, trans, torch.sum(res(rot, trans) ** 2), mean_gap


def apply_to_model(model: Supersurfels, graph_pos: Tensor, rot: Tensor,
                   trans: Tensor, binding: VertexBinding,
                   apply_mask: Tensor) -> Supersurfels:
    """Where `apply_mask` holds: each surfel's position blended as a
    vertex's, and its orientation and shape turned by the normalised
    weighted mean of its nodes' rotations as quaternions (the reference's
    applyDeformation)."""
    new_pos = blend_positions(graph_pos, rot, trans, binding, model.positions)
    q = mat_to_quat(rot)
    turn = quat_to_mat(normalize(torch.sum(
        binding.weights[..., None] * q[binding.nodes], dim=1)))
    m = apply_mask[:, None]
    return model._replace(
        positions=torch.where(m, new_pos, model.positions),
        orientations=torch.where(m[..., None],
                                 model.orientations @ turn.transpose(-1, -2),
                                 model.orientations),
        shapes=torch.where(m[..., None], mult_ABAt(turn, model.shapes),
                           model.shapes),
    )
