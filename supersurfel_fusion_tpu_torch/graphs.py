"""The frame step's stages, run op by op or as CUDA graphs.

`pipeline.py` and `parallel/pipeline_sharded.py` call every stage of
their frame steps through `stage(name, fn, *args)`: one definition of each
stage, `fn`, and one runner that decides how it runs. Outside
`StageGraphs.step()`, so on the CPU and in the sharded step, a stage runs
eagerly inside `tracing.stage(name)`, as the step always has.

`SupersurfelFusion` on a CUDA device runs its steps under a `StageGraphs`
runner. Each stage outside `HOST_STAGES` is then one CUDA graph:

* the first call with a given signature (the stage, its function, the
  structure of its arguments, the shapes, strides and dtypes of its
  tensors, the values of its other arguments) runs eagerly. That call
  fills the cached constant tables, builds the TPS kernels and sets up the
  cuBLAS and cuSOLVER handles;
* the second call captures `fn` on a side stream into a graph, then
  replays it; every later call replays it, inside `tracing.stage(name)`,
  so each `ssf.<name>` range still holds its stage's device work.

A graph reads static input buffers of its own: every call copies its
tensor arguments into them, replays the graph and returns fresh copies of
its outputs, all inside the stage's span. So no tensor a stage has
returned is written by a later replay, and a state or an output `process`
has returned is never written later. All graphs share one memory pool:
they replay one at a time, on one stream, and what one keeps (its inputs
and outputs) is held for the runner's life. `tracing` counts the stages
replayed and run eagerly per frame.

The captured work is fixed: a function a stage calls inside `fn` that is
patched after the capture is not seen (a patched `fn` is: it is part of
the signature). A stage that cannot be captured raises; it is never run
eagerly in its place without a word.

`HOST_STAGES` lists the stages whose Python runs every frame, op by op
or in parts, inside their stage span and range. `mod` makes the host wait
inside: its rigid RANSAC takes two `torch.linalg.svd` calls that read
their convergence flags on the host. It calls its fixed-shape work as
parts, `part(name, fn, *args)`, and the waiting ops eagerly between them
(`tracing.eager_op`). Under the runner a part is warmed, captured and
replayed exactly as a stage is (the same signature, copies in and out,
pool and side stream) inside a recorder span of its own (`tracing.part`)
and no profiler range, so the stage's range holds all of its device work;
outside it a part is `fn(*args)` in that span. `tracing` counts the parts
replayed and run eagerly, and the eager ops. `loop_closure` reads the
fern gate on the host and runs the closure only where it fires; `ferns`
runs op by op.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.utils import _pytree as pytree

from supersurfel_fusion_tpu_torch import tracing

Tensor = torch.Tensor

# `ferns` waits for nothing: graphing it (and the gate's arithmetic before
# the read) is taking its name out of this set
HOST_STAGES = frozenset({"mod", "ferns", "loop_closure"})
# dtypes the multi-tensor copy takes on a card (not uint16, the raw depth)
_MULTI = frozenset({torch.float32, torch.float64, torch.float16,
                    torch.bfloat16, torch.int64, torch.int32, torch.int16,
                    torch.int8, torch.uint8, torch.bool})

_current = None   # the runner of the step being run, if any


def stage(name: str, fn, *args):
    """Stage `name` of the frame step, `fn(*args)`: a CUDA graph under a
    runner (`StageGraphs.step`) unless it is in `HOST_STAGES`, else op by
    op inside `tracing.stage(name)`."""
    if _current is None or name in HOST_STAGES:
        with tracing.stage(name):
            return fn(*args)
    return _current.graphed(name, fn, args, tracing.stage)


def part(name: str, fn, *args):
    """Part `name` of a stage in `HOST_STAGES`, `fn(*args)`: a CUDA graph
    under a runner, else op by op inside `tracing.part(name)`."""
    if _current is None:
        with tracing.part(name):
            return fn(*args)
    return _current.graphed(name, fn, args, tracing.part)


def signature(name: str, fn, args):
    """(signature, leaves, structure) of a stage's call: the signature
    holds the stage, its function, the structure of `args` and, per leaf,
    a tensor's layout or any other value itself (configurations compare
    by value)."""
    leaves, spec = pytree.tree_flatten(args)
    return (name, fn, spec, tuple(
        (x.shape, x.stride(), x.dtype, x.device) if isinstance(x, Tensor)
        else (type(x), x) for x in leaves)), leaves, spec


def _empty(t: Tensor) -> Tensor:
    """An uninitialised tensor with the layout of `t` (an expanded tensor,
    a stride 0, contiguous), so that kernels read it as they read `t`."""
    if any(st == 0 and n > 1 for n, st in zip(t.shape, t.stride())):
        return torch.empty_like(t, memory_format=torch.contiguous_format)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


def copy_all(dst: list, src: list) -> None:
    """dst[i].copy_(src[i]) for every i; contiguous pairs of one dtype in
    `_MULTI` in one multi-tensor copy."""
    groups: dict = {}
    for d, s in zip(dst, src):
        if (d.dtype == s.dtype and d.dtype in _MULTI
                and d.stride() == s.stride()
                and d.is_contiguous() and s.is_contiguous()):
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
        else:
            d.copy_(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class _Graph:
    """One captured stage: the graph, its static inputs, its outputs'
    structure and leaves, and per leaf the index of its tensor in
    `tensors` (None for another value)."""

    __slots__ = ("graph", "static_in", "out_spec", "out", "where", "tensors")

    def outputs(self):
        """The outputs of the last replay, every tensor a fresh copy (one
        per tensor object)."""
        fresh = [_empty(t) for t in self.tensors]
        copy_all(fresh, self.tensors)
        return pytree.tree_unflatten(
            [x if k is None else fresh[k] for x, k in zip(self.out,
                                                          self.where)],
            self.out_spec)


class StageGraphs:
    """The runner of `SupersurfelFusion` on a CUDA device: each stage not
    in `HOST_STAGES`, and each part of one that is, as a CUDA graph,
    captured on its second call."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = None          # the side stream captures run on
        self.pool = None            # the memory pool all graphs share
        self.graphs: dict = {}      # signature -> _Graph
        self.warm: set = set()      # signatures run eagerly once
        self.captured: list = []    # stage names, in capture order
        self.capture_s = 0.0        # host time of the captures

    @contextmanager
    def step(self):
        """One frame step with its stages through this runner."""
        global _current
        old, _current = _current, self
        try:
            yield
        finally:
            _current = old

    def graphed(self, name, fn, args, scope):
        """`fn(*args)` inside `scope(name, replay)`: run eagerly on the
        first call with its signature, captured on the second, replayed
        after."""
        sig, leaves, spec = signature(name, fn, args)
        g = self.graphs.get(sig)
        if g is None and sig not in self.warm:
            self.warm.add(sig)
            with scope(name):
                return fn(*args)
        with scope(name, replay=True):
            if g is None:
                g = self.graphs[sig] = self._capture(name, fn, leaves, spec)
            else:
                copy_all(g.static_in,
                         [x for x in leaves if isinstance(x, Tensor)])
                g.graph.replay()
            return g.outputs()

    def _capture(self, name, fn, leaves, spec) -> _Graph:
        t0 = time.perf_counter()
        tensors = [x for x in leaves if isinstance(x, Tensor)]
        for t in tensors:
            if t.device != self.device:
                raise RuntimeError(f"stage {name!r}: a graph on "
                                   f"{self.device} cannot read a tensor on "
                                   f"{t.device}")
        g = _Graph()
        g.static_in = [_empty(t) for t in tensors]
        copy_all(g.static_in, tensors)
        it = iter(g.static_in)
        sargs = pytree.tree_unflatten(
            [next(it) if isinstance(x, Tensor) else x for x in leaves], spec)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        g.graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            g.graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")
            try:
                out = fn(*sargs)
            except Exception as e:
                try:
                    g.graph.capture_end()
                except RuntimeError:
                    pass
                raise RuntimeError(
                    f"stage {name!r} could not be captured as a CUDA "
                    f"graph: {type(e).__name__}: {e}") from e
            g.graph.capture_end()
        cur.wait_stream(self.stream)
        g.out, g.out_spec = pytree.tree_flatten(out)
        index: dict = {}      # id of an output tensor -> its copy's index
        g.tensors, g.where = [], []
        for x in g.out:
            k = None
            if isinstance(x, Tensor):
                k = index.get(id(x))
                if k is None:
                    k = index[id(x)] = len(g.tensors)
                    g.tensors.append(x)
            g.where.append(k)
        g.graph.replay()
        self.captured.append(name)
        self.capture_s += time.perf_counter() - t0
        return g

    def report(self) -> dict:
        """The stages and parts captured, in order, and the host ms the
        captures took (the first replay of each included)."""
        return {"captured": list(self.captured),
                "capture_ms": 1e3 * self.capture_s}
