"""Process-group bring-up for the sharded layer.

Port of `supersurfel_fusion_tpu/parallel/distributed.py` in PyTorch's
idiom. A sharded run is one process per rank; every rank runs the same
frame step on its own block of the map, and `parallel/mesh.py` wraps the
process group as the "map" axis.

* `initialize_from_env(backend)` reads torchrun's contract (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and joins the
  process group:

      torchrun --nproc-per-node 2 my_script.py   # calls initialize_from_env

* `launch(fn, nprocs, ...)` starts the ranks of one host itself (spawned
  processes, a `file://` rendezvous in a temporary directory, so parallel
  test workers never collide on a TCP port) and returns what `fn(mesh,
  *args)` returned on each rank.

NCCL serves ranks on CUDA devices, one device per rank; gloo serves the
CPU, and CUDA tensors too (it stages them through host memory, and the
host waits for each collective). Two ranks on one card therefore run over
gloo: NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from supersurfel_fusion_tpu_torch.parallel.mesh import Mesh, make_mesh


def rank_device(device: str, rank: int) -> torch.device:
    """This rank's device: the CPU, or CUDA device rank mod count (every
    rank on card 0 when the host has one card)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_from_env(backend: str,
                        timeout_s: float = 600.0) -> bool:
    """Join the process group described by torchrun's environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`)
    with `backend` ("nccl" for CUDA devices, "gloo" for the CPU or several
    ranks on one card). Returns True for a group of more than one rank,
    False when the environment names no group. Safe to call twice."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        return False
    rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=int(world),
                            timeout=timedelta(seconds=timeout_s))
    return int(world) > 1


def global_mesh(device: str = "cuda") -> Mesh:
    """The "map" axis over every rank of the initialized process group,
    on this rank's device (`LOCAL_RANK` picks the card)."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return make_mesh(rank_device(device, local))


def _rank_main(fn, rank: int, nprocs: int, backend: str, init: str,
               device: str, threads: int, timeout_s: float, args,
               results) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=nprocs,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, nprocs: int, backend: str, device: str = "cuda",
           args: tuple = (), threads: int = 1,
           timeout_s: float = 600.0) -> list:
    """Run `fn(mesh, *args)` on `nprocs` spawned ranks of one host over
    `backend` ("nccl": one CUDA device per rank; "gloo": the CPU, or any
    number of ranks on the cards) and return the ranks' results in rank
    order. The ranks run on the CUDA cards unless `device` is "cpu".
    `fn` and its arguments and results must pickle (a module-level
    function of a module that imports no JAX). Each rank sets `threads`
    intra-op threads (0 leaves the default). Any rank's failure, or no
    result within `timeout_s`, raises RuntimeError after every rank has
    been stopped: nothing falls back to fewer ranks or to the CPU."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, backend, init, device,
                                   threads, timeout_s, args, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.time() + timeout_s
        try:
            while len(got) + len(errors) < nprocs:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        # a rank died without reporting (killed, or lost
                        # in native code)
                        time.sleep(1.0)
                        if results.empty():
                            errors.append(
                                f"rank exit codes "
                                f"{[p.exitcode for p in procs]}")
                            break
                    if time.time() > deadline:
                        errors.append(f"no result within {timeout_s:.0f} s")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            # the others may wait in a collective for the rank that failed
            for p in procs:
                p.join(timeout=5.0 if not errors else 1.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
            results.close()
    if errors:
        raise RuntimeError(f"{nprocs}-rank {backend} launch failed: "
                           + "\n".join(errors))
    return [got[r] for r in range(nprocs)]
