"""Meshes and worlds (port of `repro.launch.mesh`).

`parse_mesh("DxM")` reads the launchers' --mesh; `make_production_mesh`
gives JAX's production shapes, (data 16, model 16) and (pod 2, data 16,
model 16), as rank layouts the dry run counts over (no process is
started). A live mesh is a `torch.distributed` world:

  * under `torchrun --nproc-per-node N` (RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR in the environment) each process joins as its rank;
  * otherwise `run_world` spawns the ranks itself, each a fresh process
    that meets the others through a `file://` store in a temporary
    directory (a fixed TCP port would collide between test workers).

The backend is 'nccl' when each rank has a card of its own and 'gloo' on
the CPU. Ranks that share one card may name 'gloo' explicitly (gloo
stages a CUDA tensor's collectives through the host); nothing falls back
to it. A rank on the card takes card LOCAL_RANK % device_count.

A rank's exception, or a rank process that dies, is raised again in the
caller of `run_world`, after every rank has stopped.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.api import Mesh

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def parse_mesh(spec: str) -> Optional[Tuple[int, int]]:
    """'' -> None; 'DxM' (e.g. '2x4') -> (data, model)."""
    if not spec:
        return None
    try:
        data, model = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL (e.g. 1x2), got {spec!r}")
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: both degrees must be >= 1")
    return data, model


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shapes as a rank layout: (16, 16) over (data,
    model), or (2, 16, 16) over (pod, data, model)."""
    return Mesh((2, 16, 16) if multi_pod else (16, 16))


def under_torchrun() -> bool:
    return all(v in os.environ for v in _TORCHRUN_VARS)


def pick_backend(device: torch.device, world_size: int,
                 backend: Optional[str] = None) -> str:
    """'gloo' on the CPU; on the card 'nccl', which needs a card a rank
    (else the caller names 'gloo' for ranks that share one)."""
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("nccl runs on the card; the CPU takes gloo")
        return backend
    if device.type != "cuda":
        return "gloo"
    # the ranks on this host: torchrun's per-node count, else the world
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    n = torch.cuda.device_count()
    if local > n:
        raise RuntimeError(
            f"{local} ranks over {n} card(s) on this host: NCCL refuses two "
            "ranks on one card; name backend='gloo' for ranks that share a "
            "card")
    return "nccl"


def rank_device(device) -> torch.device:
    """`device` with its card named: a bare 'cuda' becomes the current
    card, which `torch.cuda.set_device` sets for the calling thread alone
    (a thread started later, such as a prefetcher's, would take card 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def init_world(shape: Sequence[int], device, *, backend: Optional[str] = None,
               rank: Optional[int] = None,
               init_method: Optional[str] = None) -> Mesh:
    """Join (or, for a world of one, make) the process group and return
    this rank's bound `Mesh` of `shape`. Without rank/init_method the
    world comes from torchrun's environment (a single process outside
    torchrun is a world of one). device: the ranks' device type; a card
    rank sets its current card first, and the mesh's `device` names it."""
    import torch.distributed as dist

    size = 1
    for s in shape:
        size *= int(s)
    device = torch.device(device)
    if rank is None:
        if under_torchrun():
            rank = int(os.environ["RANK"])
            if int(os.environ["WORLD_SIZE"]) != size:
                raise ValueError(
                    f"mesh {tuple(shape)} needs {size} ranks; torchrun "
                    f"started {os.environ['WORLD_SIZE']}")
            init_method = "env://"
        else:
            raise RuntimeError(
                f"a mesh outside torchrun: start it with `torchrun "
                "--nproc-per-node N` or through run_world")
    backend = pick_backend(device, size, backend)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size)
        # one all-reduce over the world on the ranks' device: the backend
        # moves data before any model runs (at a world of one, too)
        probe = torch.ones(1, device=rank_device(device))
        dist.all_reduce(probe)
        if probe.item() != size:
            raise RuntimeError(f"{backend}'s all-reduce over {size} ranks "
                               f"gave {probe.item()}")
    mesh = Mesh(shape, rank=rank).bind_groups(backend)
    mesh.device = rank_device(device)
    return mesh


def close_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, shape, device, backend, init_method, tmp):
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if device == "cpu":  # the ranks share the host's cores
        size = 1
        for s in shape:
            size *= s
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    mesh = init_world(shape, device, backend=backend, rank=rank,
                      init_method=init_method)
    try:
        out = fn(mesh, *args)
    finally:
        close_world()
    # pickled by value: a tensor shared with the parent through memory
    # would end with this process
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)


def run_world(shape: Sequence[int], fn: Callable, *args, device="cpu",
              backend: Optional[str] = None, timeout: float = 600.0
              ) -> List:
    """fn(mesh, *args) on every rank of a world of `shape`; returns the
    ranks' results in rank order. Under torchrun this process is one
    rank: fn runs here and the list holds its result alone. Otherwise the
    ranks are spawned (fn and args must pickle: a module-level function)
    and meet through a file store; a rank's exception, a rank that dies,
    or a world still running after `timeout` s raises RuntimeError here
    once every rank has stopped. A rank's result is pickled by value in
    the rank (host data is best: numpy, CPU tensors). A world of one runs
    in this process."""
    device = torch.device(device)
    size = 1
    for s in shape:
        size *= int(s)
    if under_torchrun() or size == 1:  # this process is the (one) rank
        with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
            mesh = init_world(
                shape, device, backend=backend,
                **({} if under_torchrun() else dict(
                    rank=0, init_method="file://" + os.path.join(tmp,
                                                                 "store"))))
            try:
                return [fn(mesh, *args)]
            finally:
                close_world()
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pick_backend(device, size, backend)  # refuse before spawning
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        # fn and args reach the ranks through a file: a large payload
        # through each process's start pipe would start them one by one
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(
            _rank_main, args=(tuple(shape), str(device), backend,
                              "file://" + os.path.join(tmp, "store"), tmp),
            nprocs=size, join=False)
        deadline = time.monotonic() + timeout
        try:  # join kills the other ranks once one fails
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"no result within {timeout} s")
        except ProcessException as e:
            last = str(e).strip().splitlines()[-1]
            raise RuntimeError(f"a rank failed: rank {e.error_index}: "
                               f"{last}\n{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
