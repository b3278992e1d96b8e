"""The mesh and its processes (counterpart of ``jax.sharding.Mesh`` and
``repro.compat.make_mesh``).

A :class:`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh``: named
axes and their sizes (``.shape``, ordered as given), this rank's coordinate
on each axis and the process group of each axis.  One rank is one device:
gloo on the CPU, NCCL on the GPUs (one rank a card).  A mesh is built only
when a process group is up; nothing here keeps state between calls.

:func:`join` sets up this process's group, :func:`run_ranks` starts a
world of ranks on one host (each rank its own spawned process) and waits
for them with a deadline: a rank that fails or a run that outlasts it ends
every rank.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["Mesh", "make_mesh", "mesh_over", "join", "leave", "run_ranks",
           "mesh_device", "in_torchrun"]


class Mesh:
    """Named axes over ranks.  ``shape`` maps each axis to its size (as
    ``jax.sharding.Mesh.shape`` does); ``coords`` this rank's coordinate on
    each axis, or None for a rank outside the mesh."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = OrderedDict(zip(self.axis_names,
                                     (int(s) for s in device_mesh.mesh.shape)))
        coord = device_mesh.get_coordinate()
        self.coords = (None if coord is None
                       else dict(zip(self.axis_names, (int(c) for c in coord))))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def device(self) -> torch.device:
        return mesh_device()

    def coord(self, axis: str) -> int:
        return self.coords[axis] if axis in self.shape else 0

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if _device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_over(ranks, dims, axes) -> Mesh:
    """A mesh of ``dims`` over the given global ranks (row-major).  Every
    rank of the world calls it (each axis group is made by all of them);
    a rank outside ``ranks`` gets a mesh with no coordinates."""
    ranks = np.asarray(ranks, dtype=np.int64).reshape(dims)
    return Mesh(DeviceMesh(_device_type(), torch.from_numpy(ranks),
                           mesh_dim_names=tuple(axes)))


def make_mesh(dims, axes) -> Mesh:
    """A mesh of ``dims`` named ``axes`` over the first ``prod(dims)``
    ranks of the world (``jax.make_mesh``'s devices).  Every rank calls it."""
    dims, axes = tuple(int(d) for d in dims), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call join() "
                           "first (or start the ranks with run_ranks)")
    world, need = dist.get_world_size(), math.prod(dims)
    if world < need:
        raise ValueError(f"Number of devices {world} must be >= the product "
                         f"of mesh_shape {dims}")
    if world == need:
        return Mesh(init_device_mesh(_device_type(), dims,
                                     mesh_dim_names=axes))
    return mesh_over(range(need), dims, axes)


def in_torchrun() -> bool:
    """True when ``torchrun`` (or a launcher like it) set this process's
    rank and world in the environment."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def join(rank: int, world: int, *, backend: str, init_method: str | None,
         device_index: int | None = None) -> None:
    """Start this process's group.  NCCL binds the rank to card
    ``device_index`` (default: the rank).  ``init_method`` None reads the
    torchrun environment."""
    kw = {}
    if backend == "nccl":
        idx = rank if device_index is None else device_index
        torch.cuda.set_device(idx)
        kw["device_id"] = torch.device("cuda", idx)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, **kw)


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank, world, backend, init_method, threads, out_dir,
                args):
    if threads:
        torch.set_num_threads(threads)
    try:
        join(rank, world, backend=backend, init_method=init_method)
        try:
            result = fn(rank, world, *args)
        finally:
            leave()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout: float | None = None, threads: int | None = None) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each in a
    process group (a ``file://`` store under a fresh temporary directory),
    each with ``threads`` intra-op threads if given.  ``fn`` must be
    importable by name (a module-level function).  Returns each rank's
    result (None for a rank that returned none).  A rank that raises, or a
    run that lasts past ``timeout`` seconds (None: no limit), kills every
    rank and raises here with the failing rank's traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_entry, daemon=False,
                         args=(fn, r, world, backend, init_method, threads,
                               tmp, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        timed_out = False
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        if timed_out:
            raise TimeoutError(f"{world} ranks ran past {timeout:.0f} s and "
                               "were killed")
        errs = {}
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs[r] = f.read()
        if errs or any(p.exitcode != 0 for p in procs):
            r = min(errs) if errs else next(
                r for r, p in enumerate(procs) if p.exitcode != 0)
            raise RuntimeError(f"rank {r} of {world} failed:\n"
                               + errs.get(r, f"exit code {procs[r].exitcode}"))
        out = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
