"""The device mesh's primitives: building the mesh over a process group,
the one gather the sharded modules share, and starting ranks on one
machine. Imports torch only, so the ops and models layers use it without
reaching up into parallel/sharding.py.

    dist.init_process_group("gloo", init_method="tcp://localhost:29500",
                            world_size=2, rank=rank)     # or torchrun
    mesh = make_mesh(2, "p")                             # or ((1, 2), ("obj", "p"))
    every = all_gather(t, mesh.get_group("p"))           # [2, ...], rank order

    results = spawn_ranks(fn, world=2, args=(data,))     # fn(rank, world, port, data)

A rank is one process and one shard; NCCL process groups serve CUDA
tensors (a card per rank), gloo ones CPU tensors, or CUDA tensors staged
through host memory (ranks that share one card cannot use NCCL).
"""
from __future__ import annotations

import math
import multiprocessing as mp
import queue
import socket
import traceback

import torch
import torch.distributed as dist


def make_mesh(n_devices: int | tuple[int, ...] | None = None,
              axis_name: str | tuple[str, ...] = "p"):
    """A DeviceMesh over the ranks of the initialized process group, one
    rank per shard: 1-D by default (`make_mesh(axis_name="obj")` spans
    every rank), 2-D with a shape and a name per dimension
    (`make_mesh((2, 2), ("obj", "p"))`). The mesh covers the whole group,
    so its size is the world size. NCCL groups give a "cuda" mesh, gloo
    ones a "cpu" mesh (whatever device the tensors live on)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: start the ranks "
            "with torchrun, or call torch.distributed.init_process_group")
    world = dist.get_world_size()
    if n_devices is None:
        shape = (world,)
    elif isinstance(n_devices, int):
        shape = (n_devices,)
    else:
        shape = tuple(n_devices)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(names) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in rank")
    if math.prod(shape) != world:
        raise ValueError(
            f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the "
            f"process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_axis(mesh, name: str) -> tuple[int, int]:
    """(size, this rank's index) of the mesh dimension `name`."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"{name!r} is not a dimension of the mesh {names}")
    return mesh.size(names.index(name)), mesh.get_local_rank(name)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` in `group`, stacked in rank order: [n, ...] on t's
    device (a rank alone gets t[None], with no communication). A gloo
    group's CUDA tensors go through host memory: what the port gathers
    (champions, candidate sets, a step's results) is kilobytes."""
    n = dist.get_world_size(group)
    if n == 1:
        return t[None]
    src = t.contiguous()
    if src.device.type != "cpu" and dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def is_writer(mesh) -> bool:
    """Whether this process writes a file every rank would write alike: the
    one process without a mesh, or global rank 0."""
    return mesh is None or dist.get_rank() == 0


def free_port() -> int:
    """A free TCP port on localhost, for a process group's init_method."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawned(fn, rank: int, world: int, port: int, args: tuple, results) -> None:
    """A spawned rank: fn's result, or its traceback, to the parent."""
    try:
        results.put((rank, True, fn(rank, world, port, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world: int, args: tuple = (), timeout: float = 300.0) -> list:
    """Run `fn(rank, world, port, *args)` in `world` spawned processes (fn
    a module-level function that joins the process group at
    tcp://localhost:<port> itself) and return each rank's result in rank
    order. A rank that raises fails the call with its traceback, ranks
    that send nothing in `timeout` seconds raise TimeoutError, a rank that
    exits non-zero raises RuntimeError; every rank is stopped on return."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(fn, r, world, port, args, results))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                   f"sent nothing in {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return [got[r] for r in range(world)]
