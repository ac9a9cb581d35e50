"""Mesh construction over ``torch.distributed`` (counterpart of
``repro.launch.mesh``), and :func:`run_world`, which spawns a world of
ranks on one host.

A function, not a module constant: importing this module touches no
process group. ``make_production_mesh`` / ``make_small_mesh`` build a
``DeviceMesh`` over the running world and raise when its size is not
the mesh's (they never shrink the mesh). :func:`mesh_shape` gives the
process-free :class:`~repro_torch.sharding.act.MeshShape` form, from
which head plans and specs for the production geometry are derived on
one machine.

:func:`run_world` is the counterpart of the reference's
``--xla_force_host_platform_device_count``: ``fn(rank, world)`` runs in
``world`` spawned processes joined into one process group (``gloo`` on
host tensors, ``nccl`` one card a rank), and the ranks' results come
back in rank order.
"""

from __future__ import annotations

import queue
import socket
import traceback
from typing import Any, Callable, Dict, List, Sequence

from repro_torch.sharding.act import MeshShape, as_shape

PRODUCTION = {"data": 16, "model": 16}
PRODUCTION_MULTI_POD = {"pod": 2, "data": 16, "model": 16}


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of ``{name: size}``, a ``DeviceMesh`` or a
    ``MeshShape``."""
    return as_shape(mesh)


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the running
    world, whose size must be the mesh's: of CUDA devices under NCCL,
    else of the host."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the world first "
                           "(run_world, or init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = PRODUCTION_MULTI_POD if multi_pod else PRODUCTION
    return make_mesh(tuple(shape.values()), tuple(shape))


def make_small_mesh(n_data: int = 2, n_model: int = 4):
    """Reduced mesh for tests (8 ranks by default)."""
    return make_mesh((n_data, n_model), ("data", "model"))


# ------------------------------------------------------------------ worlds
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str,
               results) -> None:
    import torch
    import torch.distributed as dist
    try:
        # ranks share the host's cores: one thread each keeps a world
        # from oversubscribing them
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank)
        try:
            out = fn(rank, world)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable[[int, int], Any], world: int,
              backend: str = "gloo", *, timeout: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world)`` in ``world`` spawned ranks joined into one
    process group (torch on one thread in each); return the ranks'
    results in rank order, or raise with the first failing rank's
    traceback. ``fn`` must be importable by name (a module-level
    function) and its result picklable. A world that has not answered
    within ``timeout`` seconds is killed and raises."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} ({backend}): ranks "
                                   f"{sorted(set(range(world)) - set(got))}"
                                   f" did not answer in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"world of {world} ({backend}): rank "
                                       f"{dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"world of {world} ({backend}): rank "
                                   f"{rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    return [got[r] for r in range(world)]
