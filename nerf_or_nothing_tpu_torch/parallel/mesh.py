"""Data parallelism on ``torch.distributed``: the counterpart of
``nerf_or_nothing_tpu/parallel/mesh.py``'s 1-D ``'batch'`` mesh.

One process is one rank and drives one device: NCCL between cards, gloo on
the CPU. The params and the Adam moments are replicated (``replicate_state``
broadcasts them from rank 0), each rank takes its own rows of the batch,
and the train step averages the gradients across the ranks as soon as each
level's are computed (``train.make_train_step(group=...)``), with the
loss's denominator summed over the whole batch
(``models/mipnerf.loss_normalizer``). There is no ``shard_map``: each rank
runs the single-device step on its rows, with the collectives between the
kernels. Two ways to start the ranks:

- ``spawn``: one process a device, started by the caller
  (``run train --mesh-shape=N``, JAX's one process over N local devices);
- ``initialize_multihost``: the calling process joins a group as one rank
  (``run``'s launch flags ``--coordinator``, ``--num-processes``,
  ``--process-id``; JAX's multi-host ``jax.distributed.initialize``).

The 2-D tensor-parallel mesh (JAX ``create_mesh_2d``,
``make_tensor_parallel_train_step``) is not ported: ``run train`` raises
``NotImplementedError`` for a ``mesh_shape`` of two axes.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import multiprocessing.connection
import os
import socket
from typing import List, Optional

import torch
import torch.distributed as dist

from nerf_or_nothing_tpu_torch.device import resolve_device
from nerf_or_nothing_tpu_torch.rays import Rays


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{rank % cards}`` for an unindexed
    ``cuda`` in a group of several ranks, else ``device`` as it is (the
    CPU, an indexed card, or one process's ``cuda``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def initialize(init_method: str, num_processes: int, process_id: int,
               device="cuda", backend: Optional[str] = None) -> None:
    """Join the default group as rank ``process_id`` of ``num_processes``:
    NCCL for a CUDA device (after making this rank's card current), gloo
    for the CPU, unless ``backend`` says otherwise (gloo also reduces CUDA
    tensors, through the host)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> None:
    """The launch flags' group: a no-op for one process (``num_processes``
    None or 1), as JAX's ``jax.distributed.initialize`` wrapper. The
    coordinator is ``host:port`` (rank 0 listens there), or a
    ``tcp://`` or ``file://`` URL."""
    if num_processes is None or num_processes == 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a group of several processes needs the "
                         "coordinator's address and this process's id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    initialize(url, num_processes, process_id, device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh seen from one rank: its place, the number
    of ranks, its device and the group (None: one process, no group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup]


def create_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the default group (of this process alone without one).
    ``num_devices``, if given, must be the group's size."""
    size = world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} devices needs as many "
                         f"ranks; this process group has {size}")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(rank(), size, local_device(device), group)


def all_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks of ``group``, by one SUM
    all-reduce of one flat f32 buffer divided by the group's size (gloo
    has no AVG); views of that buffer, in the shapes of ``tensors``. At
    one rank the values come back unchanged."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def replicate_state(state):
    """Broadcast the state's params, mu and nu from rank 0, in place, in
    one flat buffer (JAX's ``replicate_state``); without a group the state
    is returned as it is."""
    if not dist.is_initialized():
        return state
    from nerf_or_nothing_tpu_torch.train import state_tensors

    tensors = state_tensors(state)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return state


def _rows(mesh: Mesh, x):
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not split over {mesh.world_size} "
                         "ranks")
    part = n // mesh.world_size
    return x[mesh.rank * part:(mesh.rank + 1) * part]


def shard_batch(mesh: Mesh, rays: Rays, pixels) -> tuple:
    """This rank's rows of a global batch (contiguous blocks in rank
    order, JAX's ``P('batch')``), for callers that hold the whole batch."""
    return Rays(*[_rows(mesh, x) for x in rays]), _rows(mesh, pixels)


def shard_batch_stack(mesh: Mesh, batches) -> list:
    """``shard_batch`` of each (rays, pixels) of a multi-step's batches
    (JAX's [K, batch] stack sharded along its ray axis)."""
    return [shard_batch(mesh, rays, pixels) for rays, pixels in batches]


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order, on ``t``'s device: an
    all-gather on the card with NCCL, through the host with gloo (which
    gathers no CUDA tensors)."""
    if mesh.group is None or mesh.world_size == 1:
        return t
    src = t.contiguous()
    if dist.get_backend(mesh.group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def make_sharded_train_step(cfg, mesh: Mesh, mlp_apply=None):
    """fn(state, rays, pixels) -> (state, Stats) on this rank's rows: the
    train step with its gradients, loss and level losses averaged over the
    mesh (``train.make_train_step`` with the mesh's group)."""
    from nerf_or_nothing_tpu_torch.train import make_train_step

    return make_train_step(cfg, mlp_apply=mlp_apply, group=mesh.group)


def make_sharded_multi_step(cfg, mesh: Mesh, mlp_apply=None):
    """fn(state, batches) -> (state, Stats of the last step) on this
    rank's rows of each batch; on the card (NCCL) each step a replay of one
    captured CUDA graph with its all-reduces inside
    (``train.make_multi_step`` with the mesh's group)."""
    from nerf_or_nothing_tpu_torch.train import make_multi_step

    return make_multi_step(cfg, mlp_apply=mlp_apply, group=mesh.group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(fn, args, index: int, ranks: int, init_method: str,
                  device: str, conn) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    initialize(init_method, ranks, index, device)
    try:
        out = fn(*args)
        if conn is not None:
            conn.send(out)
            conn.close()
    finally:
        dist.destroy_process_group()


def spawn(fn, ranks: int, device, *args):
    """Run ``fn(*args)`` in ``ranks`` new processes, started with
    the ``spawn`` method, one rank each in a group on a free local port
    (NCCL for ``cuda``, gloo for ``cpu``; each rank's card is
    ``cuda:{rank}``). ``fn`` must be importable by name and rank 0's
    result picklable; returns rank 0's result. A rank that fails ends the
    others and raises RuntimeError here. A script that reaches this must
    start under ``if __name__ == "__main__":`` (the ``spawn`` method
    imports the caller's main module again in each rank)."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    recv, send = ctx.Pipe(duplex=False)
    procs = [ctx.Process(target=_spawned_rank,
                         args=(fn, args, r, ranks, init_method,
                               str(device), send if r == 0 else None))
             for r in range(ranks)]
    for p in procs:
        p.start()
    send.close()
    result, received = None, False
    alive = {p.sentinel: r for r, p in enumerate(procs)}
    try:
        while alive or not received:
            waits = list(alive) + ([] if received else [recv])
            for ready in mp.connection.wait(waits):
                if ready is recv:
                    received = True
                    try:
                        result = recv.recv()
                    except EOFError:  # rank 0 failed; its exit code says so
                        pass
                    continue
                r = alive.pop(ready)
                procs[r].join()
                if procs[r].exitcode != 0:
                    raise RuntimeError(f"rank {r} of {ranks} exited "
                                       f"with code {procs[r].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        recv.close()
    return result
