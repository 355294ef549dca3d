"""Data and tensor parallelism on ``torch.distributed``: the counterpart of
``nerf_or_nothing_tpu/parallel/mesh.py``'s 1-D ``'batch'`` mesh and its 2-D
``('batch', 'model')`` grid.

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
  (``run train --mesh-shape=N``, JAX's one process over N local devices:
  the ranks read the whole pool, draw the global batch and each keeps its
  row block, ``shard_batch``);
- ``initialize_multihost``: the calling process joins a group as one rank
  (``run``'s launch flags ``--coordinator``, ``--num-processes``,
  ``--process-id``; JAX's multi-host ``jax.distributed.initialize``: each
  process draws a batch from its own stripe of the pool).

The 2-D grid (``create_mesh_2d``, ``make_tensor_parallel_train_step``;
``run train --mesh-shape=dp,mp``) is JAX's GSPMD step with its collectives
written out. Rank ``b * mp + m`` holds row block ``b`` of the global batch
and column block ``m`` of every layer whose fan-out ``mp`` divides (weight,
bias and Adam moments, ``shard_params``; the narrow heads are replicated,
``layer_sharded``). Each sharded layer is column-parallel
(``column_parallel_mlp``): Megatron's pair of autograd functions over the
``'model'`` group, an identity whose backward sums the input gradient and
an all-gather of the output columns whose backward keeps this rank's
columns. The gradients, the loss and its denominator are averaged over the
``'batch'`` group, the global norm and the weight L2 sum the sharded
layers over ``'model'`` (``train.make_train_step(grid=...)``), and
``gather_params`` puts the whole model back together for a checkpoint or
a render.
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
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
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


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in rank order, on ``t``'s device:
    an all-gather on the card with NCCL, through the host with gloo (which
    gathers no CUDA tensors)."""
    src = t.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order, on ``t``'s device."""
    if mesh.group is None or mesh.world_size == 1:
        return t
    return torch.cat(_all_gather(t, mesh.group, mesh.world_size))


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


# ---------------------------------------------------------------------------
# The 2-D ('batch', 'model') grid: tensor parallelism
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``dp`` x ``mp`` grid seen from rank ``b * mp + m`` (JAX's
    ``devices.reshape(dp, mp)``): its row ``b`` on the ``'batch'`` axis, its
    column ``m`` on ``'model'``, its device, the ``dp`` ranks of its column
    (``batch_group``: same ``m``, they average the gradients) and the
    ``mp`` ranks of its row (``model_group``: same ``b``, they hold the
    same rows and split the layers). The groups are None in a process
    without a group (a 1 x 1 grid)."""

    b: int
    m: int
    dp: int
    mp: int
    device: torch.device
    batch_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]

    @property
    def batch_mesh(self) -> Mesh:
        """The ``'batch'`` axis as a 1-D mesh: row block ``b`` of ``dp``."""
        return Mesh(self.b, self.dp, self.device, self.batch_group)


def create_mesh_2d(dp: int, mp: int, device="cuda") -> Mesh2D:
    """This rank's place in the ``dp`` x ``mp`` grid of the default group,
    whose size must be ``dp * mp`` (1 x 1 without a group). Every rank
    creates every row's and column's group, in the same order."""
    size = world_size()
    if dp * mp != size:
        raise ValueError(f"a {dp} x {mp} grid needs {dp * mp} ranks; this "
                         f"process group has {size}")
    b, m = divmod(rank(), mp)
    batch_group = model_group = None
    if dist.is_initialized():
        for j in range(mp):
            g = dist.new_group([i * mp + j for i in range(dp)])
            batch_group = g if j == m else batch_group
        for i in range(dp):
            g = dist.new_group([i * mp + j for j in range(mp)])
            model_group = g if i == b else model_group
    return Mesh2D(b, m, dp, mp, local_device(device), batch_group,
                  model_group)


def layer_sharded(cfg, mp: int) -> List[bool]:
    """Whether each layer is split over ``'model'``: JAX's rule, a layer
    whose fan-out ``mp`` divides (at ``Config()`` and mp 2 or 4 the trunk
    and the view layer; the density and rgb heads stay replicated)."""
    return [o % mp == 0 for _, o in mlp_lib.layer_dims(cfg)]


def shard_params(params, grid: Mesh2D, cfg) -> mlp_lib.Params:
    """This rank's copy of ``params`` (or Adam moments): the contiguous
    output-column block ``m`` of each sharded layer's ``w`` [in, out/mp]
    and ``b`` (JAX's ``P(None, 'model')`` / ``P('model')``), the
    replicated layers whole."""
    out = []
    for (w, b), sharded in zip(params, layer_sharded(cfg, grid.mp)):
        k = w.shape[1] // grid.mp if sharded else w.shape[1]
        cols = slice(grid.m * k, (grid.m + 1) * k) if sharded else slice(None)
        out.append((w[:, cols].clone(memory_format=torch.contiguous_format),
                    b[cols].clone()))
    return out


def gather_params(params, grid: Mesh2D, cfg) -> mlp_lib.Params:
    """The whole layers from every rank's ``shard_params`` block, in column
    order, by one all-gather over ``'model'`` (every rank of the row calls
    it). At mp 1 the tensors come back as they are."""
    sharded = layer_sharded(cfg, grid.mp)
    if grid.mp == 1:
        return list(params)
    leaves = [t for wb, s in zip(params, sharded) if s for t in wb]
    if not leaves:
        return list(params)
    parts = _all_gather(torch.cat([t.reshape(-1) for t in leaves]),
                        grid.model_group, grid.mp)
    out, off = [], 0
    for wb, s in zip(params, sharded):
        if not s:
            out.append(wb)
            continue
        whole = []
        for t in wb:
            whole.append(torch.cat([p[off:off + t.numel()].view(t.shape)
                                    for p in parts], dim=-1))
            off += t.numel()
        out.append(tuple(whole))
    return out


def shard_state(state, grid: Mesh2D, cfg):
    """The train state with its params, mu and nu as this rank's blocks."""
    return dataclasses.replace(state, **{
        k: shard_params(getattr(state, k), grid, cfg)
        for k in ("params", "mu", "nu")})


def gather_state(state, grid: Mesh2D, cfg):
    """The whole train state from the ranks' blocks (``gather_params`` of
    params, mu and nu; every rank calls it)."""
    return dataclasses.replace(state, **{
        k: gather_params(getattr(state, k), grid, cfg)
        for k in ("params", "mu", "nu")})


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the input gradient summed over the
    ``'model'`` group (each rank's is the partial ``dY_m W_m^T``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the output columns over the ``'model'`` group, in
    ``m`` order; backward, this rank's columns of the gradient (every rank
    computes the same replicated loss from the gathered activation, so the
    gradient is not summed)."""

    @staticmethod
    def forward(ctx, y, group, m, mp):
        k = y.shape[-1]
        ctx.cols = slice(m * k, (m + 1) * k)
        return torch.cat(_all_gather(y, group, mp), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None, None, None


def column_parallel_mlp(cfg, grid: Mesh2D):
    """fn(params, cfg, x, dir_enc) -> (raw_rgb, raw_density) on this
    rank's ``shard_params`` (the ``mlp_apply`` of ``render_rays``): the
    plain ``apply_mlp``'s arithmetic, each sharded layer's product on its
    column block between ``_CopyToModel`` and ``_GatherFromModel``, its
    bias added before the gather and its ReLU after. At mp 1 it is
    ``apply_mlp`` itself."""
    sharded = layer_sharded(cfg, grid.mp)
    dt = mlp_lib.compute_dtype(cfg)

    def linear(i, h, w, b):
        if not sharded[i] or grid.mp == 1:
            return mlp_lib.dense(h, w, dt) + b
        y = mlp_lib.dense(_CopyToModel.apply(h, grid.model_group), w, dt) + b
        return _GatherFromModel.apply(y, grid.model_group, grid.m, grid.mp)

    def mlp_apply(params, c, x, dir_enc):
        return mlp_lib.apply_mlp(params, c, x, dir_enc, compute_dtype=dt,
                                 linear=linear)

    return mlp_apply


def make_tensor_parallel_train_step(cfg, grid: Mesh2D):
    """fn(state, rays, pixels) -> (state, Stats): JAX's
    ``make_tensor_parallel_train_step`` on this rank's blocks of the state
    (``shard_state``) and its row block ``b`` of the global batch. As in
    JAX the plain MLP runs (``use_pallas=False``: the kernels hold whole
    weights) and the stats are the whole batch's, the same on every rank;
    the draws are the single-process step's (each row draws the global
    batch's uniforms and keeps its rows). One step a call: no
    multi-step."""
    from nerf_or_nothing_tpu_torch.train import make_train_step

    cfg = cfg.replace(use_pallas=False)
    return make_train_step(cfg, mlp_apply=column_parallel_mlp(cfg, grid),
                           grid=grid)


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
