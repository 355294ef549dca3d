"""Training: Adam, gradient clipping, the LR schedule and the train step.

Same contract as ``nerf_or_nothing_tpu/train.py`` on one device:

- ``adam_update``: m/v moving averages and the bias-corrected step with
  eps inside the square root, ``p -= lr * (m c1) / sqrt(v c2 + eps)``,
  ``lr``, ``c1`` and ``c2`` read from device tensors;
- ``clip_grads``: value clipping, then norm clipping over all tensors;
- ``make_train_step``: a host prologue (the step, the generator's seed,
  ``adam_scalars``) and a device body. With ``use_fused_level`` (the
  default config) each level is one ``fused_level_train`` call (the train
  kernel on the card, its plain version on the CPU) and the per-level
  dW/db are summed; otherwise ``torch.autograd`` over ``render_rays`` +
  ``multiscale_loss``, whose levels (with ``use_pallas``) run the
  ``mlp_fwd`` kernel and, in the backward, ``mlp_bwd``, with the weights
  packed once per step. ``check_numerics`` / ``debug_nans`` check the
  gradients before the update;
- ``make_multi_step``: the same step K times, returning the last step's
  stats, as the JAX package's ``lax.scan`` multi-step does; on the card
  each step is a replay of the body captured in a CUDA graph.

Both take a ``group`` of ``torch.distributed`` for data parallelism
(``parallel/mesh.py``): each level's dW/db are averaged over the ranks as
soon as the level's are computed, the autograd branch's gradients once
after the backward, then the loss and the level losses; the loss's
denominator is the whole batch's; each rank draws its own random numbers.
With a tensor-parallel ``grid``
(``parallel/mesh.make_tensor_parallel_train_step``) the params are the
rank's blocks, the group is the grid's ``'batch'`` group, the global norm,
its max and the weight L2 take the sharded layers' parts over
``'model'``, the stats are the whole batch's and every rank draws the
single-process step's numbers, keeping its rows.

The parameters and the Adam moments are updated in place, through
``torch._foreach_*`` ops, which bump each tensor's version counter (graph
replays do not; the multi-step bumps it after them): a cache keyed on the
tensors' identity and ``_version`` (``eval.make_render_fn``'s packed
weights) sees every update. Random draws come from the state's
``torch.Generator``, reseeded at every step from (``cfg.seed``, step), so
a resumed run draws what an uninterrupted one draws, and from (``cfg.seed``,
step, rank) under a group.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from nerf_or_nothing_tpu_torch import kernels
from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.metrics import Stats
from nerf_or_nothing_tpu_torch.models import mipnerf
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
from nerf_or_nothing_tpu_torch.ops.math_utils import (
    learning_rate_decay,
    mse_to_psnr,
)
from nerf_or_nothing_tpu_torch.parallel.mesh import all_mean, layer_sharded
from nerf_or_nothing_tpu_torch.rays import Rays


@dataclasses.dataclass
class TrainState:
    """step + params + Adam moments + the generator of the step's draws."""

    step: int
    params: mlp_lib.Params
    mu: mlp_lib.Params      # first moment (m)
    nu: mlp_lib.Params      # second moment (v)
    generator: torch.Generator


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """Seed of the generator at ``step``; a checkpoint stores (seed, step).
    Each rank of a group folds its rank in (JAX's ``fold_in`` of the axis
    index); rank 0 draws what a single process draws."""
    base = ((seed & 0xFFFFFFFF) << 31 | (step & 0x7FFFFFFF)) & (2**63 - 1)
    return base ^ ((rank * 0x9E3779B97F4A7C15) & (2**63 - 1))


def init_train_state(cfg: Config, device="cpu") -> TrainState:
    """Seeded Glorot weights (the same draw as ``run.load_params``), zero
    moments, and a generator on ``device``."""
    device = torch.device(device)
    params = mlp_lib.init_mlp(torch.Generator().manual_seed(cfg.seed), cfg,
                              device=device)
    zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                     for w, b in params]
    gen = torch.Generator(device=device).manual_seed(step_seed(cfg.seed, 0))
    return TrainState(0, params, zeros(), zeros(), gen)


def _leaves(tree) -> List[torch.Tensor]:
    return [t for wb in tree for t in wb]


def adam_scalars(cfg: Config, step: int):
    """The host prologue's numbers of ``step``: the learning rate (the 0-dim
    f32 tensor the stats log) and [lr, c1, c2] in f32, the bias corrections
    c = 1 / (1 - beta^t) computed as the JAX package computes them."""
    lr = learning_rate_decay(
        step, cfg.lr_init, cfg.lr_final, cfg.max_steps, cfg.lr_delay_steps,
        cfg.lr_delay_mult,
    )
    t = np.float32(step)
    c1 = np.float32(1.0) / (np.float32(1.0) - np.float32(cfg.adam_beta1) ** t)
    c2 = np.float32(1.0) / (np.float32(1.0) - np.float32(cfg.adam_beta2) ** t)
    return lr, np.array([float(lr), c1, c2], np.float32)


def adam_update(params, grads, mu, nu, lr: torch.Tensor, c1: torch.Tensor,
                c2: torch.Tensor, cfg: Config):
    """Adam in place: m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2;
    p -= lr * (m c1) * rsqrt(v c2 + eps). ``lr``, ``c1`` and ``c2`` are
    0-dim f32 tensors on the params' device (``adam_scalars``), read by
    the device: a CUDA graph of the step reads each replay's values."""
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    p, g, m, v = _leaves(params), _leaves(grads), _leaves(mu), _leaves(nu)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2),
                                              g))
    denom = torch._foreach_mul(v, c2)
    torch._foreach_add_(denom, eps)
    torch._foreach_rsqrt_(denom)
    upd = torch._foreach_mul(m, c1)
    torch._foreach_mul_(upd, lr)
    torch._foreach_mul_(upd, denom)
    torch._foreach_sub_(p, upd)


def _split(tree, cfg: Config, grid):
    """(the leaves of the layers sharded over ``grid``'s ``'model'`` axis,
    the replicated layers' leaves), each in layer order; without a grid
    every leaf is in the first list."""
    sharded = ([True] * len(tree) if grid is None
               else layer_sharded(cfg, grid.mp))
    return ([t for wb, s in zip(tree, sharded) if s for t in wb],
            [t for wb, s in zip(tree, sharded) if not s for t in wb])


def _model_reduce(t: torch.Tensor, grid, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``grid``'s ``'model'`` group, in place (nothing
    to do without a grid or at mp 1)."""
    if grid is not None and grid.mp > 1:
        dist.all_reduce(t, op=op, group=grid.model_group)
    return t


def _sq_max(leaves):
    flat = torch.cat([t.reshape(-1) for t in leaves])
    return torch.sum(flat * flat), torch.max(torch.abs(flat))


def clip_grads(grads, cfg: Config, grid=None):
    """Value clipping (``grad_max_val``), then norm clipping
    (``grad_max_norm``) over all tensors. Returns (grads, grad_norm,
    clipped_norm, grad_abs_max), the max taken after clipping. With a
    tensor-parallel ``grid`` the grads are this rank's blocks: the sharded
    layers' sum of squares is summed, and their max taken, over
    ``'model'``, and the replicated layers' added once."""
    if cfg.grad_max_val > 0:
        grads = [(torch.clamp(w, -cfg.grad_max_val, cfg.grad_max_val),
                  torch.clamp(b, -cfg.grad_max_val, cfg.grad_max_val))
                 for w, b in grads]
    sharded, replicated = _split(grads, cfg, grid)
    sq = grad_abs_max = None
    if sharded:
        sq, grad_abs_max = _sq_max(sharded)
        _model_reduce(sq, grid)
        _model_reduce(grad_abs_max, grid, dist.ReduceOp.MAX)
    if replicated:
        rsq, rmax = _sq_max(replicated)
        sq = rsq if sq is None else sq + rsq
        grad_abs_max = rmax if grad_abs_max is None else torch.maximum(
            grad_abs_max, rmax)
    grad_norm = torch.sqrt(sq)
    if cfg.grad_max_norm > 0:
        mult = torch.clamp(cfg.grad_max_norm / (1e-10 + grad_norm), max=1.0)
        grads = [(w * mult, b * mult) for w, b in grads]
        grad_abs_max = grad_abs_max * mult
    clipped_norm = (torch.clamp(grad_norm, max=cfg.grad_max_norm)
                    if cfg.grad_max_norm > 0 else grad_norm)
    return grads, grad_norm, clipped_norm, grad_abs_max


def use_fused_level(cfg: Config) -> bool:
    """Whether the whole-level train kernel applies to this config."""
    return (
        cfg.use_pallas
        and cfg.fuse_level
        and cfg.stop_level_grad
        and (not cfg.fuse_ipe or cfg.diag_covariance)
        and cfg.num_rgb_channels == 3
        and cfg.num_density_channels == 1
    )


@torch.no_grad()
def _weight_l2(params, cfg: Config, grid=None) -> torch.Tensor:
    """The sum of the weights' squares; with a tensor-parallel ``grid`` the
    whole model's from this rank's blocks, as ``clip_grads`` sums the
    gradients' squares."""
    sharded, replicated = _split([(w,) for w, _ in params], cfg, grid)
    l2 = sum(torch.sum(w ** 2) for w in sharded)
    if sharded:
        _model_reduce(l2, grid)
    return l2 + sum(torch.sum(w ** 2) for w in replicated)


@torch.no_grad()
def _add_weight_decay(cfg: Config, params, total: torch.Tensor, grads,
                      grid=None):
    """(total + weight_decay_mult x the weight L2, that L2, the grads with
    the decay's gradient 2 x weight_decay_mult x w added to each dW); the
    L2 is 0 without weight decay."""
    if cfg.weight_decay_mult <= 0:
        return total, torch.zeros((), device=total.device), grads
    wl2 = _weight_l2(params, cfg, grid)
    grads = [(gw + 2.0 * cfg.weight_decay_mult * w, gb)
             for (gw, gb), (w, _) in zip(grads, params)]
    return total + cfg.weight_decay_mult * wl2, wl2, grads


def _pairs(leaves) -> List[tuple]:
    return list(zip(leaves[0::2], leaves[1::2]))


@torch.no_grad()
def _fused_level_value_and_grad(cfg: Config, params, generator, rays: Rays,
                                pixels, group=None):
    """Loss and gradients from one ``fused_level_train`` call per level.

    Valid with ``stop_level_grad``: each level's loss gradient is then
    independent, so the total gradient is the sum of the levels' dW/db,
    each level's loss weight folded into its per-ray g_scale. The weights
    are packed once for both levels, in the layouts of the kernel the
    step launches (``pack_train``). With a ``group`` each level's 2 x
    layers tensors are averaged over the ranks in one all-reduce as soon
    as the level's kernel returns, the denominator being the whole batch's.

    Returns (loss, (level_losses, fine_rgb, weight_l2), grads).
    """
    from nerf_or_nothing_tpu_torch.kernels.fused_level import (
        fused_level_train,
        pack_train,
    )

    dt = mlp_lib.compute_dtype(cfg)
    packed = None
    if rays.origins.is_cuda:
        packed = pack_train(params, cfg, dt)
    dir_enc = mipnerf.encode_dirs(cfg, rays)
    mask, denom = mipnerf.loss_normalizer(cfg, rays.loss_mult, group)
    grads = None
    losses = []
    comp = t_vals = weights = None
    for i_level in range(cfg.num_levels):
        t_vals, (means, covs) = mipnerf.sample_level(
            cfg, rays, i_level, t_vals, weights, cfg.randomized,
            stop_grad=True, generator=generator,
        )
        x_enc, means_covs = mipnerf.encode_samples(
            cfg, means, covs, in_kernel=True, dtype=dt
        )
        g_scale = (
            mipnerf.level_weight(cfg, i_level) * 2.0 * mask / denom
        )[..., None]
        comp, _, weights, d_params = fused_level_train(
            params, cfg, x_enc, dir_enc, t_vals, rays.directions, pixels,
            g_scale, cfg.white_bkgd, means_covs=means_covs, packed=packed,
        )
        losses.append(
            torch.sum(mask * torch.sum((comp - pixels) ** 2, dim=-1)) / denom
        )
        if group is not None:
            d_params = _pairs(all_mean(_leaves(d_params), group))
        if grads is None:
            grads = d_params
        else:
            torch._foreach_add_(_leaves(grads), _leaves(d_params))
    losses = torch.stack(losses)
    total, wl2, grads = _add_weight_decay(
        cfg, params, mipnerf.total_from_level_losses(cfg, losses), grads)
    return total, (losses, comp, wl2), grads


def _autograd_value_and_grad(cfg: Config, params, generator, rays: Rays,
                             pixels, mlp_apply=None, group=None, grid=None):
    """Loss and gradients by ``torch.autograd`` over ``render_rays`` +
    ``multiscale_loss`` (the JAX package's ``jax.value_and_grad`` branch).
    ``render_rays`` packs the kernels' weights once for both levels and
    both directions. With a ``group`` the gradients are averaged over the
    ranks in one all-reduce after the backward; the weight decay's
    gradient is added after that, as in the fused-level branch. With a
    tensor-parallel ``grid`` the draws are the global batch's rows ``b``
    and the weight L2 is the whole model's."""
    leaves = [t.detach().requires_grad_() for t in _leaves(params)]
    p = _pairs(leaves)
    rows = None
    if grid is not None:
        n = pixels.shape[0]
        rows = (grid.b * n, grid.dp * n)
    with torch.enable_grad():
        results = mipnerf.render_rays(
            p, cfg, rays, randomized=cfg.randomized,
            white_bkgd=cfg.white_bkgd, mlp_apply=mlp_apply,
            generator=generator, rows=rows,
        )
        loss, level_losses = mipnerf.multiscale_loss(
            results, pixels, rays.loss_mult, cfg, group
        )
        flat = list(torch.autograd.grad(loss, leaves))
    if group is not None:
        flat = all_mean(flat, group)
    total, wl2, grads = _add_weight_decay(cfg, params, loss.detach(),
                                          _pairs(flat), grid)
    return (total, (level_losses.detach(), results[-1].rgb.detach(), wl2),
            grads)


# ---------------------------------------------------------------------------
# The train step: a host prologue and a device body
# ---------------------------------------------------------------------------
#
# The prologue (step += 1, the generator's seed, the learning rate and the
# bias corrections) runs on the host. The body (loss and gradients, then
# clipping, Adam and the stats) runs on the device and reads the
# prologue's numbers from a tensor, so the eager step and the CUDA-graph
# step (``_CapturedStep``) run the same body.


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def batch_to_device(device, rays, pixels):
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return (Rays(*[_tensor(x).to(device) for x in rays]),
            _tensor(pixels).to(device))


def _grad_part(cfg: Config, mlp_apply, params, generator, rays: Rays,
               pixels, group=None, grid=None):
    """The body's first part: (loss, level_losses, mse of the fine level,
    weight_l2, grads) from the fused-level branch or the autograd one;
    with a ``group`` the gradients, the loss and the level losses are the
    ranks' means (the mse stays this rank's, so the step's psnr is the
    rank's own, as in the JAX package's ``shard_map`` step; with a
    tensor-parallel ``grid`` it is the whole batch's, as GSPMD's)."""
    args = (cfg, params, generator, rays, pixels)
    if use_fused_level(cfg) and mlp_apply is None:
        out = _fused_level_value_and_grad(*args, group)
    else:
        out = _autograd_value_and_grad(*args, mlp_apply, group, grid)
    loss, (level_losses, fine_rgb, wl2), grads = out
    mse = torch.mean((fine_rgb - pixels) ** 2)
    if group is not None:
        loss, level_losses, batch_mse = all_mean([loss, level_losses, mse],
                                                 group)
        if grid is not None:
            mse = batch_mse
    return loss, level_losses, mse, wl2, grads


@torch.no_grad()
def _update_part(cfg: Config, state: TrainState, scalars: torch.Tensor,
                 loss, level_losses, mse, wl2, grads, grid=None):
    """The body's second part: clipping, Adam in place with ``scalars``
    ([lr, c1, c2] on the device), and the step's stats but the learning
    rate, in ``Stats``' order."""
    grads, grad_norm, clipped_norm, grad_abs_max = clip_grads(grads, cfg,
                                                              grid)
    adam_update(state.params, grads, state.mu, state.nu, scalars[0],
                scalars[1], scalars[2], cfg)
    return (loss, level_losses, wl2, mse_to_psnr(mse),
            mse_to_psnr(level_losses), grad_norm, grad_abs_max, clipped_norm)


def finite_flags(loss, level_losses, grads, grid=None) -> torch.Tensor:
    """One bool a tensor, on the device: whether the loss, the level losses
    and each dW and db are finite (``raise_if_not_finite`` reads them); with
    a tensor-parallel ``grid``, on every rank of its ``'model'`` group."""
    flags = torch.stack([torch.isfinite(t).all()
                         for t in [loss, level_losses, *_leaves(grads)]])
    if grid is None or grid.mp == 1:
        return flags
    return _model_reduce(flags.float(), grid, dist.ReduceOp.MIN).bool()


def raise_if_not_finite(flags: torch.Tensor, step: int) -> None:
    """Read ``finite_flags`` once on the host; raise FloatingPointError
    naming the first tensor that holds a nan or an inf."""
    ok = flags.cpu()
    if bool(ok.all()):
        return
    names = ["loss", "losses"] + [f"{kind}{i}"
                                  for i in range((len(ok) - 2) // 2)
                                  for kind in ("dW", "db")]
    name = names[int((~ok).nonzero()[0, 0])]
    raise FloatingPointError(
        f"nan or inf in {name} at train step {step} (check_numerics / "
        "debug_nans); the step was not applied")


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def make_train_step(cfg: Config, mlp_apply=None, group=None, grid=None):
    """fn(state, rays, pixels) -> (state, Stats), updating ``state`` in
    place. ``rays`` and ``pixels`` are tensors on the state's device.

    With ``check_numerics`` or ``debug_nans`` (the JAX package's checkify
    of the step and ``jax_debug_nans``) one device reduction over the loss,
    the level losses and the gradients is read on the host after the
    gradients and before Adam; a nan or an inf raises FloatingPointError
    and leaves the state, its step and its generator as they were.

    ``group``: this rank's step of a data-parallel group (JAX's
    ``axis_name``; ``parallel/mesh.make_sharded_train_step``). The finite
    check reads the averaged values, so every rank raises or none does.
    ``grid``: this rank's step of a tensor-parallel grid
    (``parallel/mesh.make_tensor_parallel_train_step``), its ``'batch'``
    group the ``group``; every rank draws from the unfolded seed."""
    check = cfg.check_numerics or cfg.debug_nans
    if grid is not None:
        group = grid.batch_group
    rank = 0 if grid is not None else _rank(group)

    def train_step(state: TrainState, rays: Rays, pixels: torch.Tensor):
        step = state.step + 1
        lr, host = adam_scalars(cfg, step)
        before = state.generator.get_state() if check else None
        state.generator.manual_seed(step_seed(cfg.seed, step, rank))
        scalars = torch.from_numpy(host).to(pixels.device)
        part = _grad_part(cfg, mlp_apply, state.params, state.generator,
                          rays, pixels, group, grid)
        if check:
            try:
                raise_if_not_finite(
                    finite_flags(part[0], part[1], part[4], grid), step)
            except FloatingPointError:
                state.generator.set_state(before)
                raise
        out = _update_part(cfg, state, scalars, *part, grid=grid)
        state.step = step
        return state, Stats(*out, learning_rate=lr)

    return train_step


# ---------------------------------------------------------------------------
# The multi-step: K steps a call, on the card as replays of a CUDA graph
# ---------------------------------------------------------------------------

# Eager steps on a clone of the state before a capture: they build the
# kernels, set their attributes, fill the packing and frequency caches and
# start autograd, none of which a capture may do.
WARMUP_STEPS = 2


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The state's params, mu and nu, in that order."""
    return [*_leaves(state.params), *_leaves(state.mu), *_leaves(state.nu)]


def _batch_shape(batch):
    """(number of rays, the widths of the Rays fields and of pixels) of a
    batch: the graph's key."""
    rays, pixels = batch
    return pixels.shape[0], tuple([x.shape[-1] for x in rays]
                                  + [pixels.shape[-1]])


class _CapturedStep:
    """One train step captured in a CUDA graph at one batch size.

    The graph reads its inputs from one static f32 buffer: the batch's
    Rays fields and pixels, each flattened, then the prologue's [lr, c1,
    c2]. A call stages its K batches with one host-to-device copy; each
    step then reseeds the state's generator on the host (the graph reads
    the generator's seed and offset at each replay:
    ``register_generator_state``), copies its row into the buffer and
    replays the graph. With ``debug_nans`` the step is two graphs, the
    gradients with ``finite_flags`` and then the update, and the flags are
    read between them. The graph holds the state's tensors by address:
    ``holds`` says whether a state is the one it was captured with.

    The wrappers' launch counters see the capture, which launches nothing:
    the launches counted in it are taken back and added once a replay
    (``launches``). ``pool_bytes``: the memory the capture reserved.

    With a NCCL ``group`` the step's all-reduces are captured too: the
    warm-up steps run them first on every rank, which sets up NCCL's
    communicator outside the capture."""

    def __init__(self, cfg: Config, mlp_apply, state: TrainState, batch,
                 group=None):
        self.cfg, self.mlp_apply, self.group = cfg, mlp_apply, group
        self.rank = _rank(group)
        self.device = state.params[0][0].device
        self.split = cfg.debug_nans
        rows, self.widths = _batch_shape(batch)
        size = rows * sum(self.widths) + 3
        self.flat = torch.zeros((size,), dtype=torch.float32,
                                device=self.device)
        views, off = [], 0
        for w in self.widths:
            views.append(self.flat[off:off + rows * w].view(rows, w))
            off += rows * w
        self.rays, self.pixels = Rays(*views[:-1]), views[-1]
        self.scalars = self.flat[off:]
        self.rows = rows
        # Held, so that no other tensor takes their ids while the graph
        # lives.
        self._held = [state.generator, *state_tensors(state)]
        self._key = self._key_of(state)
        self._capture(state, batch)

    @staticmethod
    def _key_of(state: TrainState):
        return (id(state.generator),
                [(id(t), t.data_ptr()) for t in state_tensors(state)])

    def holds(self, state: TrainState) -> bool:
        return self._key == self._key_of(state)

    def _stage(self, batches, hosts) -> torch.Tensor:
        """[K, buffer] on the device: each batch and its prologue numbers,
        in one host-to-device copy from a new pinned tensor (the caching
        host allocator hands its memory out again only once the copy has
        run)."""
        rows = []
        for (rays, pixels), host in zip(batches, hosts):
            parts = [_tensor(x) for x in (*rays, pixels)]
            for x, w in zip(parts, self.widths):
                if x.dtype != torch.float32 or tuple(x.shape) != (
                        self.rows, w):
                    raise ValueError(
                        f"the captured step takes float32 [{self.rows}, {w}] "
                        f"batch fields, got {x.dtype} {tuple(x.shape)}")
            rows.append(torch.cat([x.reshape(-1).cpu() for x in parts]
                                  + [torch.from_numpy(host)]))
        return torch.stack(rows).pin_memory().to(self.device,
                                                 non_blocking=True)

    def _grad(self, state: TrainState):
        return _grad_part(self.cfg, self.mlp_apply, state.params,
                          state.generator, self.rays, self.pixels, self.group)

    def _update(self, state: TrainState, part):
        return _update_part(self.cfg, state, self.scalars, *part)

    def _capture(self, state: TrainState, batch) -> None:
        cfg, device = self.cfg, self.device
        step = state.step + 1
        self.flat.copy_(self._stage([batch], [adam_scalars(cfg, step)[1]])[0])
        clone = TrainState(
            state.step, *[[(w.clone(), b.clone()) for w, b in tree]
                          for tree in (state.params, state.mu, state.nu)],
            torch.Generator(device=device).manual_seed(
                step_seed(cfg.seed, step, self.rank)))
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                part = self._grad(clone)
                if self.split:
                    finite_flags(part[0], part[1], part[4])
                self._update(clone, part)
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        del clone, part
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)

        self.graphs, self.launches = [], []
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, stream=stream):
            part = self._grad(state)
            if self.split:
                self.flags = finite_flags(part[0], part[1], part[4])
            else:
                self.out = self._update(state, part)
        self._took_back(graph, before)
        if self.split:
            update = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            with torch.cuda.graph(update, pool=graph.pool(), stream=stream):
                self.out = self._update(state, part)
            self._took_back(update, before)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def _took_back(self, graph, before: dict) -> None:
        """Take the launches counted in a capture back off the counters."""
        counts = kernels.launch_counts()
        self.graphs.append(graph)
        self.launches.append({k: counts[k] - before[k] for k in counts})
        kernels.add_launches({k: before[k] - counts[k] for k in counts})

    def _replay(self, i: int) -> None:
        self.graphs[i].replay()
        kernels.add_launches(self.launches[i])

    def run(self, state: TrainState, batches):
        """The K steps of ``batches``, in order; (state, Stats of the last
        step), the stats cloned out of the graph's outputs."""
        cfg = self.cfg
        lrs, hosts = zip(*[adam_scalars(cfg, state.step + 1 + i)
                           for i in range(len(batches))])
        staged = self._stage(batches, hosts)
        try:
            for i in range(len(batches)):
                step = state.step + 1
                before = state.generator.get_state() if self.split else None
                state.generator.manual_seed(step_seed(cfg.seed, step,
                                                      self.rank))
                self.flat.copy_(staged[i])
                self._replay(0)
                if self.split:
                    try:
                        raise_if_not_finite(self.flags, step)
                    except FloatingPointError:
                        state.generator.set_state(before)
                        raise
                    self._replay(1)
                state.step = step
        finally:
            # Replays do not bump ``_version``: bump it, so that caches
            # keyed on it (``eval.make_render_fn``) see the update.
            for t in state_tensors(state):
                torch.autograd.graph.increment_version(t)
        return state, Stats(*[t.clone() for t in self.out],
                            learning_rate=lrs[-1])


def make_multi_step(cfg: Config, mlp_apply=None, group=None):
    """fn(state, batches) -> (state, Stats of the last step): the train
    step over a list of (rays, pixels) batches (numpy arrays or tensors),
    in order, as the JAX package's ``make_jitted_multi_step`` runs K steps
    as one device program.

    On the card every step is a replay of one step captured in a CUDA graph
    (``_CapturedStep``), bit-equal to the eager step: the same body on the
    same inputs. A new batch shape captures a new graph; a state whose
    tensors or generator are not the captured ones (a restore) captures
    again. On the CPU the steps run eagerly. As in the JAX package,
    ``check_numerics`` does not check the multi-step; ``debug_nans`` checks
    each of its steps. ``multi_step.captured``: the graphs by batch shape.
    ``group``: as in ``make_train_step``; on the card only a NCCL group,
    whose all-reduces the graph captures (gloo's run on the host).
    """
    cfg = cfg.replace(check_numerics=False)
    step_fn = make_train_step(cfg, mlp_apply=mlp_apply, group=group)
    captured = {}

    def multi_step(state: TrainState, batches):
        device = state.params[0][0].device
        if device.type == "cuda" and group is not None and (
                dist.get_backend(group) != "nccl"):
            raise ValueError("a CUDA graph captures NCCL's collectives, not "
                             f"{dist.get_backend(group)}'s")
        if device.type != "cuda":
            stats = None
            for rays, pixels in batches:
                state, stats = step_fn(state,
                                       *batch_to_device(device, rays, pixels))
            return state, stats
        if any(not c.holds(state) for c in captured.values()):
            captured.clear()
        shape = _batch_shape(batches[0])
        if shape not in captured:
            captured[shape] = _CapturedStep(cfg, mlp_apply, state, batches[0],
                                            group)
        return captured[shape].run(state, batches)

    multi_step.captured = captured
    return multi_step
