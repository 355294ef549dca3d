"""Configuration for the PyTorch/CUDA MipNeRF port.

Field-for-field the same frozen dataclass as ``nerf_or_nothing_tpu.config``
(same names, types and defaults), so one set of flags drives either
package. The execution fields keep their names. On CUDA tensors they select
the hand-written kernels (the CPU runs each kernel's plain version):

- ``use_pallas``: use the kernels at all; off, the plain ``apply_mlp``
  and autograd run everywhere;
- ``fuse_level`` (with ``use_pallas``): a whole level in one kernel call:
  ``render_level`` (``kernels/fused_level.py``) for eval and render, and
  ``train_level`` per level of a train step when ``stop_level_grad`` is
  also on and the heads are 3 rgb / 1 density. Off, every level's MLP is
  ``fused_mlp_apply`` (``kernels/fused_mlp.py``): the ``mlp_fwd`` kernel,
  and ``mlp_bwd`` for its gradient;
- ``stop_level_grad``: off, the fine level's loss also reaches the coarse
  level's weights through resampling, so the train step takes the autograd
  branch, whose levels run ``mlp_fwd`` / ``mlp_bwd`` (the fine level's
  ``mlp_bwd`` with dX and dD);
- ``fuse_ipe`` / ``fuse_ipe_render``: compute the IPE inside the train /
  render kernel (input mode ``"mv"``);
- ``pair_ipe`` / ``xt_ipe``: the JAX package's transposed feature layouts
  for its TPU kernel; the port computes the same features in the
  interleaved layout and the kernels' mode ``"t"``;
- ``steps_per_call``: K train steps a call; on the card each a replay of
  one captured CUDA graph of the step (``train.make_multi_step``);
- ``profile_dir``, ``check_numerics``, ``debug_nans``: a ``torch.profiler``
  trace of steps 11-20, and a finite check of the loss and gradients
  before the update (of single steps, or of every step);
- ``mesh_shape``: ``(N,)`` trains data-parallel on N ranks, one process
  a device (``parallel/mesh.py``; ``run train`` spawns them); ``()`` takes
  every card of the host for an unindexed ``cuda``; ``(DP, MP)`` trains
  tensor-parallel on DP x MP ranks (``mesh.make_tensor_parallel_train_step``,
  the plain MLP as in JAX); three or more axes raise ``ValueError``;
- ``kernel_probes`` (comma-separated ``key=value`` entries, read by
  ``probe``): ``fl_variant=twopass`` runs each train level as
  ``train_level_twopass`` (``kernels/fused_level.py``) where the JAX package
  takes ``_level_kernel_twopass``: the fused-level train branch in input
  mode ``"t"`` (with ``fuse_ipe``, mode ``"mv"``, the level stays
  ``train_level``). The values with which the JAX kernels compute filler
  values or round dW to bf16 (``FILLER_PROBES``) raise
  ``NotImplementedError`` where a kernel would read them. The TPU tile,
  interleave and schedule knobs (``fl_tile``, ``fl_il``, ``fr_tile``,
  ``fr_il``, ``fm_acc``, ``fl_comp``, ``fm_heads``,
  ``fm_bwd=phased|phasedbar|accper``, ``fl_enc``) leave the function as it
  is and have no effect on the card;
- ``donate_params``, ``remat``: kept for flag compatibility; the port does
  not read them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence

# kernel_probes values with which the JAX kernels compute something other
# than the level's function: filler values for timing attribution
# (fused_level.py, fused_mlp.py) or dW accumulated in bf16.
FILLER_PROBES = {
    "fl_variant": ("nobwd", "nocomp"),
    "fm_bwd": ("nodw", "nogchain", "bf16acc"),
}


class RayShape(enum.Enum):
    """Shape of the cast ray volume."""

    CONE = "cone"
    CYLINDER = "cylinder"


class DatasetType(enum.Enum):
    """Dataset loader selector."""

    BLENDER = "blender"
    LLFF = "llff"
    MULTICAM = "multicam"
    BIN = "bin"  # preprocessed 64-byte ray records


@dataclasses.dataclass(frozen=True)
class Config:
    """All training / model / data hyperparameters."""

    # ---- data ----
    dataset_loader: DatasetType = DatasetType.BLENDER
    data_dir: str = ""
    batch_size: int = 1024
    factor: int = 0
    spherify: bool = False
    render_path: bool = False
    llff_hold: int = 8
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True

    # ---- optimization ----
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    grad_max_norm: float = 0.0
    grad_max_val: float = 0.0
    max_steps: int = 1_000_000
    save_every: int = 100_000
    print_every: int = 100
    gc_every: int = 10_000
    test_render_interval: int = 100_000
    steps_per_call: int = 1
    disable_multiscale_loss: bool = False
    randomized: bool = True
    coarse_loss_mult: float = 0.1
    weight_decay_mult: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8

    # ---- model ----
    num_samples: int = 128
    num_levels: int = 2
    resample_padding: float = 0.01
    stop_level_grad: bool = True
    lin_disp: bool = False
    ray_shape: RayShape = RayShape.CONE
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    diag_covariance: bool = True
    use_viewdirs: bool = True

    # ---- MLP architecture ----
    net_depth: int = 8
    net_width: int = 256
    net_depth_condition: int = 1
    net_width_condition: int = 128
    skip_layer: int = 4
    num_rgb_channels: int = 3
    num_density_channels: int = 1

    # ---- execution ----
    use_pallas: bool = True         # hand-written CUDA kernels on the hot path
    fuse_level: bool = True         # whole level in one kernel, else the MLP kernels
    fuse_ipe: bool = False          # IPE inside the level kernel (train path)
    fast_ipe: bool = True           # polynomial sin/cos/exp (ops/fastmath.py)
    pair_ipe: bool = False          # TPU layout probe: same features, mode "t"
    xt_ipe: bool = False            # TPU layout probe: same features, mode "t"
    fuse_ipe_render: bool = True    # IPE inside the render kernel (mode "mv")
    debug_nans: bool = False
    check_numerics: bool = False
    compute_dtype: str = "bfloat16"  # tensor-core operands; accumulation f32
    mesh_shape: Sequence[int] = ()
    donate_params: bool = True
    remat: bool = False

    # ---- eval / render ----
    render_chunk_size: int = 16384
    linear_color: bool = False

    # ---- checkpointing ----
    checkpoint_dir: str = ""
    resume: bool = True

    # ---- tracing / profiling ----
    profile_dir: str = ""
    kernel_probes: str = ""

    seed: int = 0

    # ------------------------------------------------------------------
    @property
    def num_location_encodings(self) -> int:
        return 2 * (self.max_deg_point - self.min_deg_point)

    @property
    def num_direction_encodings(self) -> int:
        return 2 * self.deg_view + 1

    @property
    def location_features(self) -> int:
        return 3 * self.num_location_encodings  # 96 at defaults

    @property
    def direction_features(self) -> int:
        return 3 * self.num_direction_encodings  # 27 at defaults

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def probe(self, key: str, default: str = "") -> str:
        """Look up one ``kernel_probes`` entry."""
        for item in self.kernel_probes.split(","):
            k, _, v = item.partition("=")
            if k.strip() == key:
                return v.strip()
        return default

    def check_probes(self, *keys: str) -> None:
        """Raise NotImplementedError for a ``FILLER_PROBES`` value under
        ``keys``: the port has no kernel that computes those values, and
        does not compute the true function in their place."""
        for key in keys:
            value = self.probe(key)
            if value in FILLER_PROBES.get(key, ()):
                raise NotImplementedError(
                    f"kernel_probes {key}={value} makes the JAX kernels "
                    "compute attribution fillers or bf16 dW in place of "
                    "the gradients; the port does not (ROADMAP section C)")


def tiny_config(**overrides: Any) -> Config:
    """Tiny MipNeRF (4x128), coarse-only 64 samples."""
    base = dict(
        net_depth=4,
        net_width=128,
        net_width_condition=64,
        num_samples=64,
        num_levels=1,
        max_deg_point=8,
        batch_size=256,
        use_pallas=False,
    )
    base.update(overrides)
    return Config(**base)


def full_config(**overrides: Any) -> Config:
    """Full hierarchical MipNeRF (8x256, 128+128)."""
    return Config(**overrides)


_FLAG_ALIASES = {
    "datasetloader": "dataset_loader",
    "datadir": "data_dir",
    "batchsize": "batch_size",
    "llffhold": "llff_hold",
    "lrinit": "lr_init",
    "lrfinal": "lr_final",
    "lrdelaysteps": "lr_delay_steps",
    "lrdelaymult": "lr_delay_mult",
    "gradmaxnorm": "grad_max_norm",
    "gradmaxval": "grad_max_val",
    "maxsteps": "max_steps",
    "saveevery": "save_every",
    "printevery": "print_every",
    "gcevery": "gc_every",
    "testrenderinterval": "test_render_interval",
    "disablemultiscaleloss": "disable_multiscale_loss",
    "coarselossmult": "coarse_loss_mult",
    "weightdecaymult": "weight_decay_mult",
    "whitebkgd": "white_bkgd",
}


def parse_flags(argv: Sequence[str], base: Config | None = None) -> Config:
    """``--key=value`` CLI overrides onto a base config."""
    cfg = base or Config()
    fields = {f.name: f for f in dataclasses.fields(Config)}
    updates: dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        key, _, value = arg[2:].partition("=")
        key = key.replace("-", "_").lower()
        key = _FLAG_ALIASES.get(key.replace("_", ""), key)
        if key not in fields:
            raise ValueError(f"unknown flag --{key}")
        f = fields[key]
        if f.type in ("int", int):
            updates[key] = int(value)
        elif f.type in ("float", float):
            updates[key] = float(value)
        elif f.type in ("bool", bool):
            updates[key] = value.lower() in ("1", "true", "yes")
        elif key == "dataset_loader":
            updates[key] = DatasetType(value.lower())
        elif key == "ray_shape":
            updates[key] = RayShape(value.lower())
        elif key == "mesh_shape":
            updates[key] = tuple(int(v) for v in value.split(",") if v)
        else:
            updates[key] = value
    return cfg.replace(**updates)
