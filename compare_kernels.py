#!/usr/bin/env python3
"""Time versions of a forward CUDA kernel (render_level or mlp_fwd) on one
card, in turns.

    git show <commit>:nerf_or_nothing_tpu_torch/csrc/render_level.cu > old.cu
    python3 compare_kernels.py old.cu [other.cu ...]
    python3 compare_kernels.py --kernel=mlp_fwd old_mlp_fwd.cu

With one source, the checkout's ``csrc/<kernel>.cu`` is the second. All
must keep the C interface (``render_level_launch`` / ``mlp_fwd_launch``).
Each version reads the weight layout it declares: a library that exports
``<kernel>_weight_layout`` reads ``pack_params_wg``'s slab stream in bf16,
one that does not (the earlier ``mma.sync`` versions) ``pack_params``'
fragments; f32 reads
``pack_params``' row-major layout in every version. Each is built by
``kernels/build.py`` with the package's nvcc flags, launched through
``render_level_cuda`` / ``mlp_fwd_cuda`` with ``source=...``, checked
against the plain version (as a fraction of the band), and timed by CUDA
events in the order given and then in reverse (median of 7 launches each)
on Config() shapes: render_level bf16 R=16384 x S=128 mode "mv" (the
render path's launch), bf16 R=1000 x S=64 mode "t", f32 R=2048 x S=128;
mlp_fwd bf16 R=16384 x S=128 (a render chunk) and R=1024 x S=128 (a train
level), f32 R=2048 x S=128. Prints one JSON line per build and case; a
source's name is its file name without the suffix.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = ("render_level", "mlp_fwd")


def packs_by_layout(params, cfg):
    """The forward weights in both layouts the versions may read."""
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype

    dt = compute_dtype(cfg)
    return {"wg": fl.pack_forward(params, cfg, dt),
            "fwd": fl.pack_params(params, cfg, dt)}


def layouts(kernel: str, sources: dict) -> dict:
    """Build each version; its weight layout by name."""
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl

    out = {}
    for name, src in sources.items():
        out[name] = fl.weight_layout(build.load(kernel, src), kernel)
    return out


def cases(kernel: str):
    """(case, Config, R, mode, white_bkgd) of ``kernel``'s timed shapes."""
    from nerf_or_nothing_tpu_torch.config import Config

    if kernel == "render_level":
        return [("bf16_r16384_s128_mv", Config(), 16384, "mv", True),
                ("bf16_r1000_s64_t", Config(num_samples=64), 1000, "t", False),
                ("f32_r2048_s128_mv", Config(compute_dtype="float32"), 2048,
                 "mv", True)]
    return [("bf16_r16384_s128", Config(), 16384, "t", None),
            ("bf16_r1024_s128", Config(), 1024, "t", None),
            ("f32_r2048_s128", Config(compute_dtype="float32"), 2048, "t",
             None)]


def in_turns(kernel: str, sources: dict, case, device, seed: int = 0):
    """Check each version against the plain version and time them in the
    order given, then in reverse. Returns the case's record."""
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp

    name_, cfg, R, mode, white_bkgd = case
    kinds = layouts(kernel, sources)
    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=device)
    xs, d, delta = cs.level_inputs(cfg, R, mode, seed + 1, device)
    packs = packs_by_layout(params, cfg)
    if kernel == "render_level":
        ref = fl.render_level_plain(params, cfg, xs, d, delta, white_bkgd,
                                    mode)

        def run(name):
            return fl.render_level_cuda(params, cfg, xs, d, delta, white_bkgd,
                                        mode, packed=packs[kinds[name]],
                                        source=sources[name])
    else:
        ref = fm.mlp_fwd_plain(params, cfg, xs, d, cfg.num_samples)

        def run(name):
            return fm.mlp_fwd_cuda(params, cfg, xs, d,
                                   packed=packs[kinds[name]],
                                   source=sources[name])

    atol, rtol = cs.BANDS[cfg.compute_dtype]
    names = list(sources)
    res = {"kernel": kernel, "case": name_, "R": R, "S": cfg.num_samples,
           "layouts": kinds}
    for name in names:
        out = run(name)
        torch.cuda.synchronize()
        res[f"{name}_err"] = max(cs.normalized_err(a, b, atol, rtol)
                                 for a, b in zip(out, ref))
    for turn, name in enumerate(names + names[::-1]):
        res[f"{name}_ms_{turn}"] = cs.median_ms(lambda: run(name))
    return res


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    from nerf_or_nothing_tpu_torch.kernels import build

    kernel = "render_level"
    args = []
    for a in argv:
        if a.startswith("--kernel="):
            kernel = a.split("=", 1)[1]
        else:
            args.append(a)
    if kernel not in KERNELS:
        raise SystemExit(f"--kernel must be one of {KERNELS}")
    srcs = [Path(a).resolve() for a in args]
    if len(srcs) == 1:
        srcs.append(build.source_path(kernel))
    names = [src.stem for src in srcs]
    if len(set(names)) != len(names):
        raise SystemExit(f"sources need distinct file names: {names}")
    sources = dict(zip(names, srcs))
    for name, kind in layouts(kernel, sources).items():
        log = build.BUILD_INFO[str(sources[name])]["log"]
        cs.emit({"build": name, "source": str(sources[name]), "layout": kind,
                 "ptxas": [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]})
    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda")
    for case in cases(kernel):
        cs.emit(in_turns(kernel, sources, case, device))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
