#!/usr/bin/env python3
"""Time versions of the render-level CUDA kernel on one card, in turns.

    git show <commit>:nerf_or_nothing_tpu_torch/csrc/render_level.cu > old.cu
    python3 compare_kernels.py old.cu [other.cu ...]

With one source, the checkout's ``csrc/render_level.cu`` is the second.
All must keep the C interface ``render_level_launch`` and the weight
layout of ``pack_params``. Each is built by ``kernels/build.py`` with the
package's nvcc flags, launched through ``render_level_cuda(source=...)``,
checked against ``render_level_plain`` (as a fraction of the band), and
timed by CUDA events in the order given and then in reverse (median of 7
launches each) on Config() shapes: bf16 R=16384 x S=128 mode "mv" (the
render path's launch), bf16 R=1000 x S=64 mode "t", f32 R=2048 x S=128.
Prints one JSON line per build and case; a source's name is its file name
without the suffix.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke as cs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, init_mlp

    srcs = [Path(a).resolve() for a in argv]
    if len(srcs) == 1:
        srcs.append(build.source_path("render_level"))
    names = [src.stem for src in srcs]
    if len(set(names)) != len(names):
        raise SystemExit(f"sources need distinct file names: {names}")
    sources = dict(zip(names, srcs))
    for name, src in sources.items():
        build.load("render_level", src)
        log = build.BUILD_INFO[str(src)]["log"]
        cs.emit({"build": name, "source": str(src),
                 "ptxas": [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]})
    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda")
    cases = [
        ("bf16_r16384_s128_mv", Config(), 16384, "mv", True),
        ("bf16_r1000_s64_t", Config(num_samples=64), 1000, "t", False),
        ("f32_r2048_s128_mv", Config(compute_dtype="float32"), 2048, "mv",
         True),
    ]
    for case, cfg, R, mode, white_bkgd in cases:
        params = init_mlp(torch.Generator().manual_seed(0), cfg, device=device)
        xs, d, delta = cs.level_inputs(cfg, R, mode, 1, device)
        packed = fl.pack_params(params, cfg, compute_dtype(cfg))
        ref = fl.render_level_plain(params, cfg, xs, d, delta, white_bkgd,
                                    mode)
        atol, rtol = cs.BANDS[cfg.compute_dtype]

        def run(name):
            return fl.render_level_cuda(params, cfg, xs, d, delta, white_bkgd,
                                        mode, packed=packed,
                                        source=sources[name])

        res = {"case": case}
        for name in names:
            out = run(name)
            torch.cuda.synchronize()
            res[f"{name}_err"] = max(cs.normalized_err(a, b, atol, rtol)
                                     for a, b in zip(out, ref))
        for turn, name in enumerate(names + names[::-1]):
            res[f"{name}_ms_{turn}"] = cs.median_ms(lambda: run(name))
        cs.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
