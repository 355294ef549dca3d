#!/usr/bin/env python3
"""Where the bf16 wgmma forward (``csrc/forward_wg.cuh``) spends its time on
one card: a copy of ``render_level`` / ``mlp_fwd`` built with
``FORWARD_WG_PHASES`` defined, whose consumer threads 0 and 128 and first
helper thread add the ``clock64()`` cycles of each phase to a table.

    python3 profile_forward.py

Runs each kernel once at Config() shapes (render_level bf16 R=16384 x
S=128 mode "mv", mlp_fwd bf16 R=16384 x S=128), after the plain build's
time as a reference, and prints one JSON line per kernel: the phase shares
of a consumer's cycles (waits for weight slabs, the layer products, the
epilogues, the heads, the waits for the helpers' feature tiles and for a
free heads buffer) and of a helper's (direction term, features,
composite, waits), the SM clock the cycles imply (cycles over the
``%globaltimer`` nanoseconds), and the card's clocks and power under a
sustained load of the plain build (``nvidia-smi``). The counters add a
load, an add and a store per phase, so the instrumented launch is slower
than the plain one; the shares are what it is for.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
import time

CONSUMER = ("total", "slab_wait", "heads", "x_ready_wait", "epilogue",
            "layer_products", "out_empty_wait")
HELPER = ("total", None, "direction_term", "x_free_wait", "features",
          "out_full_wait", "composite")
SLOTS = 256 * 3 * 8  # forward_wg.cuh: wg_phases[block][role][phase]


def instrumented_source(kernel: str):
    """A source that defines FORWARD_WG_PHASES, includes the checkout's
    kernel and exports the table's reset and read."""
    from nerf_or_nothing_tpu_torch.kernels import build

    path = build.BUILD_DIR / f"{kernel}_phases.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "#define FORWARD_WG_PHASES\n"
        f'#include "{build.source_path(kernel)}"\n'
        'extern "C" int wg_phases_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, wg_phases, sizeof(wg_phases));\n"
        "}\n"
        'extern "C" int wg_phases_reset() {\n'
        f"  static unsigned long long zero[{SLOTS}];\n"
        "  return (int)cudaMemcpyToSymbol(wg_phases, zero, sizeof(zero));\n"
        "}\n")
    return path


def clocks_under_load(run, seconds: float = 2.0):
    """nvidia-smi's SM clock, power and temperature while ``run`` loops."""
    import torch

    samples, stop = [], time.time() + seconds

    def sample():
        while time.time() < stop:
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
            time.sleep(0.25)

    th = threading.Thread(target=sample)
    th.start()
    while time.time() < stop:
        run()
        torch.cuda.synchronize()
    th.join()
    return samples[-3:]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, init_mlp

    kernels = ("render_level", "mlp_fwd")
    sources = {k: instrumented_source(k) for k in kernels}
    build.build_all(build.SOURCES, list(sources.items()))
    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda")
    cfg = Config()
    R = 16384
    params = init_mlp(torch.Generator().manual_seed(0), cfg, device=device)
    packed = fl.pack_forward(params, cfg, compute_dtype(cfg))
    for kernel in kernels:
        mode = "mv" if kernel == "render_level" else "t"
        xs, d, delta = cs.level_inputs(cfg, R, mode, 1, device)

        def run(source=None):
            if kernel == "render_level":
                return fl.render_level_cuda(params, cfg, xs, d, delta, True,
                                            mode, packed=packed, source=source)
            return fm.mlp_fwd_cuda(params, cfg, xs, d, packed=packed,
                                   source=source)

        plain_ms = cs.median_ms(run)
        load = clocks_under_load(run)
        lib = build.load(kernel, sources[kernel])
        run(sources[kernel])
        torch.cuda.synchronize()
        lib.wg_phases_reset()
        t = cs.median_ms(lambda: run(sources[kernel]), reps=1, warmup=0)
        buf = (ctypes.c_ulonglong * SLOTS)()
        lib.wg_phases_read(buf)
        table = np.array(buf, dtype=np.float64).reshape(256, 3, 8)
        used = table[:, 0, 0] > 0
        cons = table[used, :2].reshape(-1, 8).mean(0)
        helper = table[used, 2].mean(0)
        print(json.dumps({
            "kernel": kernel, "R": R, "S": cfg.num_samples, "mode": mode,
            "ms": plain_ms, "ms_instrumented": t, "blocks": int(used.sum()),
            "sm_ghz_from_cycles": cons[0] / cons[7],
            "consumer_share": {n: cons[i] / cons[0]
                               for i, n in enumerate(CONSUMER)},
            "helper_share": {n: helper[i] / cons[0]
                             for i, n in enumerate(HELPER) if n},
            "clocks_power_temp_under_load": load,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
