#!/usr/bin/env python3
"""Time versions of a CUDA kernel (render_level, mlp_fwd, train_level,
train_level_twopass or mlp_bwd) on one card, in turns.

    git show <commit>:nerf_or_nothing_tpu_torch/csrc/render_level.cu > old.cu
    python3 compare_kernels.py old.cu [other.cu ...]
    # a version that needs its commit's headers takes them beside it:
    # chip_smoke.mma_sources() writes the mma.sync versions so
    # (.local_runs/mma_sync/)
    python3 compare_kernels.py --kernel=mlp_fwd old_mlp_fwd.cu
    python3 compare_kernels.py --kernel=train_level old_train_level.cu
    python3 compare_kernels.py --kernel=train_level_twopass --profile old.cu
    python3 compare_kernels.py --kernel=mlp_bwd --profile old_mlp_bwd.cu

With one source, the checkout's ``csrc/<kernel>.cu`` is the second. All
must keep the C interface (``<kernel>_launch``). Each version reads the
weight layout it declares (``fused_level.weight_layout``): a library
whose ``<kernel>_weight_layout`` returns ``"wg"`` or ``"wf"`` reads the
bf16 slab streams (``pack_forward``; ``pack_train_level``, which adds the
g-chain's stream; ``pack_mlp_params``, whose chain stream holds the x
rows), one that exports none (the earlier ``mma.sync`` versions)
``pack_params``' fragments (and ``pack_params_t``'s for the train kernels
and mlp_bwd, ``pack_params_tx``'s for mlp_bwd); f32 reads the row-major
layouts in every version but on the wide route of ``"wf"`` (the 3xTF32
``wgmma`` GEMM), which reads the hi / lo slab streams
(``pack_params_wf``, ``_wft``, ``_wfx``). Each is built by
``kernels/build.py`` with the package's nvcc flags, launched through
``render_level_cuda`` / ``mlp_fwd_cuda`` / ``train_level_cuda`` /
``train_level_twopass_cuda`` / ``mlp_bwd_cuda`` with ``source=...``,
checked against the plain version (as a fraction of the band; the
backward kernels also for bit-equal outputs over two launches), and timed
by CUDA events in the order given and then in reverse (median of 7
launches each, the card's SM clock and power draw read after each) on
Config() shapes: render_level bf16 R=16384 x S=128 mode "mv" (the render
path's launch), bf16 R=1000 x S=64 mode "t", f32 R=16384 x S=128;
mlp_fwd bf16 R=16384 x S=128 (a render chunk) and R=1024 x S=128 (a train
level), f32 R=16384 x S=128; train_level and train_level_twopass bf16
R=1024 x S=128 mode "t" (a train step's level), R=777 with Multicam's
loss weights (1/4/16/64, every seventh ray masked), f32 R=1024 x S=128,
and both dtypes at net_width 1024 (the wide route) R=1024 x S=128;
mlp_bwd bf16 R=1024 x S=128 with input_grads (level 1 of the slice
config) and without (level 0), f32 with input_grads, and both dtypes
with input_grads at net_width 1024; and render_level / mlp_fwd at net_width 1024, bf16 R=16384 and f32
R=4096 (``chip_smoke.WIDE_F32_RAYS``).
Prints one JSON line per build and case; a source's name is its file name
without the suffix. With ``--profile``, each case also gives every
version's device time per launch by kernel name (``torch.profiler``, 5
calls).

    mkdir -p .local_runs/parent && for f in $(git ls-tree --name-only \
        HEAD~1 nerf_or_nothing_tpu_torch/csrc/); do
      git show HEAD~1:$f > .local_runs/parent/$(basename $f); done
    python3 compare_kernels.py --ptxas .local_runs/parent

builds every kernel source (``build.SOURCES``) from that directory (its
headers beside it) and from ``csrc/``, all at once, and prints for each
source the kernels (by name and template arguments) whose ptxas lines
(registers, spills, injected or serialized wgmma) are the same in both,
those that differ, and those in one build only with their lines
(ptxas's line numbers and symbols taken out); no card is needed.

    mkdir -p .local_runs/parent && git archive HEAD~1 | tar -x -C .local_runs/parent
    python3 compare_kernels.py --digest new.json
    (cd .local_runs/parent && PYTHONPATH=. python3 -P ../../compare_kernels.py \
        --digest ../../old.json)
    python3 compare_kernels.py --same old.json new.json

    python3 compare_kernels.py --gemm [old/wide_gemm.cu | old/wide_gemm_f32.cu]

times the wide routes' layer GEMMs alone (``kernels/wide_gemm.py``), the
checkout's against another version's, in turns and against the plain
version: the bf16 GEMM at ``chip_smoke.GEMM_CASES``, bit-equal
(``chip_smoke.gemm_phase``; ``csrc/wide_gemm.cu`` copied beside the other
version's headers; default ``chip_smoke.gemm_sources()``, the ``csrc/``
of ``chip_smoke.GEMM_COMMIT``, whose wide kernels are then timed against
the checkout's too), and the f32 GEMM at ``chip_smoke.F32_GEMM_CASES``
(``chip_smoke.f32_gemm_phase``: ``csrc/wide_gemm_f32.cu``; default
``chip_smoke.f32_gemm_sources()``, ``F32_GEMM_COMMIT``'s ``mma.sync``
GEMM and its ``render_level``, bit-equality recorded), with the ptxas
lines of every build's f32 instantiations, and the dW GEMMs alone in both
dtypes (``chip_smoke.dw_cases``: ``csrc/wide_dw.cu`` beside
``chip_smoke.dw_sources()``, the ``csrc/`` of ``chip_smoke.DW_COMMIT``),
bit-equal, in turns. A path times the GEMM its file name names.

    python3 compare_kernels.py --dw-levels

times ``train_level`` (bf16 and f32 at net_width 288, 512, 1024 and 2048,
and at Config()), ``train_level_twopass`` and ``mlp_bwd`` (W = 1024, both
dtypes) against the versions of ``chip_smoke.DW_COMMIT`` (the dW GEMMs
writing split partials; ``chip_smoke.dw_sources``' copy of its
``csrc/``), in turns with each one's device time by kernel
(``in_turns``), and checks each case's dW bit-equal to that version's, and
its db bit-equal (f32) or its error against it as a fraction of the
dtype's band (bf16, whose db the dW kernel now sums over other row
chunks).

``--digest`` writes the SHA-256 of every output of the five kernels and of
every packed weight tensor (``pack_forward``, ``pack_train_level``,
``pack_mlp_params``) on seeded inputs (``chip_smoke``'s, R=1024 x S=128:
``render_level`` mode "mv", ``train_level`` mode "t",
``train_level_twopass``, ``mlp_fwd``, ``mlp_bwd`` with input_grads) at
``DIGEST_CONFIGS``, through the package on ``sys.path`` (``-P`` keeps
this script's directory off it, so the run above reads the other
checkout's package and ``chip_smoke``); ``--same`` prints the entries
that differ between two such files and exits 1 if any does (``--same
old.json new.json --allow REGEX``: but those whose key matches REGEX,
listed apart; ``BF16_DB_DIGESTS`` names the db that the bf16 dW kernel's
column sums changed).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = ("render_level", "mlp_fwd", "train_level", "train_level_twopass",
           "mlp_bwd")
TRAIN = ("train_level", "train_level_twopass")


LAYOUTS = ("wf", "wg", "fwd")  # fused_level.weight_layout's values


def packs_by_layout(kernel, params, cfg, kinds=LAYOUTS):
    """The weights in each layout of ``kinds`` that the versions of
    ``kernel`` may read."""
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype

    dt = compute_dtype(cfg)
    if kernel in TRAIN:
        return {k: fl.pack_train_level(params, cfg, dt, k) for k in kinds}
    if kernel == "mlp_bwd":
        return {k: fm.pack_mlp_params(params, cfg, dt, layout=k)
                for k in kinds}
    return {k: fl.pack_params(params, cfg, dt) if k == "fwd"
            else fl.pack_forward(params, cfg, dt, k) for k in kinds}


def layouts(kernel: str, sources: dict) -> dict:
    """Build each version; its weight layout by name."""
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl

    out = {}
    for name, src in sources.items():
        out[name] = fl.weight_layout(build.load(kernel, src), kernel)
    return out


def cases(kernel: str):
    """(case, Config, R, mode, flag, multicam) of ``kernel``'s timed shapes:
    ``flag`` is white_bkgd for the level kernels and input_grads for
    mlp_bwd; ``multicam``: the train kernels' g_scale (``chip_smoke.
    train_inputs``)."""
    from nerf_or_nothing_tpu_torch.config import Config

    f32 = Config(compute_dtype="float32")
    if kernel == "mlp_bwd":
        return [("bf16_r1024_s128_dx", Config(), 1024, "t", True, False),
                ("bf16_r1024_s128", Config(), 1024, "t", False, False),
                ("f32_r1024_s128_dx", f32, 1024, "t", True, False),
                ("f32_w1024_r1024_s128_dx", f32.replace(net_width=1024),
                 1024, "t", True, False),
                ("bf16_w1024_r1024_s128_dx", Config(net_width=1024), 1024,
                 "t", True, False)]
    if kernel in TRAIN:
        return [("bf16_r1024_s128_t", Config(), 1024, "t", True, False),
                ("bf16_r777_s128_t_multicam", Config(), 777, "t", False,
                 True),
                ("f32_r1024_s128_t", f32, 1024, "t", True, False),
                ("bf16_w1024_r1024_s128_t", Config(net_width=1024), 1024,
                 "t", True, False),
                ("f32_w1024_r1024_s128_t", f32.replace(net_width=1024), 1024,
                 "t", True, False)]
    w1024 = Config(net_width=1024)
    if kernel == "render_level":
        return [("bf16_r16384_s128_mv", Config(), 16384, "mv", True, False),
                ("bf16_r1000_s64_t", Config(num_samples=64), 1000, "t", False,
                 False),
                ("f32_r16384_s128_mv", f32, 16384, "mv", True, False),
                ("bf16_w1024_r16384_s128_mv", w1024, 16384, "mv", True,
                 False),
                ("f32_w1024_r4096_s128_mv", f32.replace(net_width=1024), 4096,
                 "mv", True, False)]
    return [("bf16_r16384_s128", Config(), 16384, "t", None, False),
            ("bf16_r1024_s128", Config(), 1024, "t", None, False),
            ("f32_r16384_s128", f32, 16384, "t", None, False),
            ("bf16_w1024_r16384_s128", w1024, 16384, "t", None, False),
            ("f32_w1024_r4096_s128", f32.replace(net_width=1024), 4096, "t",
             None, False)]


# The configs of --digest: Config() in bf16 and f32, a narrow width, the
# wide routes at 288 (a partial column block), 512, 1024 and 2048, 66
# layers (bf16: the wide route) and depth 20 (f32), location features of
# degree 70, and heads of 17 / 33 channels on the wide route (the MLP
# kernels alone: DIGEST_KERNELS).
DIGEST_CONFIGS = {
    "config_bf16": {},
    "config_f32": {"compute_dtype": "float32"},
    "64_32_bf16": {"net_width": 64, "net_width_condition": 32},
    "64_32_f32": {"net_width": 64, "net_width_condition": 32,
                  "compute_dtype": "float32"},
    **{f"w{w}_{t}": {"net_width": w, "compute_dtype": dt}
       for w in (288, 512, 1024, 2048)
       for t, dt in (("bf16", "bfloat16"), ("f32", "float32"))},
    "layers66_bf16": {"net_depth": 63, "net_depth_condition": 1},
    "depth20_f32": {"net_depth": 20, "compute_dtype": "float32"},
    **{f"deg70_{t}": {"max_deg_point": 70, "fast_ipe": False,
                      "compute_dtype": dt}
       for t, dt in (("bf16", "bfloat16"), ("f32", "float32"))},
    **{f"heads_17_33_288_64_{t}": {
        "net_width": 288, "net_width_condition": 64,
        "num_rgb_channels": 17, "num_density_channels": 33,
        "compute_dtype": dt}
       for t, dt in (("bf16", "bfloat16"), ("f32", "float32"))},
}
# The kernels of a --digest config that the level kernels do not take
DIGEST_KERNELS = {f"heads_17_33_288_64_{t}": ("mlp_fwd", "mlp_bwd")
                  for t in ("bf16", "f32")}
# The digests that the dW GEMMs' bf16 db changed (the column sums of the
# dW splits in row order, then in split order, in place of 2,048-row
# chunks): db of every layer (index 1 of a layer's pair) of the bf16
# configs on the wide route, which --same --allow takes as allowed
BF16_DB_DIGESTS = (r"^(w\d+|layers66|deg70|heads_17_33_288_64)_bf16\."
                   r"(train_level(_twopass)?\.3|mlp_bwd\.0)\.\d+\.1$")


def digests(obj, key: str, out: dict) -> None:
    """SHA-256 of every tensor in ``obj`` (nested tuples and lists) under
    ``key`` and its index path; bf16 as its bits."""
    import hashlib

    import torch

    if isinstance(obj, (tuple, list)):
        for i, t in enumerate(obj):
            digests(t, f"{key}.{i}", out)
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[key] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def digest(path: str) -> int:
    """Write ``--digest``'s file (see the module docstring)."""
    import torch

    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, init_mlp

    build.build_all(build.SOURCES)
    device = torch.device("cuda")
    R, out = 1024, {}
    for name, kw in DIGEST_CONFIGS.items():
        cfg = Config(**kw)
        dt = compute_dtype(cfg)
        params = init_mlp(torch.Generator().manual_seed(7), cfg,
                          device=device)
        digests(fl.pack_forward(params, cfg, dt), f"{name}.pack_forward", out)
        digests(fl.pack_train_level(params, cfg, dt),
                f"{name}.pack_train_level", out)
        digests(fm.pack_mlp_params(params, cfg, dt),
                f"{name}.pack_mlp_params", out)
        mv, d, delta = cs.level_inputs(cfg, R, "mv", 8, device)
        xs, _, _ = cs.level_inputs(cfg, R, "t", 8, device)
        pixels, g_scale = cs.train_inputs(cfg, R, 9, device)
        _, x, dm, g_rgb, g_den = cs.mlp_case_inputs(cfg, R, 10, device)
        runs = {
            "render_level": lambda: fl.render_level_cuda(
                params, cfg, mv, d, delta, True, "mv"),
            "train_level": lambda: fl.train_level_cuda(
                params, cfg, xs, d, delta, pixels, g_scale, True, "t"),
            "train_level_twopass": lambda: fl.train_level_twopass_cuda(
                params, cfg, xs, d, delta, pixels, g_scale, True),
            "mlp_fwd": lambda: fm.mlp_fwd_cuda(params, cfg, x, dm),
            "mlp_bwd": lambda: fm.mlp_bwd_cuda(params, cfg, x, dm, g_rgb,
                                               g_den, True),
        }
        for kernel, run in runs.items():
            if kernel in DIGEST_KERNELS.get(name, KERNELS):
                digests(run(), f"{name}.{kernel}", out)
        torch.cuda.synchronize()
    with open(path, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    cs.emit({"digest": path, "entries": len(out)})
    return 0


def same(old_path: str, new_path: str, allow: str = None) -> int:
    """Compare two ``--digest`` files (see the module docstring); entries
    whose key matches ``allow`` may differ (listed apart)."""
    with open(old_path) as f:
        old = json.load(f)
    with open(new_path) as f:
        new = json.load(f)
    differ = sorted(k for k in set(old) & set(new) if old[k] != new[k])
    allowed = [k for k in differ if allow and re.search(allow, k)]
    differ = [k for k in differ if k not in allowed]
    only = sorted(set(old) ^ set(new))
    cs.emit({"same": len(set(old) & set(new)) - len(differ) - len(allowed),
             "differ": differ, "allowed_to_differ": allowed,
             "in_one_only": only})
    return 1 if differ or only else 0


def case(kernel: str, name: str):
    """The case of ``cases(kernel)`` named ``name``."""
    return next(c for c in cases(kernel) if c[0] == name)


def flat(out):
    """A version's outputs as tensors (the train kernels' and mlp_bwd's
    dW/db flattened, mlp_bwd's dX and dD when present)."""
    if len(out) == 4:
        return [*out[:3], *[t for wb in out[3] for t in wb]]
    if isinstance(out[0], list):
        return [t for wb in out[0] for t in wb] + [
            t for t in out[1:] if t is not None]
    return list(out)


def in_turns(kernel: str, sources: dict, case, device, seed: int = 0,
             profile: bool = False, plain: bool = True):
    """Check each version against the plain version (with f64 products on
    the f32 wide route, ``utils/parity.reference_products``; the backward
    kernels: and two launches for bit-equal outputs; without ``plain``,
    each version's outputs against the first version's, bit for bit,
    instead) and time them in the order given, then in reverse, reading
    the SM clock and power draw after each. Returns the case's record."""
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp
    from nerf_or_nothing_tpu_torch.utils.parity import reference_products

    name_, cfg, R, mode, white_bkgd, multicam = case
    kinds = layouts(kernel, sources)
    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=device)
    xs, d, delta = cs.level_inputs(cfg, R, mode, seed + 1, device)
    packs = packs_by_layout(kernel, params, cfg, set(kinds.values()))
    if kernel in TRAIN:
        pixels, g_scale = cs.train_inputs(cfg, R, seed + 2, device, multicam)

        def plain_out():
            with reference_products(cfg):
                return fl.level_train_plain(params, cfg, xs, d, delta, pixels,
                                            g_scale, white_bkgd, mode)

        def run(name):
            kw = dict(packed=packs[kinds[name]], source=sources[name])
            if kernel == "train_level":
                return fl.train_level_cuda(params, cfg, xs, d, delta, pixels,
                                           g_scale, white_bkgd, mode, **kw)
            return fl.train_level_twopass_cuda(params, cfg, xs, d, delta,
                                               pixels, g_scale, white_bkgd,
                                               **kw)
    elif kernel == "mlp_bwd":
        input_grads = white_bkgd
        _, _, _, g_rgb, g_den = cs.mlp_case_inputs(cfg, R, seed, device)

        def plain_out():
            with reference_products(cfg):
                return fm.mlp_bwd_plain(params, cfg, xs, d, g_rgb, g_den,
                                        cfg.num_samples, input_grads)

        def run(name):
            return fm.mlp_bwd_cuda(params, cfg, xs, d, g_rgb, g_den,
                                   input_grads, packed=packs[kinds[name]],
                                   source=sources[name])
    elif kernel == "render_level":
        def plain_out():
            with reference_products(cfg):
                return fl.render_level_plain(params, cfg, xs, d, delta,
                                             white_bkgd, mode)

        def run(name):
            return fl.render_level_cuda(params, cfg, xs, d, delta, white_bkgd,
                                        mode, packed=packs[kinds[name]],
                                        source=sources[name])
    else:
        def plain_out():
            with reference_products(cfg):
                return fm.mlp_fwd_plain(params, cfg, xs, d, cfg.num_samples)

        def run(name):
            return fm.mlp_fwd_cuda(params, cfg, xs, d,
                                   packed=packs[kinds[name]],
                                   source=sources[name])

    atol, rtol = cs.BANDS[cfg.compute_dtype]
    names = list(sources)
    res = {"kernel": kernel, "case": name_, "R": R, "S": cfg.num_samples,
           "layouts": kinds}
    refs = []

    def ref_of():
        if not refs:
            refs.append(plain_out())
        return refs[0]

    first = None
    for name in names:
        out = run(name)
        torch.cuda.synchronize()
        if not plain:
            first = out if first is None else first
            res[f"{name}_equal_to_{names[0]}"] = all(
                torch.equal(a, b) for a, b in zip(flat(out), flat(first)))
            continue
        ref = ref_of()
        res[f"{name}_err"] = max(cs.normalized_err(a, b, atol, rtol)
                                 for a, b in zip(flat(out), flat(ref)))
        if kernel in TRAIN or kernel == "mlp_bwd":
            again = run(name)
            res[f"{name}_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(flat(out), flat(again)))
    for turn, name in enumerate(names + names[::-1]):
        res[f"{name}_ms_{turn}"] = cs.median_ms(lambda: run(name))
        res[f"{name}_clock_power_{turn}"] = cs.clock_power()
    if profile:
        for name in names:
            res[f"{name}_device_ms_by_kernel"] = device_ms_by_kernel(
                lambda: run(name))
            res[f"{name}_timeline"] = timeline(lambda: run(name))
    return res


def dw_level_cases():
    """``--dw-levels``' (kernel, case) pairs (``in_turns``' cases)."""
    from nerf_or_nothing_tpu_torch.config import Config

    out = []
    for dtype in ("bfloat16", "float32"):
        t = "bf16" if dtype == "bfloat16" else "f32"
        cfg = Config(compute_dtype=dtype)
        for w in (288, 512, 1024, 2048):
            out.append(("train_level", (f"{t}_w{w}_r1024_s128_t",
                                        cfg.replace(net_width=w), 1024, "t",
                                        True, False)))
        out.append(("train_level_twopass",
                    case("train_level_twopass", f"{t}_w1024_r1024_s128_t")))
        out.append(("mlp_bwd", case("mlp_bwd", f"{t}_w1024_r1024_s128_dx")))
        out.append(("train_level", case("train_level", f"{t}_r1024_s128_t")))
    return out


def dw_levels() -> int:
    """``--dw-levels`` (see the module docstring)."""
    import torch

    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp

    kernels = (*TRAIN, "mlp_bwd")
    parent = cs.commit_sources(cs.DW_COMMIT, cs.DW_DIR, "wide_dw",
                               list(kernels))
    if parent is None:
        raise SystemExit(f"--dw-levels: no copy of {cs.DW_COMMIT}'s csrc/ "
                         "and no git history")
    build.build_all(build.SOURCES, [(k, parent[k]) for k in kernels])
    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda")
    for kernel, c in dw_level_cases():
        sources = {"old": parent[kernel], "new": build.source_path(kernel)}
        res = in_turns(kernel, sources, c, device, profile=True, plain=False)
        name_, cfg, R, mode, white_bkgd, multicam = c
        params = init_mlp(torch.Generator().manual_seed(0), cfg,
                          device=device)
        xs, d, delta = cs.level_inputs(cfg, R, mode, 1, device)
        packs = packs_by_layout(kernel, params, cfg,
                                set(layouts(kernel, sources).values()))
        pairs = {}
        for v, src in sources.items():
            kw = dict(packed=packs[layouts(kernel, sources)[v]], source=src)
            if kernel == "mlp_bwd":
                *_, g_rgb, g_den = cs.mlp_case_inputs(cfg, R, 0, device)
                pairs[v] = fm.mlp_bwd_cuda(params, cfg, xs, d, g_rgb, g_den,
                                           white_bkgd, **kw)[0]
                continue
            pixels, g_scale = cs.train_inputs(cfg, R, 2, device, multicam)
            if kernel == "train_level":
                out = fl.train_level_cuda(params, cfg, xs, d, delta, pixels,
                                          g_scale, white_bkgd, mode, **kw)
            else:
                out = fl.train_level_twopass_cuda(params, cfg, xs, d, delta,
                                                  pixels, g_scale, white_bkgd,
                                                  **kw)
            pairs[v] = out[3]
        atol, rtol = cs.BANDS[cfg.compute_dtype]
        old, new = pairs["old"], pairs["new"]
        res["dw_equal_to_old"] = all(torch.equal(a[0], b[0])
                                     for a, b in zip(old, new))
        res["db_equal_to_old"] = all(torch.equal(a[1], b[1])
                                     for a, b in zip(old, new))
        res["db_err_vs_old"] = max(cs.normalized_err(b[1], a[1], atol, rtol)
                                   for a, b in zip(old, new))
        res.pop("old_timeline", None)
        res.pop("new_timeline", None)
        cs.emit(res)
        torch.cuda.empty_cache()
    return 0


def timeline(fn) -> dict:
    """One call of ``fn`` on the device's clock (``torch.profiler``, after
    one warm-up): each kernel's name, start and duration in ms from the
    first kernel's start, the gaps between consecutive kernels, and their
    sum, the device's idle time between the launches of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (ev.time_range.start, ev.time_range.end, ev.name)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and ev.time_range.end > ev.time_range.start)
    if not kernels:
        return {}
    t0 = kernels[0][0]
    gaps = [b[0] - a[1] for a, b in zip(kernels, kernels[1:])]
    return {"kernels": [[nm[:48], (s - t0) / 1e3, (e - s) / 1e3]
                        for s, e, nm in kernels],
            "gaps_ms": [g / 1e3 for g in gaps],
            "gap_sum_ms": sum(gaps) / 1e3,
            "span_ms": (kernels[-1][1] - t0) / 1e3}


def device_ms_by_kernel(fn, n: int = 5) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by name
    (``torch.profiler`` over n calls after one warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            out[ev.key[:80]] = us / n / 1e3
    return out


def template_args(line: str) -> str:
    """The mangled template arguments of the kernel symbol in a ptxas
    line, as ``<...>`` (``<13__nv_bfloat16>``, ``<f>``, ``<Li3E>``), or
    '' for a kernel that is no template."""
    sym = line.split("'")[1] if line.count("'") >= 2 else ""
    name = cs.kernel_name(line)
    i = sym.find(f"{len(name)}{name}I")
    if i < 0:
        return ""
    rest = sym[i + len(str(len(name))) + len(name) + 1:]
    return f"<{rest[:rest.find('EEv')]}>" if "EEv" in rest else ""


def ptxas_by_kernel(log: str) -> dict:
    """A build's ptxas lines (``chip_smoke.ptxas_lines``) by kernel and
    its template arguments (``template_args``), each instantiation of a
    name under ``name<args>#k`` in build order; the notes that name a
    function (C7511, C7515) counted under its kernel, since their PTX
    line numbers move with any code added beside it and the anonymous
    namespace's tag in their symbols with any change to the file."""
    entries = [ln for ln in log.splitlines() if "Compiling entry function" in ln]
    out, notes, key = {}, {}, None
    for ln in cs.ptxas_lines(log):
        if ln.startswith("kernel "):
            name = ln[7:] + template_args(entries.pop(0))
            k = 0
            while f"{name}#{k}" in out:
                k += 1
            key = f"{name}#{k}"
            out[key] = []
        elif "(C75" in ln:
            name = cs.kernel_name(ln)
            note = re.sub(r"around line \d+ ", "", ln.split(" in function")[0])
            notes.setdefault(name, []).append(
                re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", note))
        elif key is not None:
            out[key].append(ln)
    for key in out:
        out[key] += sorted(notes.get(re.split(r"[<#]", key)[0], []))
    return out


def ptxas_compare(other: Path) -> int:
    """Build ``build.SOURCES`` from ``other`` and from ``csrc/`` and emit,
    per source, which kernels' ptxas lines match."""
    from nerf_or_nothing_tpu_torch.kernels import build

    others = [(n, other / f"{n}.cu") for n in build.SOURCES]
    build.build_all(build.SOURCES, others)
    for n, src in others:
        old = ptxas_by_kernel(build.BUILD_INFO[str(src.resolve())]["log"])
        new = ptxas_by_kernel(
            build.BUILD_INFO[str(build.source_path(n))]["log"])
        both = sorted(set(old) & set(new))
        cs.emit({"ptxas": n, "same": [k for k in both if old[k] == new[k]],
                 "differ": {k: {"old": old[k], "new": new[k]}
                            for k in both if old[k] != new[k]},
                 "only_new": {k: new[k] for k in sorted(set(new) - set(old))},
                 "only_old": {k: old[k] for k in sorted(set(old) - set(new))}})
    return 0


def main(argv) -> int:
    import torch

    if argv[:1] == ["--ptxas"] and len(argv) == 2:
        return ptxas_compare(Path(argv[1]).resolve())
    if argv[:1] == ["--same"] and len(argv) in (3, 5) and (
            len(argv) == 3 or argv[3] == "--allow"):
        return same(argv[1], argv[2], argv[4] if len(argv) == 5 else None)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--digest"] and len(argv) == 2:
        return digest(argv[1])
    if argv == ["--dw-levels"]:
        return dw_levels()
    if argv[:1] == ["--gemm"] and len(argv) <= 2:
        from nerf_or_nothing_tpu_torch.kernels import build
        from nerf_or_nothing_tpu_torch.utils.profiling import card_peaks

        given = Path(argv[1]).resolve() if len(argv) == 2 else None
        runs = []  # (parent sources, phase) of the bf16 and the f32 GEMM
        for harness, sources, phase in (
                ("wide_gemm", cs.gemm_sources, cs.gemm_phase),
                ("wide_gemm_f32", cs.f32_gemm_sources, cs.f32_gemm_phase)):
            if given is None:
                runs.append((sources() or {}, phase))
            elif given.stem == harness:
                runs.append(({harness: str(given)}, phase))
        dw_parent = cs.dw_sources() or {}
        build.build_all([*build.SOURCES, "wide_gemm", "wide_gemm_f32",
                         "wide_dw"],
                        [kv for parent, _ in runs for kv in parent.items()]
                        + list(dw_parent.items()))
        print(cs.nvidia_smi_line(), flush=True)
        _, peaks = card_peaks(torch.cuda.get_device_name(0))
        torch.backends.cuda.matmul.allow_tf32 = False
        for parent, phase in runs:
            phase(peaks, torch.device("cuda"), parent, dw_parent)
        return 0
    from nerf_or_nothing_tpu_torch.kernels import build

    kernel = "render_level"
    args = []
    profile = False
    for a in argv:
        if a.startswith("--kernel="):
            kernel = a.split("=", 1)[1]
        elif a == "--profile":
            profile = True
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
        cs.emit(in_turns(kernel, sources, case, device, profile=profile))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
