"""The wide routes' layer GEMMs alone, beside their plain PyTorch versions.

Every layer product of the five kernels' wide bf16 routes runs on one
kernel, ``csrc/wide_gemm.cuh::wide_gemm_kernel`` (a persistent block an SM,
a TMA producer, a ring of stages on mbarriers, two consumer warpgroups on
``wgmma``), and every one of their wide f32 routes on
``csrc/wide_f32.cuh::wide_gemm_f32_kernel`` (the same structure, each
product as three TF32 ``wgmma`` passes on split operands); the kernels'
wrappers reach them through their own launches. ``wide_gemm_cuda`` and
``wide_gemm_f32_cuda`` launch them alone through ``csrc/wide_gemm.cu``'s
and ``csrc/wide_gemm_f32.cu``'s C entries, or an earlier version of them
(``source``: that version's entry beside its headers), for the card tests
and for timing versions in turns (``chip_smoke.py``'s ``wide_gemm`` and
``wide_f32`` phases, ``compare_kernels.py --gemm``). ``gemm_case`` makes
seeded operands the way the wide route lays them out (row-major
activations; bf16 weights as ``fused_level._wg_slabs``, f32 weights as
slabs of 32 k-values split into TF32 hi / lo, ``fused_level.tf32_pair``,
and row-major for the earlier f32 version); ``wide_gemm_plain`` computes
the same product and epilogue in PyTorch (bf16: f32 sums in another order,
the bf16 band, not the bits; f32: f64 products rounded to f32, the f32
band). The wide routes' dW GEMMs likewise (``csrc/wide_dw.cuh``:
``wide_dw_kernel<BN>`` in bf16, ``wide_dw_f32_kernel`` in f32, both with
db, each split's tile added into the output in split order):
``dw_case`` makes seeded activations and masked g the way the wide route
lays them out, ``wide_dw_plain`` / ``wide_dw_f32_plain`` compute dW (f32:
and db) over the train level's row splits and ``wide_db_plain`` db the
kernels' way, ``wide_dw_cuda`` launches one product through
``csrc/wide_dw.cu``, and ``dw_products`` / ``dw_items`` / ``dw_waits_on``
model the kernels' job table, work items and split order.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.kernels.fused_level import (
    F32_SLAB_K,
    WG_SLAB_K,
    _wg_slabs,
    tf32_pair,
    train_splits,
)

KINDS = {"fwd": 0, "chain": 1, "chain_heads": 2, "dx": 3}
F32_KINDS = {"fwd": 0, "chain": 1, "dx": 2}  # wide_f32.cuh's kF32Fwd, ...
BLOCK_ROWS = 128                      # rows of an output tile
BLOCK_COLS = tuple(range(128, 257, 16))  # the column blocks the kernel is built for
SMEM_LIMIT = 232448                   # bytes of shared memory a block may use
EPI_COLS = 64                         # columns of a round of a warpgroup's epilogue
BOX_COLS = 16                         # columns of a TMA store box (64 rows of 32 bytes)
EPI_BYTES = 2 * 64 * EPI_COLS * 2     # a warpgroup's two staging buffers
MAX_STAGES = 6


def wide_bn(N: int, kind: str = "fwd") -> int:
    """The column block of a product of N columns (``wide_gemm.cuh::
    wide_bn``): of ``BLOCK_COLS`` (of 128 and 256 alone for the
    ``chain_heads`` and ``dx`` epilogues), the least ceil(N / BN) * (BN +
    32), the wider at a tie."""
    cols = BLOCK_COLS if kind in ("fwd", "chain") else (128, 256)
    return min(cols[::-1], key=lambda bn: -(-N // bn) * (bn + 32))


F32_BN = 128  # the f32 GEMM's column block (wide_f32.cuh::kF32BN)
F32_STAGES = 4


def f32_smem_bytes() -> int:
    """Dynamic shared memory of an f32 GEMM block (``kF32Smem``):
    ``F32_STAGES`` stages of A [128 x 32] and B hi and lo [``F32_BN`` x 32]
    f32, the barriers, 1 KB of alignment."""
    return 1024 + F32_STAGES * (128 * 128 + 2 * F32_BN * 128) + 16 * F32_STAGES


def stage_bytes(bn: int) -> int:
    """Bytes of one stage: 128 rows of A and BN rows of B, 64 k-values."""
    return 2 * 64 * 128 + bn * 128


def stages(bn: int) -> int:
    """Stages of the ring at BN (``wide_gemm.cuh::wide_stages``)."""
    n = (SMEM_LIMIT - 1024 - 2 * EPI_BYTES - 16 * MAX_STAGES) // stage_bytes(bn)
    return min(n, MAX_STAGES)


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of a block at BN (``wide_gemm_smem``)."""
    return 1024 + stages(bn) * stage_bytes(bn) + 2 * EPI_BYTES + 16 * stages(bn)


def flops(c: Dict) -> int:
    """FLOP of the case's products (2 M N K over both parts of A)."""
    return 2 * c["M"] * c["N"] * (c["K0"] + c["K1"])


def min_bytes(c: Dict) -> int:
    """Bytes the case must move: each input read once, the output written
    once (A, B, the epilogue's operands, out; f32 B once, not as its hi / lo
    halves)."""
    n = sum(c[k].numel() * c[k].element_size()
            for k in ("a0", "a1", "w0", "w1", "bias", "dc", "act", "gden",
                      "wden") if c.get(k) is not None)
    out = (c["M"] * (c["ldo"] if c["kind"] == "dx" else c["N"])
           * c["a0"].element_size())
    return n + out * (2 if c["kind"] == "dx" and c["accum"] else 1)


def gemm_case(kind: str, M: int, N: int, K0: int, K1: int = 0, S: int = 128,
              cd: int = 1, ldo: Optional[int] = None, dc: bool = False,
              accum: bool = False, den: bool = True, seed: int = 0,
              device="cpu", dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Seeded operands of one product: a0 [M, K0] (and a1 [M, K1] when K1)
    in ``dtype``, w0 [K0, N] (w1 [K1, N]) packed as the slab stream b
    (bf16: ``_wg_slabs``; f32: slabs of ``F32_SLAB_K`` as ``tf32_pair``, hi
    then lo, and besides the row-major [K0 + K1, N] b_rows), and the
    epilogue's: ``fwd`` bias [N] f32 (for f32 at an odd offset of its
    buffer) and with ``dc`` the direction terms
    [M / S, N]; ``chain`` act [M, N] (about half > 0) and the density term
    of one channel (bf16: gden [M] f32 and wden [1, N]; f32: cd channels,
    gden [M, cd], wden [cd, N]; none without ``den``: the chain's layers
    above the trunk); ``chain_heads`` (bf16) cd channels, gden [M, cd];
    ``dx`` out [M, ldo] and with ``accum`` a starting sum in it."""
    rng = np.random.default_rng(seed)
    f32 = dtype == torch.float32

    def t(shape, scale, dt=dtype):
        a = rng.standard_normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dt).to(device)

    c = {"kind": kind, "M": M, "N": N, "K0": K0, "K1": K1, "S": S, "cd": cd,
         "ldo": ldo if ldo is not None else N, "accum": accum}
    a_scale = 1.0 if kind == "fwd" else 1e-2
    c["a0"] = t((M, K0), a_scale)
    if kind == "fwd":
        c["a0"] = c["a0"].relu()
    c["w0"] = t((K0, N), K0 ** -0.5)
    c["a1"] = t((M, K1), 1.0) if K1 else None
    c["w1"] = t((K1, N), K1 ** -0.5) if K1 else None
    ws = [c["w0"]] + ([c["w1"]] if K1 else [])
    if f32:
        c["b"] = tf32_pair(torch.cat([_wg_slabs(w, F32_SLAB_K) for w in ws]))
        c["b_rows"] = torch.cat(ws).contiguous()
    else:
        c["b"] = torch.cat([_wg_slabs(w) for w in ws])
    for k in ("bias", "dc", "act", "gden", "wden", "out0"):
        c[k] = None
    if kind == "fwd":
        # f32: at an odd offset, as a view layer's biases lie after the
        # density head's in the packed biases
        c["bias"] = (t((N + 1,), 0.1, torch.float32)[1:] if f32
                     else t((N,), 0.1, torch.float32))
        if dc:
            c["dc"] = t((-(-M // S), N), 0.5, torch.float32)
    elif kind in ("chain", "chain_heads"):
        c["act"] = t((M, N), 1.0)
        nd = cd if kind == "chain_heads" or f32 else 1
        if den or kind == "chain_heads":
            c["gden"] = t((M, nd) if kind == "chain_heads" or f32 else (M,),
                          1e-2, torch.float32)
            c["wden"] = t((nd, N), 0.1)
    else:
        c["out0"] = t((M, c["ldo"]), 1e-2) if accum else None
    return c


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def wide_gemm_f32_plain(c: Dict) -> torch.Tensor:
    """An f32 case's product and epilogue in PyTorch: the products in f64
    rounded to f32 (``utils/parity.reference_products``' reference), then
    ``wide_f32.cuh``'s epilogue in f32: the forward's (acc + dc) + bias and
    ReLU, the g-chain's density term (an FMA sum over the cd channels in
    order from -0) and mask, dX's columns below ldo added to the starting
    sum."""
    acc = c["a0"].double() @ c["w0"].double()
    if c["K1"]:
        acc = acc + c["a1"].double() @ c["w1"].double()
    acc = acc.float()
    kind = c["kind"]
    if kind == "fwd":
        if c["dc"] is not None:
            acc = acc + c["dc"].repeat_interleave(c["S"], 0)[:c["M"]]
        return torch.relu(acc + c["bias"])
    if kind == "dx":
        v = acc[:, :c["ldo"]]
        return c["out0"] + v if c["accum"] else v
    if c["gden"] is not None:
        term = torch.full_like(acc, -0.0)
        for k in range(c["gden"].shape[1]):
            term = torch.addcmul(term, c["gden"][:, k:k + 1],
                                 c["wden"][k][None, :])
        acc = acc + term
    return torch.where(c["act"] > 0, acc, 0.0)


def wide_gemm_plain(c: Dict) -> torch.Tensor:
    """The case's product and epilogue in PyTorch: f32 sums of the bf16
    operands, then the kernel's epilogue (``wide_gemm.cuh``'s pair
    functions), the output in bf16; an f32 case through
    ``wide_gemm_f32_plain``."""
    if c["a0"].dtype == torch.float32:
        return wide_gemm_f32_plain(c)
    acc = c["a0"].float() @ c["w0"].float()
    if c["K1"]:
        acc = acc + c["a1"].float() @ c["w1"].float()
    kind = c["kind"]
    if kind == "fwd":
        if c["dc"] is not None:
            acc = acc + c["dc"].repeat_interleave(c["S"], 0)[:c["M"]]
        return torch.relu(acc + c["bias"]).to(torch.bfloat16)
    if kind == "dx":
        v = _round(acc[:, :c["ldo"]])
        if c["accum"]:
            v = c["out0"].float() + v
        return v.to(torch.bfloat16)
    v = _round(acc)
    if kind == "chain":
        if c["gden"] is not None:
            v = v + _round(_round(c["gden"])[:, None] * c["wden"].float())
    else:
        term = _round(c["gden"]) @ c["wden"].float()
        v = v + _round(term)
    return torch.where(c["act"].float() > 0, v, 0.0).to(torch.bfloat16)


def _library(source=None):
    from nerf_or_nothing_tpu_torch.kernels import build

    fn = build.load("wide_gemm", source).wide_gemm_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, p, i, i, i, p, i, i, i, p, i, ll, p, p, i, p, p, p,
                        i, p, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def wide_gemm_cuda(c: Dict, source=None) -> torch.Tensor:
    """The case on the card through ``wide_gemm_launch`` (of ``source``'s
    build when given): one launch of the GEMM, the output [M, N] (dx:
    [M, ldo]) in bf16. The operands must lie on a CUDA device."""
    if not c["a0"].is_cuda:
        raise ValueError("wide_gemm_cuda needs CUDA tensors")
    fn = _library(source)
    M, N, kind = c["M"], c["N"], c["kind"]
    dev = c["a0"].device
    if kind == "dx":
        out = (c["out0"].clone() if c["accum"]
               else torch.empty(M, c["ldo"], dtype=torch.bfloat16, device=dev))
    else:
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ns = lambda k: -(-k // WG_SLAB_K)  # noqa: E731
    rc = fn(KINDS[kind], ptr(c["a0"]), c["K0"], c["K0"], ns(c["K0"]),
            ptr(c["a1"]), c["K1"], c["K1"], ns(c["K1"]) if c["K1"] else 0,
            ptr(c["b"]), N, M, ptr(c["bias"]), ptr(c["dc"]), c["S"],
            ptr(c["act"]), ptr(c["gden"]), ptr(c["wden"]), c["cd"],
            ptr(out), c["ldo"], int(c["accum"]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_gemm_launch failed with CUDA error {rc}")
    return out


def _f32_library(source=None):
    from nerf_or_nothing_tpu_torch.kernels import build

    fn = build.load("wide_gemm_f32", source).wide_gemm_f32_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, p, i, i, p, i, i, p, p, p, i, ll, p, p, i, p, p,
                        p, i, p, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def wide_gemm_f32_cuda(c: Dict, source=None) -> torch.Tensor:
    """An f32 case on the card through ``wide_gemm_f32_launch`` (of
    ``source``'s build when given; B passed both as the hi / lo slabs and
    row-major, each version reads its own): one launch of the GEMM, the
    output [M, N] (dx: [M, ldo]) in f32. The operands must lie on a CUDA
    device."""
    if not c["a0"].is_cuda:
        raise ValueError("wide_gemm_f32_cuda needs CUDA tensors")
    fn = _f32_library(source)
    M, N, kind = c["M"], c["N"], c["kind"]
    dev = c["a0"].device
    if kind == "dx":
        out = (c["out0"].clone() if c["accum"]
               else torch.empty(M, c["ldo"], dtype=torch.float32, device=dev))
    else:
        out = torch.empty(M, N, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    half = c["b"].numel() // 2
    cd = c["gden"].shape[1] if c["gden"] is not None else 0
    rc = fn(F32_KINDS[kind], ptr(c["a0"]), c["K0"], c["K0"], ptr(c["a1"]),
            c["K1"], c["K1"], ptr(c["b_rows"]), ptr(c["b"]),
            ptr(c["b"][half:]), N, M, ptr(c["bias"]), ptr(c["dc"]), c["S"],
            ptr(c["act"]), ptr(c["gden"]), ptr(c["wden"]), cd, ptr(out),
            c["ldo"], int(c["accum"]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_gemm_f32_launch failed with CUDA error {rc}")
    return out


# ---- the dW GEMMs (csrc/wide_dw.cuh) ----

DW_ROWS = 32            # a split's rows are a multiple of these (split_rows)
DW_STAGE_ROWS = 64      # rows of a bf16 stage: two TMA boxes of DW_ROWS
DW_MAX_JOBS = 48        # products a launch (kDwMaxJobs)
DW_F32_STAGES = 3
DW_F32_PART = 128 * 32 * 4  # A, raw B, B hi or B lo of an f32 stage


def split_rows(K: int, splits: int) -> int:
    """Rows of each split of K rows (``level_backward.cuh::split_rows``):
    ceil(K / splits) rounded up to ``DW_ROWS``; the last splits may be
    short or empty."""
    return (-(-K // splits) + DW_ROWS - 1) // DW_ROWS * DW_ROWS


def split_bounds(K: int, splits: int):
    """[(k_lo, k_hi)] of each split (k_hi <= k_lo: empty)."""
    chunk = split_rows(K, splits)
    return [(s * chunk, min(K, (s + 1) * chunk)) for s in range(splits)]


def dw_bn(Nn: int) -> int:
    """The bf16 dW GEMM's column block: 256 where it divides the product's
    columns, else 128 (the f32 one: 128 always)."""
    return 256 if Nn % 256 == 0 else 128


def dw_stage_bytes(bn: int) -> int:
    """A bf16 stage: A's two slabs of 64 rows x 64 columns, B's bn / 64."""
    return (2 + bn // 64) * 64 * 128


def dw_stages(bn: int) -> int:
    """Stages of the bf16 ring (``dw_stages``): 4 at 256 columns, 6 at
    128."""
    n = (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // dw_stage_bytes(bn)
    return min(n, MAX_STAGES)


def dw_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of a bf16 dW block (``dw_smem``)."""
    return 1024 + dw_stages(bn) * dw_stage_bytes(bn) + 16 * dw_stages(bn)


def dw_f32_smem_bytes() -> int:
    """Dynamic shared memory of an f32 dW block (``kDwF32Smem``): 3 stages
    of A, raw B, B hi and B lo, three barriers a stage."""
    return 1024 + DW_F32_STAGES * (4 * DW_F32_PART + 24)


def dw_products(cfg: Config):
    """A level's dW products at the kernel widths of ``cfg`` as
    ``csrc/wide_dw.cuh::dw_products`` lists them (launch_dw's order):
    (A operand, its layer, M, B operand, its layer, Nn, db) with operands
    "acts" (trunk activations), "view_acts", "x" (the features, LX
    columns), "grads", "view_grads"; db: the product carries its layer's
    bias (the f32 kernel's column sums)."""
    D, Dc, skip = cfg.net_depth, cfg.net_depth_condition, cfg.skip_layer
    W, Wc, LX = cfg.net_width, cfg.net_width_condition, cfg.location_features
    out = []
    for i in range(D):
        if i == 0:
            out.append(("x", 0, LX, "grads", 0, W, True))
        else:
            out.append(("acts", i - 1, W, "grads", i, W, True))
            if i % skip == 0:
                out.append(("x", 0, LX, "grads", i, W, False))
    for j in range(Dc):
        if j == 0:
            out.append(("acts", D - 1, W, "view_grads", 0, Wc, True))
        else:
            out.append(("view_acts", j - 1, Wc, "view_grads", j, Wc, True))
    return out


def dw_launch_groups(products, f32: bool):
    """The launches of a level's products: (column block, products), the
    bf16 products whose columns 256 divides first, kDwMaxJobs a launch."""
    groups = [(128, list(products))] if f32 else [
        (256, [p for p in products if dw_bn(p[5]) == 256]),
        (128, [p for p in products if dw_bn(p[5]) == 128])]
    return [(bn, ps[j:j + DW_MAX_JOBS]) for bn, ps in groups
            for j in range(0, len(ps), DW_MAX_JOBS)]


def dw_items(products, bn: int, splits: int):
    """The work items of one launch in the kernel's order (``dw_tile``:
    split-major, a split's tiles job by job, row blocks fastest) as
    (job, row origin, column origin, split)."""
    tiles = []
    for jn, p in enumerate(products):
        tm, tn = -(-p[2] // BLOCK_ROWS), -(-p[5] // bn)
        tiles += [(jn, (t % tm) * BLOCK_ROWS, (t // tm) * bn)
                  for t in range(tm * tn)]
    return [(jn, m0, n0, s) for s in range(splits) for jn, m0, n0 in tiles]


DW_PARTS = 3  # split counters a tile: consumer warpgroups 0 and 1, db (kDwParts)


def dw_flag_count(M: int, Nn: int) -> int:
    """Split counters (ints) a launch of one product of M rows and Nn
    columns needs (``wide_dw_flag_count``): ``DW_PARTS`` a tile at the
    smallest column block, 128."""
    return DW_PARTS * -(-M // BLOCK_ROWS) * -(-Nn // 128)


def dw_flag_bound(D: int, W: int, Wc: int, Dc: int, KX: int) -> int:
    """Split counters the wide level's workspace holds
    (``wide_dw.cuh::dw_flag_bound``): ``DW_PARTS`` a tile at 128 columns of
    D trunk products from W and D from the KX feature columns, the first
    view layer's from W and Dc - 1 from Wc."""
    return (D * (dw_flag_count(W, W) + dw_flag_count(KX, W))
            + dw_flag_count(W, Wc) + max(Dc - 1, 0) * dw_flag_count(Wc, Wc))


def dw_waits_on(item: int, tiles: int):
    """The work item whose stores item ``item`` of a launch of ``tiles``
    tiles a split waits for before it adds its own (the same tile's
    previous split, ``tiles`` items earlier), or None (split 0)."""
    return item - tiles if item >= tiles else None


def dw_box_rows(k_lo: int, k_hi: int, K: int):
    """The row of each 32-row TMA box the bf16 producer loads for the split
    [k_lo, k_hi) of K rows (``wide_dw_kernel``): two a 64-row stage; a box
    past the split's end at row K, which the map reads as zeros."""
    rows = []
    for k0 in range(k_lo, k_hi, DW_STAGE_ROWS):
        rows += [k0 + h * DW_ROWS if k0 + h * DW_ROWS < k_hi else K
                 for h in range(2)]
    return rows


def dw_case(M: int, Nn: int, K: int, lda: Optional[int] = None,
            splits: Optional[int] = None, seed: int = 0, device="cpu",
            dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Seeded operands of one dW product as the wide route lays them out:
    act [K, lda] a layer's activations after ReLU (about half zero; its
    columns [0, M) the output rows; the features' x rows have lda = KX
    above M = LX), g [K, Nn] its masked g (zero where the layer's own
    activation is not > 0, about half), in ``dtype``; ``splits``
    defaults to ``fused_level.train_splits(K)``."""
    rng = np.random.default_rng(seed)
    lda = M if lda is None else lda
    a = np.maximum(rng.standard_normal((K, lda)).astype(np.float32), 0.0)
    g = (rng.standard_normal((K, Nn)).astype(np.float32) * 1e-2
         * (rng.random((K, Nn)) > 0.5))
    to = lambda x: torch.from_numpy(x).to(dtype).to(device)  # noqa: E731
    return {"M": M, "Nn": Nn, "K": K, "lda": lda, "act": to(a), "g": to(g),
            "splits": train_splits(K) if splits is None else splits}


def _split_parts(c: Dict, f64: bool):
    """Each split's act^T g (f32 sums, or f64 rounded to f32) and column
    sums of g."""
    act, g = c["act"][:, :c["M"]], c["g"]
    dt = torch.float64 if f64 else torch.float32
    for k_lo, k_hi in split_bounds(c["K"], c["splits"]):
        if k_hi <= k_lo:
            yield (torch.zeros(c["M"], c["Nn"], device=g.device),
                   torch.zeros(c["Nn"], device=g.device))
            continue
        a, b = act[k_lo:k_hi].to(dt), g[k_lo:k_hi].to(dt)
        yield (a.t() @ b).float(), b.sum(0).float()


def wide_dw_plain(c: Dict) -> torch.Tensor:
    """dW [M, Nn] of a bf16 case: each split's f32 sums of the bf16
    products, the partials added in split order (the bf16 band, not the
    kernel's bits)."""
    out = torch.zeros(c["M"], c["Nn"], device=c["g"].device)
    for part, _ in _split_parts(c, False):
        out = out + part
    return out


def wide_db_plain(c: Dict) -> torch.Tensor:
    """db [Nn] the dW kernels' way, in either dtype: each split's column
    sums of g in row order in f32 from +0, the splits' sums then added in
    split order from +0 (``wide_dw_kernel``'s db warps and
    ``wide_dw_f32_kernel``'s transposers with the ordered add; bit for bit,
    since f32 adds of the same values in the same order round the same)."""
    g = c["g"]
    bounds = split_bounds(c["K"], c["splits"])
    rows = max(hi - lo for lo, hi in bounds)
    chunk = torch.zeros(len(bounds), max(rows, 0), c["Nn"], device=g.device)
    for k, (lo, hi) in enumerate(bounds):
        if hi > lo:
            chunk[k, :hi - lo] = g[lo:hi].float()
    # rows past a split's end are +0: adding them to a sum that started
    # from +0 leaves it as it is
    per_split = torch.zeros(len(bounds), c["Nn"], device=g.device)
    for r in range(chunk.shape[1]):
        per_split = per_split + chunk[:, r]
    db = torch.zeros(c["Nn"], device=g.device)
    for s in per_split:
        db = db + s
    return db


def wide_dw_f32_plain(c: Dict):
    """(dW [M, Nn], db [Nn]) of an f32 case: each split's products and
    column sums in f64 rounded to f32, the partials added in f32 in split
    order (the f32 band)."""
    dw = torch.zeros(c["M"], c["Nn"], device=c["g"].device)
    db = torch.zeros(c["Nn"], device=c["g"].device)
    for part, col in _split_parts(c, True):
        dw, db = dw + part, db + col
    return dw, db


def dw_flops(c: Dict) -> int:
    """FLOP of the case's product (2 M Nn K)."""
    return 2 * c["M"] * c["Nn"] * c["K"]


def dw_min_bytes(c: Dict) -> int:
    """Bytes the case must move: act's M columns and g read once, dW and db
    written once."""
    es = c["g"].element_size()
    return (c["K"] * (c["M"] + c["Nn"]) * es
            + (c["M"] * c["Nn"] + c["Nn"]) * 4)


def _dw_library(source=None):
    """``csrc/wide_dw.cu``'s library (or ``source``'s build): with its
    reduced entry ``wide_dw_reduced_launch``, or a version's partials entry
    ``wide_dw_launch``."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("wide_dw", source)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "wide_dw_reduced_launch"):
        fn = lib.wide_dw_reduced_launch
        if fn.argtypes is None:
            fn.argtypes = [i, p, i, i, p, i, i, i, i, p, ll, p, ll, p]
            fn.restype = ctypes.c_int
            lib.wide_dw_flag_count.argtypes = [i, i]
            lib.wide_dw_flag_count.restype = ll
        return lib
    fn = lib.wide_dw_launch
    if fn.argtypes is None:
        fn.argtypes = [i, p, i, i, p, i, i, i, i, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return lib


def _check_dw_case(c: Dict) -> bool:
    """Whether the case is f32; raises on operands the kernels do not take
    (CPU tensors first)."""
    act, g = c["act"], c["g"]
    if not (act.is_cuda and g.is_cuda):
        raise ValueError("the dW GEMMs need CUDA tensors")
    M, Nn, K = c["M"], c["Nn"], c["K"]
    if (act.dtype != g.dtype or g.dtype not in (torch.bfloat16, torch.float32)
            or not (act.is_contiguous() and g.is_contiguous())
            or act.shape != (K, c["lda"]) or g.shape != (K, Nn)
            or not 0 < M <= c["lda"]):
        raise ValueError("dW case: act [K, lda] and g [K, Nn], contiguous, "
                         "both bf16 or both f32, M <= lda")
    return g.dtype == torch.float32


def wide_dw_partials(c: Dict, source=None) -> torch.Tensor:
    """One launch of a version's dW GEMM whose kernels write each split's
    partial (``source``'s build of ``wide_dw_launch``): [splits, M * Nn]
    (f32: and its Nn column sums after). The operands must lie on a CUDA
    device."""
    f32 = _check_dw_case(c)
    M, Nn, g = c["M"], c["Nn"], c["g"]
    n_out = M * Nn + (Nn if f32 else 0)
    part = torch.empty(c["splits"], n_out, device=g.device)
    rc = _dw_library(source).wide_dw_launch(
        int(f32), c["act"].data_ptr(), c["lda"], M, g.data_ptr(), Nn, Nn,
        c["K"], c["splits"], part.data_ptr(), n_out, M * Nn if f32 else -1,
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_dw_launch failed with CUDA error {rc}")
    return part


def wide_dw_reduced(c: Dict, flags: Optional[torch.Tensor] = None,
                    source=None) -> torch.Tensor:
    """One launch of the case's dW GEMM with db, the splits added in order
    in the kernel (``wide_dw_reduced_launch``): [M * Nn + Nn], dW then db.
    ``flags``: the split counters (``dw_flag_count`` int32), made here when
    not given. The operands must lie on a CUDA device."""
    f32 = _check_dw_case(c)
    M, Nn, g = c["M"], c["Nn"], c["g"]
    lib = _dw_library(source)
    n_flags = int(lib.wide_dw_flag_count(M, Nn))
    if flags is None:
        flags = torch.empty(n_flags, dtype=torch.int32, device=g.device)
    out = torch.empty(M * Nn + Nn, device=g.device)
    rc = lib.wide_dw_reduced_launch(
        int(f32), c["act"].data_ptr(), c["lda"], M, g.data_ptr(), Nn, Nn,
        c["K"], c["splits"], out.data_ptr(), M * Nn, flags.data_ptr(),
        flags.numel(), torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_dw_reduced_launch failed with CUDA error "
                           f"{rc}")
    return out


def has_reduced(source=None) -> bool:
    """Whether the build of ``source`` (default: the checkout's) adds the
    splits in its kernels (else it writes each split's partial)."""
    return hasattr(_dw_library(source), "wide_dw_reduced_launch")


def dw_launch(c: Dict, source=None):
    """One launch of the version's kernel alone, as the levels run it: the
    reduced launch, or a partials version's launch (the reduction
    then outside it)."""
    _check_dw_case(c)
    if has_reduced(source):
        return wide_dw_reduced(c, source=source)
    return wide_dw_partials(c, source)


def _reduce(part: torch.Tensor) -> torch.Tensor:
    """The partials summed in split order (``reduce_kernel``'s)."""
    out = torch.zeros_like(part[0])
    for p in part:
        out = out + p
    return out


def wide_dw_cuda(c: Dict, source=None):
    """(dW [M, Nn], db [Nn]) of a case on the card, in either dtype: the
    kernel's sums (a version that writes partials: summed in split order
    here by ``_reduce``, and bf16 db None, since that version's bf16
    kernel took none)."""
    _check_dw_case(c)
    n = c["M"] * c["Nn"]
    if has_reduced(source):
        out = wide_dw_reduced(c, source=source)
        return out[:n].view(c["M"], c["Nn"]), out[n:]
    out = _reduce(wide_dw_partials(c, source))
    db = out[n:] if c["g"].dtype == torch.float32 else None
    return out[:n].view(c["M"], c["Nn"]), db
