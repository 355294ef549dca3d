"""The wide route's bf16 layer GEMM alone, beside its plain PyTorch version.

Every layer product of the five kernels' wide bf16 routes runs on one
kernel, ``csrc/wide_gemm.cuh::wide_gemm_kernel`` (a persistent block an SM,
a TMA producer, a ring of stages on mbarriers, two consumer warpgroups on
``wgmma``); the kernels' wrappers reach it through their own launches.
``wide_gemm_cuda`` launches it alone through ``csrc/wide_gemm.cu``'s C
entry, or an earlier version of it (``source``: that version's
``wide_gemm.cu`` beside its headers), for the card tests and for timing
versions in turns (``chip_smoke.py``'s ``wide_gemm`` phase,
``compare_kernels.py --gemm``). ``gemm_case`` makes seeded operands the
way the wide route lays them out (row-major bf16 activations, the
weights as ``fused_level._wg_slabs``); ``wide_gemm_plain`` computes the
same product and epilogue in PyTorch (f32 sums in another order: the
bf16 band, not the bits). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.kernels.fused_level import WG_SLAB_K, _wg_slabs

KINDS = {"fwd": 0, "chain": 1, "chain_heads": 2, "dx": 3}
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
    once (A, B, the epilogue's operands, out)."""
    n = sum(c[k].numel() * c[k].element_size()
            for k in ("a0", "a1", "w0", "w1", "bias", "dc", "act", "gden",
                      "wden") if c.get(k) is not None)
    out = c["M"] * (c["ldo"] if c["kind"] == "dx" else c["N"]) * 2
    return n + out * (2 if c["kind"] == "dx" and c["accum"] else 1)


def gemm_case(kind: str, M: int, N: int, K0: int, K1: int = 0, S: int = 128,
              cd: int = 1, ldo: Optional[int] = None, dc: bool = False,
              accum: bool = False, den: bool = True, seed: int = 0,
              device="cpu") -> Dict:
    """Seeded operands of one product: a0 [M, K0] (and a1 [M, K1] when K1)
    bf16, w0 [K0, N] (w1 [K1, N]) bf16 packed as the slab stream b, and the
    epilogue's: ``fwd`` bias [N] f32 and with ``dc`` the direction terms
    [M / S, N]; ``chain`` act [M, N] bf16 (about half > 0) and the density
    term of one channel, gden [M] f32 and wden [1, N] (none without
    ``den``: the chain's layers above the trunk); ``chain_heads`` cd
    channels, gden [M, cd]; ``dx`` out [M, ldo] and with ``accum`` a
    starting sum in it."""
    rng = np.random.default_rng(seed)

    def t(shape, scale, dtype=torch.bfloat16):
        a = rng.standard_normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dtype).to(device)

    c = {"kind": kind, "M": M, "N": N, "K0": K0, "K1": K1, "S": S, "cd": cd,
         "ldo": ldo if ldo is not None else N, "accum": accum}
    a_scale = 1.0 if kind == "fwd" else 1e-2
    c["a0"] = t((M, K0), a_scale)
    if kind == "fwd":
        c["a0"] = c["a0"].relu()
    c["w0"] = t((K0, N), K0 ** -0.5)
    c["a1"] = t((M, K1), 1.0) if K1 else None
    c["w1"] = t((K1, N), K1 ** -0.5) if K1 else None
    parts = [_wg_slabs(c["w0"])]
    if K1:
        parts.append(_wg_slabs(c["w1"]))
    c["b"] = torch.cat(parts)
    for k in ("bias", "dc", "act", "gden", "wden", "out0"):
        c[k] = None
    if kind == "fwd":
        c["bias"] = t((N,), 0.1, torch.float32)
        if dc:
            c["dc"] = t((-(-M // S), N), 0.5, torch.float32)
    elif kind in ("chain", "chain_heads"):
        c["act"] = t((M, N), 1.0)
        nd = 1 if kind == "chain" else cd
        if den or kind == "chain_heads":
            c["gden"] = t((M, nd) if kind == "chain_heads" else (M,), 1e-2,
                          torch.float32)
            c["wden"] = t((nd, N), 0.1)
    else:
        c["out0"] = t((M, c["ldo"]), 1e-2) if accum else None
    return c


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def wide_gemm_plain(c: Dict) -> torch.Tensor:
    """The case's product and epilogue in PyTorch: f32 sums of the bf16
    operands, then the kernel's epilogue (``wide_gemm.cuh``'s pair
    functions), the output in bf16."""
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
