"""The wide route's bf16 layer GEMM on the CPU (``kernels/wide_gemm.py``;
the f32 GEMM's column blocks and shared memory too;
the kernel itself, ``csrc/wide_gemm.cuh``, runs only on the card: the
card tests ``-k wide_gemm``): the column block picked per width and the
shared memory it takes, a Python model of the kernel's reads of the slab
stream (a stage's B rows as one contiguous copy), its persistent tile
schedule and its epilogue's staging swizzle, and the plain version of
each epilogue against the port's plain layer math (``fused_level.
mlp_forward_acts`` / ``mlp_backward_plain``), which the JAX package's
kernels are held to elsewhere.

Tolerance: bit-equal where both sides round the same f32 sums (the plain
GEMM and the plain layer share the products); the bf16 band (2e-3, 3e-2)
as a normalized error < 1 where they do not.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402

# The column block of each width: no padded column at 288, 1056 and the
# powers of two; the least padding elsewhere.
BN_OF = {64: 128, 128: 128, 160: 160, 256: 256, 288: 144, 320: 160,
         352: 176, 512: 256, 544: 192, 1000: 256, 1024: 256, 1056: 176,
         2048: 256, 2080: 208, 4608: 256}


@pytest.mark.parametrize("N", sorted(BN_OF))
def test_column_block_per_width(N):
    """``wide_bn`` at the widths the wide route runs: the block, its
    padded columns (none where a block divides N), its stages and shared
    memory within the 227 KB a block may use."""
    bn = wg.wide_bn(N)
    assert bn == BN_OF[N]
    assert bn in wg.BLOCK_COLS and bn % 16 == 0
    assert -(-N // bn) * bn - N == {64: 64, 544: 32, 1000: 24}.get(N, 0)
    assert 4 <= wg.stages(bn) <= wg.MAX_STAGES
    assert wg.smem_bytes(bn) <= wg.SMEM_LIMIT


@pytest.mark.parametrize("N", [96, 288, 1024, 1056])
def test_column_block_of_mlp_bwd_epilogues(N):
    """``chain_heads`` and ``dx`` take 128 or 256 columns a block only."""
    bn = wg.wide_bn(N, "dx")
    assert bn == wg.wide_bn(N, "chain_heads") == (256 if N >= 1024 else 128)


# Widths the f32 GEMM runs (N of its products) and the rows of its last,
# partial column block of ``F32_BN`` = 128 columns (0: none).
F32_LAST_BLOCK = {64: 64, 96: 96, 128: 0, 256: 0, 288: 32, 320: 64, 512: 0,
                  1024: 0, 1056: 32, 2048: 0, 3328: 0}


@pytest.mark.parametrize("N", sorted(F32_LAST_BLOCK))
def test_f32_column_blocks_per_width(N):
    """The f32 GEMM's column blocks (``wide_f32.cuh``: 128 columns, two sets
    of 64 sums a thread in the 168 registers a consumer has) at the widths
    the f32 wide route runs: the producer's bulk copies of each block's B
    rows (min(128, N - n0) rows of 128 bytes, hi and lo) cover N rows once,
    the last block partial where 128 does not divide N; the 4 stages fit
    the 227 KB a block may use, each stage 1024-aligned."""
    rows = [min(wg.F32_BN, N - n0) for n0 in range(0, N, wg.F32_BN)]
    assert sum(rows) == N and all(r % 16 == 0 for r in rows)
    assert (rows[-1] if rows[-1] < wg.F32_BN else 0) == F32_LAST_BLOCK[N]
    assert wg.f32_smem_bytes() <= wg.SMEM_LIMIT
    assert (128 * 128 + 2 * wg.F32_BN * 128) % 1024 == 0


def test_every_block_width_fits():
    """Each column block's ring and staging fit one block, with at least
    four stages (six at 128 columns)."""
    for bn in wg.BLOCK_COLS:
        assert wg.smem_bytes(bn) <= wg.SMEM_LIMIT
        assert wg.stage_bytes(bn) % 1024 == 0  # each stage 1024-aligned
    assert [wg.stages(bn) for bn in (128, 144, 176, 256)] == [6, 5, 5, 4]


@pytest.mark.parametrize("K,N", [(64, 288), (96, 1056), (1024, 144),
                                 (112, 256)])
def test_slab_stream_model(K, N):
    """A stage's B operand for column block n0 .. n0 + BN of k-slab kt is
    the contiguous rows (kt * N + n0) * 64 .. of the stream, each row of 64
    k-values with its 16-byte chunk c at c ^ (row % 8): reading the stream
    so gives back W (zeros past K)."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(
        torch.bfloat16)
    b = fl._wg_slabs(w)
    ns = -(-K // 64)
    assert b.numel() == ns * N * 64
    bn = wg.wide_bn(N)
    got = torch.zeros(ns * 64, N, dtype=torch.bfloat16)
    for kt in range(ns):
        for n0 in range(0, N, bn):
            rows = min(bn, N - n0)
            stage = b[(kt * N + n0) * 64:(kt * N + n0 + rows) * 64]
            stage = stage.view(rows, 8, 8)
            for r in range(rows):
                pos = torch.arange(8) ^ ((n0 + r) % 8)
                got[kt * 64:(kt + 1) * 64, n0 + r] = stage[r, pos].reshape(-1)
    assert torch.equal(got[:K], w)
    assert not got[K:].any()


@pytest.mark.parametrize("M,N,grid", [(1 << 18, 1024, 132), (5077, 288, 132),
                                      (300, 64, 132), (3001, 1056, 7)])
def test_tile_schedule_covers_every_tile_once(M, N, grid):
    """Block b takes tiles b, b + grid, ...; tile t is row band t // nb and
    column block t % nb: every (band, block) once, and the blocks in
    flight at once share their row bands (nb consecutive tiles a band)."""
    bn = wg.wide_bn(N)
    nb = -(-N // bn)
    tiles = -(-M // wg.BLOCK_ROWS) * nb
    seen = {}
    for b in range(min(grid, tiles)):
        for t in range(b, tiles, min(grid, tiles)):
            seen[(t // nb, t % nb)] = seen.get((t // nb, t % nb), 0) + 1
    assert len(seen) == tiles and set(seen.values()) == {1}
    first = {t // nb for t in range(min(grid, tiles))}
    assert len(first) == -(-min(grid, tiles) // nb)


def test_epilogue_staging_boxes():
    """A round of a warpgroup's epilogue: element pair (row rr, columns
    8 jj + 2 qd) at box jj // 2, rr * 32 + 16 (jj % 2) + 4 qd in it (64
    rows x BOX_COLS columns, row-major, the TMA store's box), each 4-byte
    slot once; a tile of BN columns stores whole boxes, none past its
    last column (BN a multiple of 16); a warp's 32 stores of one (jj, h)
    fall in at most two slots a bank."""
    box = 64 * wg.BOX_COLS * 2
    slots = {(jj // 2) * box + rr * 32 + 16 * (jj % 2) + 4 * qd
             for rr in range(64) for jj in range(wg.EPI_COLS // 8)
             for qd in range(4)}
    assert slots == set(range(0, wg.EPI_COLS // wg.BOX_COLS * box, 4))
    assert 2 * box * wg.EPI_COLS // wg.BOX_COLS == wg.EPI_BYTES
    for bn in wg.BLOCK_COLS:
        assert bn % wg.BOX_COLS == 0
    for jj in range(wg.EPI_COLS // 8):
        for warp in range(4):
            for h in range(2):
                banks = [((warp * 16 + (lane >> 2) + 8 * h) * 32
                          + 16 * (jj % 2) + 4 * (lane & 3)) // 4 % 32
                         for lane in range(32)]
                assert max(banks.count(b) for b in banks) <= 2


def layer_case(cfg, seed):
    """A random MLP at ``cfg`` (bf16), IPE-like features and view PE, its
    plain forward's activations."""
    rng = np.random.default_rng(seed)
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg)
    R, S = 3, cfg.num_samples
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32)).to(torch.bfloat16)
    d = torch.from_numpy(rng.normal(size=(R, cfg.direction_features))
                         .astype(np.float32)).to(torch.bfloat16)
    _, _, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S,
                                       torch.bfloat16)
    return params, x, d, hs, vs


def from_layer(kind, a0, w0, a1=None, w1=None, **kw):
    """A ``gemm_case`` dict on given operands (the plain version reads
    only these)."""
    c = {"kind": kind, "M": a0.shape[0], "N": w0.shape[1],
         "K0": a0.shape[1], "K1": 0 if a1 is None else a1.shape[1],
         "S": 1, "cd": 1, "accum": False, "a0": a0, "w0": w0, "a1": a1,
         "w1": w1, "bias": None, "dc": None, "act": None, "gden": None,
         "wden": None, "out0": None}
    c["ldo"] = c["N"]
    c.update(kw)
    return c


CFG = Config(net_width=288, net_width_condition=64, net_depth=4,
             skip_layer=2, num_samples=8, max_deg_point=4)


def test_plain_forward_epilogue_is_the_layer():
    """``wide_gemm_plain`` (kind ``fwd``) on a trunk layer's input and
    weights, the skip layer's two parts (a0 = h, a1 = x) and the first
    view layer's direction term gives the plain forward's activations bit
    for bit."""
    cfg = CFG
    params, x, d, hs, vs = layer_case(cfg, 1)
    nw, S = cfg.net_width, cfg.num_samples
    bf = torch.bfloat16
    w1, b1 = params[1]
    got = wg.wide_gemm_plain(from_layer("fwd", hs[0], w1.to(bf), bias=b1))
    assert torch.equal(got, hs[1])
    w2, b2 = params[2]
    got = wg.wide_gemm_plain(from_layer("fwd", hs[1], w2[:nw].to(bf), x,
                                        w2[nw:].to(bf), bias=b2))
    assert torch.equal(got, hs[2])
    wv, bv = params[cfg.net_depth + 1]
    dc = fl.dense(d, wv[nw:], bf)
    got = wg.wide_gemm_plain(from_layer("fwd", hs[-1], wv[:nw].to(bf),
                                        bias=bv, dc=dc, S=S))
    ref = torch.relu((fl.dense(hs[-1], wv[:nw], bf).view(-1, S, cfg.net_width_condition)
                      + dc[:, None, :]).view(-1, cfg.net_width_condition) + bv).to(bf)
    assert torch.equal(got, ref)
    assert torch.equal(got, vs[0])


def test_plain_chain_epilogue_is_the_chain():
    """``wide_gemm_plain`` (kinds ``chain``, ``chain_heads`` and ``dx``)
    against one step of ``mlp_backward_plain``'s g-chain: g @ W^T
    rounded, the density head's rounded term, the mask of the layer
    below; and the dX term of a skip layer's x rows, rounded and added."""
    cfg = CFG
    params, x, d, hs, vs = layer_case(cfg, 2)
    bf = torch.bfloat16
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=hs[2].shape).astype(np.float32)
                         * 1e-2).to(bf) * (hs[2] > 0)
    w2 = params[2][0]
    nw = cfg.net_width
    # g into trunk layer 1 through layer 2's h rows, masked by h(1)
    ref = fl.dense(g, w2[:nw].t(), bf).to(bf) * (hs[1] > 0)
    got = wg.wide_gemm_plain(from_layer("chain", g, w2[:nw].t().to(bf),
                                        act=hs[1]))
    assert torch.equal(got, ref)
    # the density head's term on the way into the trunk (one channel, and
    # the same channel as a head of one: kWideChainHeads)
    gden = torch.from_numpy(rng.normal(size=(g.shape[0], 1))
                            .astype(np.float32)) * 1e-2
    wden = params[cfg.net_depth][0]
    chain_ref = (fl.dense(g, w2[:nw].t(), bf).to(bf).float()
                 + fl.dense(gden, wden.t(), bf).to(bf).float()).to(bf)
    ref = chain_ref * (hs[1] > 0)
    got = wg.wide_gemm_plain(from_layer(
        "chain", g, w2[:nw].t().to(bf), act=hs[1], gden=gden[:, 0],
        wden=wden.t().to(bf)))
    assert torch.equal(got, ref)
    heads = wg.wide_gemm_plain(from_layer(
        "chain_heads", g, w2[:nw].t().to(bf), act=hs[1], gden=gden,
        wden=wden.t().to(bf)))
    assert torch.equal(heads, ref)
    # dX: layer 2's x-row term, then layer 0's added in bf16
    LX = cfg.location_features
    t2 = fl.dense(g, w2[nw:].t(), bf).to(bf)
    got2 = wg.wide_gemm_plain(from_layer("dx", g, w2[nw:].t().to(bf),
                                         ldo=LX))
    assert torch.equal(got2, t2)
    g0 = g * (hs[0] > 0)
    t0 = fl.dense(g0, params[0][0].t(), bf).to(bf)
    got0 = wg.wide_gemm_plain(from_layer("dx", g0, params[0][0].t().to(bf),
                                         ldo=LX, accum=True, out0=got2))
    assert torch.equal(got0, (t2.float() + t0.float()).to(bf))
