"""The wide routes' dW GEMMs (``csrc/wide_dw.cuh``: ``wide_dw_kernel<BN>``
in bf16, ``wide_dw_f32_kernel`` in f32 with db) on the CPU; the kernels
run only on the card (card tests ``-k wide_dw``):

- the plain versions (``kernels/wide_gemm.py``: ``wide_dw_plain``,
  ``wide_dw_f32_plain``) as every dW product of the port's plain train
  level at net_width 288, at 1 and 3 row splits, against the dW / db of
  the JAX package's ``fused_level_train`` (Pallas, interpret mode), in
  bf16 and f32;
- a Python model of the f32 kernel's reads: the transposers' B hi / lo
  slabs read the way ``wgmma`` reads them are ``split_tf32(g^T)``, each
  consumer's A fragment (read from the TMA box's 128-byte swizzle, its
  rows a permutation of the tile's columns) is A^T on 32 banks a read, and
  the dW they give through the 32-row stage sums and the round-to-nearest
  add is ``dw_gemm_f32_kernel``'s, bit for bit; db is its column sums in
  row order;
- the schedule: the work items of a level's launches cover every
  (product, row block, column block, split) once, split-major, at widths
  288, 512, 1024 and 2048, with a partial row block of the features' x
  rows and past ``DW_MAX_JOBS`` products; the bf16 producer's 32-row
  boxes read each row of a split once, zeros past its end, where a split
  ends off a 64-row stage;
- each kernel's shared memory and its job table;
- bf16 db: ``wide_db_plain`` (each split's column sums in row order, then
  the splits in order, the kernels' sums bit for bit against the model of
  their reads) against JAX's db in the bf16 band;
- the split order: a model of the persistent grid (132, 114 and 7
  blocks) over a level's work items, every (tile, split) added once and
  in split order, every wait on an item of an earlier or the same round,
  the sums ``_reduce``'s bit for bit; the split counters' bound.

Tolerance: the parity bands of ``nerf_or_nothing_tpu/utils/parity.py``
(f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2)) as a normalized error < 1;
bit-equal where two models take the same sums in the same order.
"""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_train,
)
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import math_utils as mu  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
# net_width 288 (the wide route, a partial 128-column block), depth 3 with
# a skip layer at 2, S = 8 (JAX's CPU dot takes bf16 there), R = 10: 80
# rows, 3 splits of 32, 32 and 16 rows
WIDE_288 = dict(net_depth=3, net_width=288, net_depth_condition=1,
                net_width_condition=128, skip_layer=2, max_deg_point=4,
                num_samples=8)
R = 10


def close(a, b, dtype, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = normalized_err(a, b, *PARITY_BANDS[dtype])
    assert err < 1.0, (what, err)


@functools.lru_cache(maxsize=None)
def level_case(dtype: str):
    """The JAX and port configs, weights and level inputs, and JAX's
    interpreted ``fused_level_train`` on them."""
    jc = JConfig(compute_dtype=dtype, **WIDE_288)
    tc = Config(compute_dtype=dtype, **WIDE_288)
    S = tc.num_samples
    rng = np.random.default_rng(5)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(5), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    mask = rng.uniform(0.5, 2.0, R).astype(f32)
    mask[::3] = 0.0
    c = dict(
        x=(rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32),
        dir_enc=(rng.normal(size=(R, 27)) * 0.5).astype(f32),
        t_vals=np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(f32),
        dirs=rng.normal(size=(R, 3)).astype(f32),
        pixels=rng.uniform(size=(R, 3)).astype(f32),
        g_scale=(0.1 * 2.0 * mask / mask.sum())[:, None].astype(f32),
    )
    keys = ("x", "dir_enc", "t_vals", "dirs", "pixels", "g_scale")
    ref = j_train(jp, jc, *(J(c[k]) for k in keys), True, tile=16)
    return tc, tp, c, [(np.asarray(w), np.asarray(b)) for w, b in ref[3]]


def layer_of_calls(cfg):
    """The layer of each dW product over the level's rows, in the order
    ``mlp_backward_plain`` takes them: the rgb head, the view layers top
    first, the density head, the trunk top first (a skip layer's h rows,
    then its x rows)."""
    D, Dc, skip = cfg.net_depth, cfg.net_depth_condition, cfg.skip_layer
    order = [D + 1 + Dc] + [D + 1 + j for j in reversed(range(Dc))] + [D]
    for i in reversed(range(D)):
        order += [i, i] if i > 0 and i % skip == 0 else [i]
    return order


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("splits", [1, 3])
def test_plain_dw_matches_jax_train_level(monkeypatch, dtype, splits):
    """Every dW product of the port's plain train level over its R x S rows
    (``fused_level.dense`` on a^T, g) through ``wide_dw_plain`` /
    ``wide_dw_f32_plain`` at ``splits`` row splits: the level's dW in the
    dtype's band of JAX's, and in f32 each product's db (its column sums of
    g) in the band of JAX's db of that layer."""
    tc, tp, c, ref = level_case(dtype)
    dt = tmlp.compute_dtype(tc)
    N = R * tc.num_samples
    calls = []
    dense = fl.dense

    def split_dense(h, w, d):
        if h.shape[-1] == N and h.stride(-2) == 1 and not h.is_contiguous():
            case = {"M": h.shape[0], "Nn": w.shape[1], "K": N,
                    "lda": h.shape[0], "act": h.t().to(d), "g": w.to(d),
                    "splits": splits}
            if d == torch.float32:
                out, db = wg.wide_dw_f32_plain(case)
            else:
                out, db = wg.wide_dw_plain(case), None
            calls.append(db)
            return out
        return dense(h, w, d)

    monkeypatch.setattr(fl, "dense", split_dense)
    keys = ("dir_enc", "t_vals", "dirs", "pixels", "g_scale")
    port = fl.fused_level_train(tp, tc, T(c["x"]), *(T(c[k]) for k in keys),
                                True)
    order = layer_of_calls(tc)
    assert len(calls) == len(order)
    assert [wg.split_bounds(N, splits)[-1][1]] == [N]
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    if dt == torch.float32:
        for layer, db in zip(order, calls):
            close(db.numpy(), ref[layer][1], dtype, f"kernel db{layer}")


# ---- a Python model of the f32 kernel's reads ----

def tma_box(t: torch.Tensor) -> torch.Tensor:
    """A [32 rows x 32 f32] box as TMA's 128-byte swizzle lays it out in
    shared memory, as 4-byte words: element (r, c) at word 32 r + 4 ((c /
    4) ^ (r % 8)) + c % 4."""
    out = torch.empty(32 * 32, dtype=t.dtype)
    r = torch.arange(32)[:, None]
    col = torch.arange(32)[None, :]
    out[32 * r + 4 * ((col // 4) ^ (r % 8)) + col % 4] = t
    return out


def transposed_slab(raw: torch.Tensor, part: int) -> torch.Tensor:
    """``dw_transpose`` on a stage's raw B [32 rows x 128]: column c's rows
    4q .. 4q + 3 split (``split_tf32``; part 0: hi, 1: lo) into the
    16-byte chunk at byte c * 128 + ((q ^ (c % 8)) << 4) of the slab, as
    4-byte words."""
    v = mu.split_tf32(raw)[part]
    out = torch.empty(128 * 32)
    for c in range(128):
        for q in range(8):
            off = (c * 128 + ((q ^ (c & 7)) << 4)) // 4
            out[off:off + 4] = v[4 * q:4 * q + 4, c]
    return out


def wgmma_b(slab: torch.Tensor) -> torch.Tensor:
    """A K-major [128 n x 32 k] f32 operand as ``wgmma_tf32``'s
    descriptor reads it (128-byte rows, 16-byte chunk j of row n at chunk
    position j ^ (n % 8)): B [k, n]."""
    n = torch.arange(128)[:, None]
    k = torch.arange(32)[None, :]
    return slab[32 * n + 4 * ((k // 4) ^ (n % 8)) + k % 4].t()


def fragment_reads(kk: int):
    """``load_a_dw``'s word addresses in an A box for k8 step kk: for every
    consumer thread (warpgroup wg, thread tid) its box, and for each of
    its four values (fragment row 16 w + g + 8 h, k-value tq + 4 e1) the
    word it reads; returns [(wg, w, g, tq, box, [4 words])]."""
    out = []
    for wg_ in range(2):
        for tid in range(128):
            w, g, tq = tid >> 5, (tid & 31) >> 2, tid & 3
            box = 2 * wg_ + (w >> 1)
            lc = 8 * (w & 1) + 16 * (g >> 2) + (g & 3)
            q = lc >> 2
            r0, r1 = 8 * kk + tq, 8 * kk + tq + 4
            words = [32 * r0 + 4 * (q ^ tq) + (lc & 3),
                     32 * r0 + 4 * ((q + 1) ^ tq) + (lc & 3),
                     32 * r1 + 4 * (q ^ (tq + 4)) + (lc & 3),
                     32 * r1 + 4 * ((q + 1) ^ (tq + 4)) + (lc & 3)]
            out.append((wg_, w, g, tq, box, words))
    return out


def fragment_column(wg_: int, w: int, g: int, h: int) -> int:
    """The tile column (act column - m0) of fragment row 16 w + g + 8 h of
    warpgroup wg (the kernel's epilogue)."""
    box = 2 * wg_ + (w >> 1)
    return 32 * box + 8 * (w & 1) + 16 * (g >> 2) + (g & 3) + 4 * h


def test_a_fragment_rows_cover_the_tile_on_32_banks():
    """The consumers' fragment rows are a permutation of the tile's 128
    columns, and every read of ``load_a_dw`` (a value index of a k8 step,
    one warp) falls on 32 distinct banks."""
    cols = sorted(fragment_column(wg_, w, g, h) for wg_ in range(2)
                  for w in range(4) for g in range(8) for h in range(2))
    assert cols == list(range(128))
    for kk in range(4):
        reads = fragment_reads(kk)
        for warp in range(8):
            lanes = reads[32 * warp:32 * warp + 32]
            for e in range(4):
                banks = {words[e] % 32 for *_, words in lanes}
                assert len(banks) == 32, (kk, warp, e)


def test_transposer_slabs_are_tf32_pair_of_g_transposed():
    """Unswizzled the way ``wgmma`` reads them, the transposers' B hi / lo
    slabs of a stage are ``split_tf32`` of g's 32 rows x 128 columns (hi
    bit for bit the packer's ``tf32_pair`` split); their 16-byte stores
    from 8 neighbouring columns (threads) fall on 32 banks."""
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    raw[3, 5] = float("nan")
    for part in (0, 1):
        got = wgmma_b(transposed_slab(raw, part))
        want = mu.split_tf32(raw)[part]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pair = fl.tf32_pair(raw.t().contiguous().view(-1))
    hi = wgmma_b(transposed_slab(raw, 0)).t().contiguous().view(-1)
    ok = ~torch.isnan(hi)
    assert torch.equal(hi[ok], pair[:hi.numel()][ok])
    for q in range(8):
        for c0 in range(0, 128, 8):
            banks = {((c * 128 + ((q ^ (c & 7)) << 4)) // 4 + e) % 32
                     for c in range(c0, c0 + 8) for e in range(4)}
            assert len(banks) == 32


def stage_sums(a_t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 32-row stage's sums as the f32 kernels take them: each k8 step's
    lo·hi, hi·lo, hi·hi exact (f64, the model of the tensor core's sum),
    the four steps summed, rounded to f32."""
    ah, al = (t.double() for t in mu.split_tf32(a_t))
    bh, bl = (t.double() for t in mu.split_tf32(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def parent_dw(act, g, splits):
    """``dw_gemm_f32_kernel``'s dW of one 128 x 128 tile and db: per split,
    per 32-row stage (zeros past the rows), the stage's sums added to the
    f32 accumulator; db the f32 column sums in row order."""
    K = act.shape[0]
    out, db = [], []
    for k_lo, k_hi in wg.split_bounds(K, splits):
        acc = torch.zeros(act.shape[1], g.shape[1])
        s = torch.zeros(g.shape[1])
        for k0 in range(k_lo, k_hi, 32):
            a = torch.zeros(32, act.shape[1])
            b = torch.zeros(32, g.shape[1])
            n = min(k0 + 32, K) - k0
            a[:n], b[:n] = act[k0:k0 + n], g[k0:k0 + n]
            acc = acc + stage_sums(a.t(), b)
            for r in range(32):
                s = s + b[r]
        out.append(acc)
        db.append(s)
    return out, db


def kernel_dw(act, g, splits):
    """``wide_dw_f32_kernel``'s dW of one 128 x 128 tile and db from its
    reads: each stage's A boxes (TMA's swizzle) read by ``load_a_dw`` into
    fragment rows, B hi / lo from the transposers' slabs read as
    ``wgmma`` reads them, the same stage sums; the fragment rows written
    to the tile columns of the epilogue; db the transposers' sums."""
    K = act.shape[0]
    out, db = [], []
    for k_lo, k_hi in wg.split_bounds(K, splits):
        acc = torch.zeros(128, 128)  # by fragment row: warpgroup, row
        s = torch.zeros(128)
        for k0 in range(k_lo, k_hi, 32):
            a = torch.zeros(32, 128)
            b = torch.zeros(32, 128)
            n = min(k0 + 32, K) - k0
            a[:n], b[:n] = act[k0:k0 + n], g[k0:k0 + n]
            boxes = [tma_box(a[:, 32 * j:32 * j + 32]) for j in range(4)]
            frag = torch.zeros(128, 32)  # [warpgroup * 64 + fragment row, k]
            for kk in range(4):
                for wg_, w, gg, tq, box, words in fragment_reads(kk):
                    v = boxes[box][words]
                    for e in range(4):
                        row = 64 * wg_ + 16 * w + gg + 8 * (e & 1)
                        frag[row, 8 * kk + tq + 4 * (e >> 1)] = v[e]
            hi, lo = transposed_slab(b, 0), transposed_slab(b, 1)
            bh, bl = wgmma_b(hi).double(), wgmma_b(lo).double()
            ah, al = (t.double() for t in mu.split_tf32(frag))
            acc = acc + (al @ bh + ah @ bl + ah @ bh).float()
            for r in range(32):
                s = s + b[r]
        tile = torch.empty(128, 128)
        for wg_ in range(2):
            for w in range(4):
                for gg in range(8):
                    for h in range(2):
                        row = 64 * wg_ + 16 * w + gg + 8 * h
                        tile[fragment_column(wg_, w, gg, h)] = acc[row]
        out.append(tile)
        db.append(s)
    return out, db


def test_f32_kernel_reads_give_the_parent_sums():
    """Over 3 splits of 200 rows (the last short, its last stage past the
    rows), the model of the kernel's reads gives ``dw_gemm_f32_kernel``'s
    partials and db bit for bit, and their split sums lie in the f32 band
    of ``wide_dw_f32_plain``."""
    c = wg.dw_case(128, 128, 200, splits=3, seed=4, dtype=torch.float32)
    act, g = c["act"], c["g"]
    p_dw, p_db = parent_dw(act, g, 3)
    k_dw, k_db = kernel_dw(act, g, 3)
    for a, b in zip(p_dw + p_db, k_dw + k_db):
        assert torch.equal(a, b)
    dw, db = wg.wide_dw_f32_plain(c)
    close(sum(k_dw, torch.zeros(128, 128)), dw, "float32", "dW")
    close(sum(k_db, torch.zeros(128)), db, "float32", "db")


def test_db_is_the_column_sums_in_row_order():
    """The transposers' db of a split is the f32 sum of its rows in order,
    which is not the exact sum rounded on every input."""
    rng = np.random.default_rng(9)
    g = (rng.standard_normal((4096, 32)) * np.exp(
        rng.uniform(-8, 8, (4096, 1)))).astype(np.float32)
    seq = np.zeros(32, np.float32)
    for row in g:
        seq = seq + row
    _, db = parent_dw(torch.zeros(4096, 1), torch.from_numpy(g), 1)
    assert torch.equal(db[0], torch.from_numpy(seq))
    assert not np.array_equal(seq, g.astype(np.float64).sum(0)
                              .astype(np.float32))


# ---- the schedule ----

SCHEDULE = [("w288", dict(net_width=288)), ("w512", dict(net_width=512)),
            ("w1024", dict(net_width=1024)), ("w2048", dict(net_width=2048)),
            ("w1056_c288", dict(net_width=1056, net_width_condition=288)),
            ("depth63", dict(net_width=288, net_depth=63))]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,kw", SCHEDULE, ids=[s[0] for s in SCHEDULE])
def test_work_items_cover_every_tile_once(name, kw, f32):
    """Every (product, row block, column block, split) of a level once
    over its launches (bf16: 256-column products first, then 128; at most
    ``DW_MAX_JOBS`` products a launch), each launch split-major; the
    features' x rows (location_features 96) a partial row block."""
    cfg = Config(**kw)
    splits = fl.train_splits(1 << 17)
    prods = wg.dw_products(cfg)
    assert len(prods) == fl.dw_jobs(cfg)
    assert {p[2] for p in prods if p[0] == "x"} == {cfg.location_features}
    seen = Counter()
    for bn, ps in wg.dw_launch_groups(prods, f32):
        assert len(ps) <= wg.DW_MAX_JOBS
        items = wg.dw_items(ps, bn, splits)
        assert [s for *_, s in items] == sorted(s for *_, s in items)
        for jn, m0, n0, s in items:
            assert (bn == 128) if f32 else bn == wg.dw_bn(ps[jn][5])
            seen[(ps[jn], m0, n0, s)] += 1
    want = Counter()
    for p in prods:
        bn = 128 if f32 else wg.dw_bn(p[5])
        for m0 in range(0, p[2], wg.BLOCK_ROWS):
            for n0 in range(0, p[5], bn):
                for s in range(splits):
                    want[(p, m0, n0, s)] += 1
    assert seen == want
    if name == "depth63":
        assert len(wg.dw_launch_groups(prods, f32)) > 1


@pytest.mark.parametrize("K,splits", [(1 << 17, 32), (5000, 3), (777, 4),
                                      (100, 32), (96, 3), (4160, 2),
                                      (123456, 32)])
def test_split_boxes_read_each_row_once(K, splits):
    """A split starts on a multiple of 32 rows and ends on one or at K; the
    bf16 producer's 32-row boxes read its rows once, and a box past its end
    is at row K (zeros); the f32 stages of 32 rows never cross a split's
    end. (5000, 3) and (123456, 32) end splits off a 64-row stage."""
    bounds = wg.split_bounds(K, splits)
    off_stage = False
    for k_lo, k_hi in bounds:
        assert k_lo % 32 == 0
        if k_hi <= k_lo:
            assert wg.dw_box_rows(k_lo, k_hi, K) == []
            continue
        assert (k_hi - k_lo) % 32 == 0 or k_hi == K
        rows = wg.dw_box_rows(k_lo, k_hi, K)
        read = [r for row in rows if row < K
                for r in range(row, min(row + 32, K))]
        assert read == list(range(k_lo, k_hi))
        assert all(row == K or k_lo <= row < k_hi for row in rows)
        off_stage |= k_hi < K and K in rows
    assert [b for _, b in bounds if b > 0][-1] == K
    if (K, splits) in ((5000, 3), (123456, 32)):
        assert off_stage


def test_shared_memory_and_job_table_fit():
    """Each instantiation's shared memory fits the 232,448 bytes a block
    may use (4 stages at 256 columns, 6 at 128, 3 f32 stages of 64 KB),
    each stage 1024-aligned; the job table (five tensor maps and
    ``DW_MAX_JOBS`` jobs) fits the 4 KB of kernel parameters."""
    for bn, stages in ((256, 4), (128, 6)):
        assert wg.dw_stages(bn) == stages
        assert wg.dw_stage_bytes(bn) % 1024 == 0
        assert wg.dw_smem_bytes(bn) <= wg.SMEM_LIMIT
    assert wg.dw_f32_smem_bytes() <= wg.SMEM_LIMIT
    assert (4 * wg.DW_F32_PART) % 1024 == 0
    job = 2 * 8 + 8 * 4
    assert 5 * 128 + wg.DW_MAX_JOBS * job + 32 <= 4096


def test_dw_harness_needs_cuda_tensors():
    """The dW GEMMs run only on the card: their harness raises on CPU
    tensors before it loads a library, in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        c = wg.dw_case(96, 128, 64, splits=2, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
            wg.wide_dw_cuda(c)


# ---- db in bf16 and the split order ----

@pytest.mark.parametrize("splits", [1, 3])
def test_plain_bf16_db_matches_jax_train_level(monkeypatch, splits):
    """Every product of the port's plain bf16 train level at net_width 288
    (``fused_level.dense`` on a^T, g) through ``wide_db_plain``, the db the
    bf16 dW kernel now takes as its column sums (each split's rows in
    order, then the splits in order): each in the bf16 band of JAX's db of
    that layer from the interpreted ``fused_level_train``."""
    tc, tp, c, ref = level_case("bfloat16")
    N = R * tc.num_samples
    dbs = []
    dense = fl.dense

    def split_dense(h, w, d):
        if h.shape[-1] == N and h.stride(-2) == 1 and not h.is_contiguous():
            case = {"M": h.shape[0], "Nn": w.shape[1], "K": N,
                    "lda": h.shape[0], "act": h.t().to(d), "g": w.to(d),
                    "splits": splits}
            dbs.append(wg.wide_db_plain(case))
            return wg.wide_dw_plain(case)
        return dense(h, w, d)

    monkeypatch.setattr(fl, "dense", split_dense)
    keys = ("dir_enc", "t_vals", "dirs", "pixels", "g_scale")
    fl.fused_level_train(tp, tc, T(c["x"]), *(T(c[k]) for k in keys), True)
    order = layer_of_calls(tc)
    assert len(dbs) == len(order)
    for layer, db in zip(order, dbs):
        close(db.numpy(), ref[layer][1], "bfloat16", f"kernel db{layer}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_db_plain_is_row_order_then_split_order(dtype):
    """``wide_db_plain`` is bit for bit the transposers' (f32) and the db
    warps' (bf16) sums: each split's rows in order from +0 (the model of
    the kernel's reads, ``kernel_dw``, over 3 splits of 200 rows, the last
    stage past the rows), then the splits added in order from +0; and
    not the exact sum rounded once."""
    c = wg.dw_case(128, 128, 200, splits=3, seed=6, dtype=dtype)
    g = c["g"].float()
    g[5] *= 1e6  # magnitudes where the order of the adds shows
    c["g"] = g.to(dtype)
    _, k_db = kernel_dw(c["act"].float(), c["g"].float(), 3)
    want = torch.zeros(128)
    for s in k_db:
        want = want + s
    got = wg.wide_db_plain(c)
    assert torch.equal(got, want)
    exact = c["g"].double().sum(0).float()
    assert not torch.equal(got, exact)


ORDER_CASES = [("w288", dict(net_width=288)), ("w512", dict(net_width=512)),
               ("w1024", dict(net_width=1024)),
               ("w2048", dict(net_width=2048)),
               ("depth63", dict(net_width=288, net_depth=63))]


def run_split_order(items, tiles: int, grid: int, part=None):
    """The kernels' schedule and split order as a model: block b of the
    persistent grid takes items b, b + grid, ... in turn, one a round; an
    item of split k > 0 adds only once the item it waits on
    (``dw_waits_on``) has added. Returns each tile's splits in the order
    they added, each wait as (its item, the waited item), the rounds it
    took, and with ``part`` [splits, tiles, e] f32 the sums: split 0 stores
    0.0 + its partial, split k the sum so far plus its own."""
    mine = [list(range(b, len(items), grid)) for b in range(grid)]
    at = [0] * grid
    done = set()
    order = {t: [] for t in range(tiles)}
    waits = []
    out = None if part is None else np.zeros(part.shape[1:], np.float32)
    rounds = 0
    while len(done) < len(items):
        ready = []
        for b in range(grid):
            if at[b] == len(mine[b]):
                continue
            i = mine[b][at[b]]
            w = wg.dw_waits_on(i, tiles)
            if w is None or w in done:
                ready.append((b, i, w))
        assert ready, "no block can go on: the schedule deadlocks"
        for b, i, w in ready:
            split, tile = divmod(i, tiles)
            assert items[i][3] == split
            if w is not None:
                waits.append((i, w))
            order[tile].append(split)
            if part is not None:
                base = np.float32(0.0) if split == 0 else out[tile]
                out[tile] = base + part[split, tile]
            done.add(i)
            at[b] += 1
        rounds += 1
    return order, waits, rounds, out


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("grid", [132, 114, 7])
@pytest.mark.parametrize("name,kw", ORDER_CASES, ids=[s[0] for s in ORDER_CASES])
def test_split_order_model(name, kw, grid, f32):
    """Over every launch of a level (``dw_launch_groups``, past
    ``DW_MAX_JOBS`` products at depth 63) and a persistent grid of
    ``grid`` blocks: every (tile, split) adds once and each tile's splits
    add in split order; every wait is on an item the grid took in an
    earlier round or the same one, so the lowest item always goes on (the
    model never stalls); and on random partials with -0.0 entries and
    magnitudes 2^-60 to 2^60, the sums are ``_reduce``'s bit for bit."""
    cfg = Config(**kw)
    splits = fl.train_splits(1 << 17)
    rng = np.random.default_rng(grid)
    groups = wg.dw_launch_groups(wg.dw_products(cfg), f32)
    if name == "depth63":
        assert len(groups) > 1
    for bn, ps in groups:
        items = wg.dw_items(ps, bn, splits)
        tiles = len(items) // splits
        g = min(len(items), grid)
        part = (rng.standard_normal((splits, tiles, 2))
                * np.exp2(rng.uniform(-60, 60, (splits, tiles, 2))))
        part = part.astype(np.float32)
        part[:, ::5, 0] = -0.0          # every split -0: the sum is +0
        part[rng.random(part.shape) < 0.1] = -0.0
        order, waits, rounds, out = run_split_order(items, tiles, g, part)
        assert all(v == list(range(splits)) for v in order.values())
        assert len(waits) == len(items) - tiles
        assert all(w // g <= i // g for i, w in waits)
        assert rounds >= -(-len(items) // g)
        ref = wg._reduce(torch.from_numpy(part.reshape(splits, -1)))
        assert torch.equal(torch.from_numpy(out.reshape(-1)), ref)
        assert not np.signbit(out[::5, 0]).any()


def test_flag_counts_cover_every_launch():
    """The split counters a launch needs (``DW_PARTS`` a tile of the
    launch) fit ``dw_flag_count`` for one product at either column block,
    and the level's bound (``dw_flag_bound``, ``wide_dw.cuh``'s: every
    product's tiles at 128 columns, a feature product for each trunk
    layer) covers every launch of a level in both dtypes, at the widths
    above and depth 63."""
    for M, Nn in ((1024, 1024), (288, 288), (90, 1024), (1024, 128)):
        for bn in (128, 256):
            tiles = -(-M // wg.BLOCK_ROWS) * -(-Nn // bn)
            assert wg.DW_PARTS * tiles <= wg.dw_flag_count(M, Nn)
    for _, kw in ORDER_CASES:
        cfg = Config(**kw)
        bound = wg.dw_flag_bound(cfg.net_depth, cfg.net_width,
                                 cfg.net_width_condition,
                                 cfg.net_depth_condition,
                                 fl.padded_location_features(cfg))
        for f32 in (False, True):
            for bn, ps in wg.dw_launch_groups(wg.dw_products(cfg), f32):
                tiles = len(wg.dw_items(ps, bn, 1))
                assert wg.DW_PARTS * tiles <= bound
