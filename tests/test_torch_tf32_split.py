"""The f32 kernels' 3xTF32 arithmetic, modelled on the CPU by
``ops/math_utils.py`` (``tf32_round``, ``split_tf32``, ``dense_3xtf32``),
against exact references and the JAX package:

- ``tf32_round`` follows ``cvt.rna.tf32.f32`` on chosen bit patterns
  (ties away from zero, subnormals, overflow, inf, NaN, signed zeros);
- ``hi + lo`` rebuilds x within 2^-22 of |x| over the exponents where lo
  is a normal number, and both parts are TF32 values;
- every layer product of ``layer_dims(Config())`` (the forward, the
  g-chain's g @ W^T and dW = a^T g), through the split, within the f32
  band of the f64 product, on activations from a forward of the seeded
  model;
- the plain f32 train level (``level_train_plain``) and render level with
  every layer product routed through ``dense_3xtf32`` against the JAX
  package's f32 level (Pallas, interpret mode), as
  ``tests/test_torch_train_level.py`` and ``tests/test_torch_fused_level.py``
  run it: narrow widths, ``Config()`` widths with a few rays, and the f32
  wide route's net_width 288 and 512 (depth 3, net_width_condition 128).

The model does not fix the card's order of f32 sums; the card tests and
``chip_smoke.py`` hold the kernels against their plain versions.
Tolerance: the f32 parity band (1e-6, 1e-3) of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_render as j_render,
)
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
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import math_utils as mu  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
ATOL, RTOL = PARITY_BANDS["float32"]
NARROW = dict(net_depth=3, net_width=32, net_depth_condition=1,
              net_width_condition=16, skip_layer=2, max_deg_point=4,
              num_samples=8)
# Config() widths (8 x 256, view 128, the paper's encodings), few samples
WIDE = dict(num_samples=16)


def bits_to_f32(b: int) -> float:
    return struct.unpack("<f", struct.pack("<I", b))[0]


def f32_bits(t: torch.Tensor) -> list:
    return [v & 0xFFFFFFFF for v in t.view(torch.int32).tolist()]


# (input bit pattern, cvt.rna.tf32.f32's result): 13 low bits rounded off,
# to nearest, ties away from zero.
RNA_CASES = [
    (0x3F800000, 0x3F800000),  # 1.0: exact
    (0x40490FDB, 0x40490000),  # pi: down
    (0x3F800FFF, 0x3F800000),  # just under the half-way point
    (0x3F801000, 0x3F802000),  # tie, even below: away from zero (RNE: down)
    (0x3F803000, 0x3F804000),  # tie, odd below: away from zero
    (0xBF801000, 0xBF802000),  # negative tie: away from zero
    (0x3F801001, 0x3F802000),  # just over the half-way point
    (0x3FFFF000, 0x40000000),  # carry into the exponent
    (0x00001000, 0x00002000),  # subnormal tie: away from zero
    (0x00000FFF, 0x00000000),  # smallest subnormals round to zero
    (0x80000FFF, 0x80000000),  # ... and keep the sign
    (0x007FF000, 0x00800000),  # largest subnormals: to the smallest normal
    (0x7F7FEFFF, 0x7F7FE000),  # largest finite TF32
    (0x7F7FF000, 0x7F800000),  # past it: inf
    (0xFF7FF000, 0xFF800000),
    (0x7F800000, 0x7F800000),  # inf
    (0xFF800000, 0xFF800000),  # -inf
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
]


@pytest.mark.parametrize("bits,expected", RNA_CASES,
                         ids=[f"{b:08x}" for b, _ in RNA_CASES])
def test_tf32_round_follows_cvt_rna(bits, expected):
    x = torch.tensor([bits_to_f32(bits)], dtype=torch.float32)
    assert f32_bits(mu.tf32_round(x)) == [expected]


def test_tf32_round_keeps_nan():
    x = torch.tensor([bits_to_f32(b) for b in
                      (0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFC00000)])
    assert bool(torch.isnan(mu.tf32_round(x)).all())


def test_split_rebuilds_x_within_2_to_the_minus_22():
    """Exponents where lo is still a normal number (|x| >= ~2^-114; below,
    lo is subnormal and keeps fewer bits)."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 200000)
    expo = rng.integers(-110, 120, 200000).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], 200000)
    x = torch.from_numpy((sign * mant * 2.0 ** expo).astype(np.float32))
    hi, lo = mu.split_tf32(x)
    for part in (hi, lo):  # both are TF32 values: 13 low bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # one TF32 value alone keeps ~11 bits: the low part matters
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -13


def forward_case(cfg: Config, R: int, seed: int):
    """The seeded model, seeded numpy inputs and the plain f32 forward's
    activations."""
    S = cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    x = T((rng.normal(size=(R * S, cfg.location_features)) * 0.5)
          .astype(np.float32))
    d = T((rng.normal(size=(R, cfg.direction_features)) * 0.5)
          .astype(np.float32))
    _, _, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S,
                                       torch.float32)
    return params, x, d, hs, vs, rng


def layer_inputs(cfg: Config, x, d, hs, vs, S: int):
    """Each layer's input rows, as the kernels multiply them: [h | x] at
    the skip layers, [h | d of the row's ray] at the first view layer."""
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    ins = []
    for i in range(D):
        if i == 0:
            ins.append(x)
        elif i % cfg.skip_layer == 0:
            ins.append(torch.cat([hs[i - 1], x], -1))
        else:
            ins.append(hs[i - 1])
    ins.append(hs[-1])
    ins.append(torch.cat([hs[-1], d.repeat_interleave(S, 0)], -1))
    ins += vs[:-1]
    ins.append(vs[-1])
    assert len(ins) == D + 2 + Dc
    return ins


@pytest.mark.parametrize("layer", range(len(tmlp.layer_dims(Config()))))
def test_layer_products_through_the_split_within_f32_band(layer):
    """The forward product a @ W, the chain product g @ W^T and dW = a^T g
    of one layer of Config() through the split, against f64."""
    cfg = Config(compute_dtype="float32", num_samples=32)
    params, x, d, hs, vs, rng = forward_case(cfg, 4, seed=layer)
    a = layer_inputs(cfg, x, d, hs, vs, cfg.num_samples)[layer]
    w = params[layer][0]
    assert tuple(w.shape) == tmlp.layer_dims(cfg)[layer] == (
        a.shape[1], w.shape[1])
    g = T(rng.normal(size=(a.shape[0], w.shape[1])).astype(np.float32))
    g = g * (T(rng.uniform(size=g.shape)) > 0.5)  # a ReLU mask's zeros
    for name, lhs, rhs in (("forward", a, w), ("chain", g, w.t()),
                           ("dW", a.t(), g)):
        got = mu.dense_3xtf32(lhs.contiguous(), rhs.contiguous())
        ref = lhs.double() @ rhs.double()
        assert got.dtype == torch.float32
        assert normalized_err(got.double().numpy(), ref.numpy(), ATOL,
                              RTOL) < 1.0, name
        # one TF32 pass alone would not always be: the split is what holds
        one = (mu.tf32_round(lhs).double() @ mu.tf32_round(rhs).double())
        assert float((one - ref).abs().max()) > float(
            (got.double() - ref).abs().max()), name


@pytest.fixture
def split_products(monkeypatch):
    """Route every layer product of the plain level versions
    (``fused_level.dense``) through ``dense_3xtf32``; count the calls."""
    calls = []

    def dense(h, w, dt):
        assert dt == torch.float32
        calls.append(tuple(h.shape))
        return mu.dense_3xtf32(h.to(dt).float(), w.to(dt).float())

    monkeypatch.setattr(fl, "dense", dense)
    return calls


def level_case(kw, R: int, seed: int):
    jc = JConfig(compute_dtype="float32", **kw)
    tc = Config(compute_dtype="float32", **kw)
    S = tc.num_samples
    rng = np.random.default_rng(seed)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    mask = rng.uniform(0.5, 2.0, R).astype(f32)
    mask[::3] = 0.0
    c = dict(
        means=rng.normal(size=(R, S, 3)).astype(f32),
        covs=rng.uniform(0, 0.02, size=(R, S, 3)).astype(f32),
        x=(rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32),
        dir_enc=(rng.normal(size=(R, 27)) * 0.5).astype(f32),
        t_vals=np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(f32),
        dirs=rng.normal(size=(R, 3)).astype(f32),
        pixels=rng.uniform(size=(R, 3)).astype(f32),
        g_scale=(0.1 * 2.0 * mask / mask.sum())[:, None].astype(f32),
    )
    return jc, tc, jp, tp, c


def close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    err = normalized_err(a, b, ATOL, RTOL)
    assert err < 1.0, (what, err)


# the wide f32 route's widths (csrc/wide_f32.cuh): 288, a partial column
# block of its GEMM, and 512
WIDE_288 = dict(NARROW, net_width=288, net_width_condition=128)
WIDE_512 = dict(NARROW, net_width=512, net_width_condition=128)
LEVEL_CASES = [("narrow", NARROW, 6, "t", True), ("narrow", NARROW, 5, "mv",
                                                   False),
               ("config_widths", WIDE, 2, "t", True),
               ("wide_288", WIDE_288, 4, "t", True),
               ("wide_512", WIDE_512, 4, "mv", False)]


@pytest.mark.parametrize("name,kw,R,mode,white_bkgd", LEVEL_CASES,
                         ids=[f"{c[0]}_{c[3]}" for c in LEVEL_CASES])
def test_train_level_with_split_products_matches_jax(split_products, name,
                                                     kw, R, mode, white_bkgd):
    jc, tc, jp, tp, c = level_case(kw, R, seed=1)
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]),
                J(c["pixels"]), J(c["g_scale"]), white_bkgd)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]),
                T(c["pixels"]), T(c["g_scale"]), white_bkgd)
    if mode == "mv":
        ref = j_train(jp, jc, None, *common_j, tile=16,
                      means_covs=(J(c["means"]), J(c["covs"])))
        port = fl.fused_level_train(tp, tc, None, *common_t,
                                    means_covs=(T(c["means"]), T(c["covs"])))
    else:
        ref = j_train(jp, jc, J(c["x"]), *common_j, tile=16)
        port = fl.fused_level_train(tp, tc, T(c["x"]), *common_t)
    # forward, chain and dW products of every layer went through the split
    assert len(split_products) >= 3 * tc.net_depth
    for what, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
        close(a.numpy(), b, what)
    assert len(port[3]) == len(ref[3]) == len(tmlp.layer_dims(tc))
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
        close(dw.numpy(), rw, f"dW{i}")
        close(db.numpy(), rb, f"db{i}")


@pytest.mark.parametrize("name,kw,R,mode,white_bkgd", LEVEL_CASES,
                         ids=[f"{c[0]}_{c[3]}" for c in LEVEL_CASES])
def test_render_level_with_split_products_matches_jax(split_products, name,
                                                      kw, R, mode,
                                                      white_bkgd):
    jc, tc, jp, tp, c = level_case(kw, R, seed=2)
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]), white_bkgd)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]), white_bkgd)
    if mode == "mv":
        ref = j_render(jp, jc, None, *common_j, tile=16,
                       means_covs=(J(c["means"]), J(c["covs"])))
        port = fl.fused_level_render(tp, tc, None, *common_t,
                                     means_covs=(T(c["means"]),
                                                 T(c["covs"])))
    else:
        ref = j_render(jp, jc, J(c["x"]), *common_j, tile=16)
        port = fl.fused_level_render(tp, tc, T(c["x"]), *common_t)
    assert len(split_products) >= tc.net_depth
    for what, a, b in zip(("comp", "acc", "weights"), port, ref):
        close(a.numpy(), b, what)
