"""The port's MLP against the JAX package's, from the same flat params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402

SMALL = dict(net_depth=5, net_width=32, net_width_condition=16, skip_layer=2,
             max_deg_point=4)


def test_layer_dims_and_sizes_match_jax():
    for kw in ({}, SMALL):
        t, j = Config(**kw), JConfig(**kw)
        assert tmlp.layer_dims(t) == jmlp.layer_dims(j)
        assert tmlp.layer_sizes(t) == jmlp.layer_sizes(j)
        assert tmlp.num_params(t) == jmlp.num_params(j)
    assert tmlp.num_params(Config()) == 546948


def test_flat_roundtrip_against_jax():
    jc, tc = JConfig(**SMALL), Config(**SMALL)
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), jc)
    flat = jmlp.export_flat(jp)
    tp = tmlp.import_flat(flat, tc)
    np.testing.assert_array_equal(tmlp.export_flat(tp), flat)
    for (tw, tb), (jw, jb) in zip(tp, jp):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    with pytest.raises(ValueError):
        tmlp.import_flat(flat[:-1], tc)


def test_params_from_jax_and_init():
    jc, tc = JConfig(**SMALL), Config(**SMALL)
    jp = jmlp.init_mlp(jax.random.PRNGKey(1), jc)
    tp = tmlp.params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in jp])
    np.testing.assert_array_equal(tmlp.export_flat(tp), jmlp.export_flat(jp))
    init = tmlp.init_mlp(torch.Generator().manual_seed(0), tc)
    assert [tuple(w.shape) for w, _ in init] == tmlp.layer_dims(tc)
    assert all(float(b.abs().max()) == 0.0 for _, b in init)
    again = tmlp.init_mlp(torch.Generator().manual_seed(0), tc)
    np.testing.assert_array_equal(tmlp.export_flat(init),
                                  tmlp.export_flat(again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches_jax(dtype):
    jc, tc = JConfig(**SMALL), Config(**SMALL)
    jp = jmlp.init_mlp(jax.random.PRNGKey(2), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 8, tc.location_features)).astype(np.float32)
    d = rng.normal(size=(6, tc.direction_features)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j_rgb, j_den = jmlp.apply_mlp(jp, jc, jnp.asarray(x), jnp.asarray(d),
                                  compute_dtype=jdt)
    t_rgb, t_den = tmlp.apply_mlp(tp, tc, torch.from_numpy(x),
                                  torch.from_numpy(d), compute_dtype=tdt)
    assert t_rgb.dtype == torch.float32 and tuple(t_rgb.shape) == (6, 8, 3)
    assert tuple(t_den.shape) == (6, 8, 1)
    if dtype == "float32":
        np.testing.assert_allclose(t_rgb.numpy(), j_rgb, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t_den.numpy(), j_den, rtol=1e-4, atol=1e-5)
    else:
        atol, rtol = PARITY_BANDS["bfloat16"]
        assert normalized_err(t_rgb.numpy(), j_rgb, atol, rtol) < 1.0
        assert normalized_err(t_den.numpy(), j_den, atol, rtol) < 1.0
