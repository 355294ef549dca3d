"""The port's Config mirrors the JAX Config field for field."""

import dataclasses
import enum

import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import config as jcfg  # noqa: E402
from nerf_or_nothing_tpu_torch import config as tcfg  # noqa: E402


def _plain(v):
    return v.value if isinstance(v, enum.Enum) else v


def test_fields_types_defaults_match_jax():
    jf = dataclasses.fields(jcfg.Config)
    tf = dataclasses.fields(tcfg.Config)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type, a.name
        assert _plain(a.default) == _plain(b.default), a.name


@pytest.mark.parametrize("factory", ["tiny_config", "full_config"])
def test_factories_match_jax(factory):
    t = getattr(tcfg, factory)(num_samples=16)
    j = getattr(jcfg, factory)(num_samples=16)
    for f in dataclasses.fields(tcfg.Config):
        assert _plain(getattr(t, f.name)) == _plain(getattr(j, f.name)), f.name
    for prop in ("location_features", "direction_features",
                 "num_location_encodings", "num_direction_encodings"):
        assert getattr(t, prop) == getattr(j, prop)


def test_parse_flags_agrees_with_jax():
    flags = [
        "--batch-size=64", "--lr-init=1e-3", "--white-bkgd=false",
        "--dataset-loader=LLFF", "--ray-shape=cylinder", "--mesh-shape=4,2",
        "--compute-dtype=float32", "--datadir=/tmp/x", "--LLFFHold=4",
        "--kernel-probes=fr_tile=2048", "--use_pallas=0", "positional",
    ]
    t = tcfg.parse_flags(flags)
    j = jcfg.parse_flags(flags)
    for f in dataclasses.fields(tcfg.Config):
        assert _plain(getattr(t, f.name)) == _plain(getattr(j, f.name)), f.name
    assert t.probe("fr_tile") == "2048" == j.probe("fr_tile")


def test_parse_flags_unknown_flag_raises():
    with pytest.raises(ValueError, match="unknown flag"):
        tcfg.parse_flags(["--no-such-flag=1"])
