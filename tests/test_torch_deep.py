"""Deep MLPs on the CPU: two train steps of the port against JAX's
``make_jitted_train_step`` at configs the port's C layer tables and dW job
tables once refused, on the fused-level branch (the plain level against
JAX's interpreted ``_level_kernel``): ``net_depth=20`` in f32 (25 or more
dW products, past one dW launch's job table of 24) and 66 layers
(``net_depth=63, net_depth_condition=1``: net_depth + net_depth_condition
+ 2 above the former 64), at the tiny widths 32 / 16. The router takes
both on every kernel without raising.

Config: ``tests/test_torch_train_step.py``'s tiny 2-level one (S=8, 16
rays, randomized=False, f32, weight decay) with the depths above.
Tolerance: the f32 parity band (1e-6, 1e-3) of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402

DEEP = {
    "depth20_f32": dict(net_depth=20),
    "layers66_f32": dict(net_depth=63, net_depth_condition=1),
}


@pytest.mark.parametrize("name", sorted(DEEP))
def test_deep_configs_route_without_raising(name):
    """Every kernel picks a route at the deep configs, in both dtypes, and
    the backward kernels' dW products pass one launch's job table."""
    for dtype in ("float32", "bfloat16"):
        cfg = tiny_config(**branch_kw("fused_level", **DEEP[name],
                                      compute_dtype=dtype))
        assert fl.dw_jobs(cfg) > 24
        assert cfg.net_depth + cfg.net_depth_condition + 2 > 64 or (
            name == "depth20_f32")
        for kernel in fl.KERNELS:
            for input_grads in ((False, True) if kernel == "mlp_bwd"
                                else (False,)):
                fl.takes_wide(cfg, kernel, cfg.num_samples, input_grads)
                assert fl.narrow_misfit(cfg, kernel, cfg.num_samples,
                                        input_grads) is None


@pytest.mark.parametrize("name", sorted(DEEP))
def test_two_steps_of_a_deep_config_match_jax(name):
    """Stats after each of two steps, then params, mu and nu."""
    check_two_steps(branch_kw("fused_level", **DEEP[name]), True)
