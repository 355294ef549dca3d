"""Config variants of the train step on the CPU: two steps of the port
against JAX's ``make_jitted_train_step`` without view directions, with the
multiscale loss off, and with one and three levels, on the fused-level
branch (the plain level on the CPU against JAX's interpreted
``_level_kernel``) and the autograd branch (use_pallas=False).

Config: ``tests/test_torch_train_step.py``'s tiny 2-level one (depth 3,
width 32/16, skip at 2, S=8, 16 rays, randomized=False, f32, weight
decay), changed in one field. Tolerance: the f32 parity band (1e-6, 1e-3)
of ``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import pytest
import torch

torch.set_num_threads(2)

from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402

VARIANTS = {
    "no_viewdirs": dict(use_viewdirs=False),
    "no_multiscale_loss": dict(disable_multiscale_loss=True),
    "one_level": dict(num_levels=1),
    "three_levels": dict(num_levels=3),
}


@pytest.mark.parametrize("branch", ["fused_level", "autograd"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_steps_of_a_variant_match_jax(variant, branch):
    """Stats after each of two steps, then params, mu and nu."""
    check_two_steps(branch_kw(branch, **VARIANTS[variant]),
                    branch == "fused_level")
