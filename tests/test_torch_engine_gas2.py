"""PyTorch port: the training engine against the JAX engine at gradient
accumulation 2: the loss trajectory over 10 steps, as
tests/test_torch_engine.py holds it at gas 1 (split out of it, whose
module fixture it shares, to spread the test clock over workers; the
tolerance as set out there).
"""

import pytest

from test_torch_engine import check_loss_trajectory
from test_torch_engine import jax_model_and_tree  # noqa: F401 (the fixture)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("gas", [2])
def test_loss_trajectory_matches_jax_engine(jax_model_and_tree, gas):
    check_loss_trajectory(jax_model_and_tree, gas)
