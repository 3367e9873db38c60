"""PyTorch port: K7-band's twin at the Hopper tile pair against the
JAX package, fp32 (the cases of tests/test_torch_sparse_attention.py's
band twin, split by dtype to spread the test clock over workers).
Tolerances as set out in tests/test_torch_sparse_attention.py.
"""

import pytest
import torch

from torch_sparse_cases import band_twin_case
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", [torch.float32], ids=["fp32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["sliding", "aligned"])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 256])
def test_hopper_band_twin_matches_jax(block, kind, causal, dtype):
    """The band twin at the Hopper body's 128 x 64 tile pair against the
    JAX package's band kernel in interpret mode (`band_twin_case`), in
    fp32."""
    band_twin_case(block, kind, causal, dtype)
