"""Records the device kernels that one call of each profiled case of
tests/test_torch_cuda.py runs, by torch.profiler, in a process of its
own, and prints them as one JSON object on its last line:
{case: [[kernel name, launches], ...]} for each of K3-bwd's edge cases
(`LN_BWD_EDGES`) and for "ln_fwd_bf16_vectors" (K3-fwd with bf16
vectors). The card tests' `device_kernels` fixture runs it:

    python tests/torch_profile_cases.py

Each case's call runs once before its profiled region (the kernel's
first launch in the process loads its module), then once inside it,
with the device synchronised before the region closes."""

import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import test_torch_cuda as cases  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import fused_ops as tfo  # noqa: E402


def device_kernels(fn):
    """[[name, launches], ...] of the device kernels one call of fn runs."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key, e.count] for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def main():
    dev = torch.device("cuda")
    recorded = {}
    for case in cases.LN_BWD_EDGES:
        args = cases._ln_bwd_edge_inputs(dev, case)
        recorded[case] = device_kernels(
            lambda: tfo.fused_bias_residual_layernorm_backward(*args))
    args = cases._ln_fwd_bf16_vectors_inputs(dev)
    recorded["ln_fwd_bf16_vectors"] = device_kernels(
        lambda: tfo.fused_bias_residual_layernorm(*args))
    print(json.dumps(recorded))


if __name__ == "__main__":
    main()
