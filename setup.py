"""DeepSpeed-TPU build/install (ref setup.py).

Native ops JIT-compile at first use via op_builder (g++ + ctypes);
`DS_BUILD_OPS=1 python setup.py build` pre-builds them (ref setup.py:73).
"""

import os

from setuptools import setup, find_packages


def maybe_prebuild_ops():
    if os.environ.get("DS_BUILD_OPS", "0") == "1":
        import sys
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from op_builder import ALL_OPS
        for name, builder_cls in ALL_OPS.items():
            builder = builder_cls()
            if builder.is_enabled() and builder.is_compatible():
                print(f"prebuilding {name}...")
                builder.build(verbose=True)


maybe_prebuild_ops()

setup(
    name="deepspeed_tpu",
    version=open("deepspeed_tpu/version.py").read().split('"')[1],
    description="TPU-native training framework with DeepSpeed's "
                "capabilities (JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu*", "op_builder*"]),
    # the PyTorch port's CUDA kernel sources, compiled at first use
    package_data={"deepspeed_tpu_torch": ["ops/csrc/*.cu"]},
    scripts=["bin/dstpu", "bin/ds_report", "bin/ds_elastic",
             "bin/ds_trace", "bin/ds_lint"],
    install_requires=["jax", "flax", "optax", "numpy"],
    python_requires=">=3.10",
)
