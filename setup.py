"""Package setup for pygpr_tpu.

The native data layer (``pygpr_tpu/native/data_layer.cpp``) compiles
lazily at first use via ctypes (no build-time dependency); installing
with a C++ toolchain present simply makes that first build instant.
"""

from setuptools import find_packages, setup

setup(
    name="pygpr_tpu",
    version="0.1.0",
    description=(
        "TPU-native Gaussian-process inference engine: exact GPR, "
        "LML hyperparameter optimization, MCMC sampling, and the "
        "generalized robust Bayesian Committee Machine on JAX/XLA/Pallas"
    ),
    packages=find_packages(
        include=["pygpr_tpu", "pygpr_tpu.*", "pygpr_torch", "pygpr_torch.*"]
    ),
    package_data={
        "pygpr_tpu.native": ["data_layer.cpp"],
        # the PyTorch/CUDA port builds its kernels from these at first use
        "pygpr_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    extras_require={
        "interop": ["scikit-learn", "scipy"],
        "test": ["pytest", "scipy", "scikit-learn"],
    },
)
