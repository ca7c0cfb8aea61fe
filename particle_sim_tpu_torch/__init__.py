"""particle_sim_tpu_torch — the PyTorch + CUDA port of particle_sim_tpu.

The JAX package ``particle_sim_tpu`` is the reference; this package mirrors
its layout (core/ ops/ render/ engine/ io/ app/ utils/) module for module.
Plain tensor code is PyTorch; the kernels on the main path are hand-written
CUDA C++ for Hopper (csrc/), built with nvcc at first use. It never imports
jax or particle_sim_tpu.
"""

from .core import (
    ColorMode,
    Method,
    ParticleState,
    SimParams,
    SphereGeneration,
    generate,
)

__version__ = "0.1.0"

__all__ = [
    "ColorMode",
    "Method",
    "ParticleState",
    "SimParams",
    "SphereGeneration",
    "generate",
]
