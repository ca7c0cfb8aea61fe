from .params import (
    ColorMode,
    FILLED_SEED,
    Method,
    PARAM_VEC_SIZE,
    PairwiseParams,
    PMConfig,
    SimParams,
    SPHERE_RADIUS,
    SphereGeneration,
)
from .state import LANE, ParticleState, capacity_rows, cdiv, round_up
from . import generate

__all__ = [
    "ColorMode",
    "FILLED_SEED",
    "LANE",
    "Method",
    "PARAM_VEC_SIZE",
    "PairwiseParams",
    "ParticleState",
    "PMConfig",
    "SPHERE_RADIUS",
    "SimParams",
    "SphereGeneration",
    "capacity_rows",
    "cdiv",
    "generate",
    "round_up",
]
