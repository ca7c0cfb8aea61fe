from .engine import Engine, available_methods
from .stats import FrameStats

__all__ = ["Engine", "FrameStats", "available_methods"]
