from . import camera, raster
from .camera import Camera

__all__ = ["Camera", "camera", "raster"]
