from . import tiff

__all__ = ["tiff"]
