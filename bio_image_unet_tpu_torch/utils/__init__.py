from .device import get_device, resolve_device
from .synth import blob_sample
from .utils import save_as_tif

__all__ = ["get_device", "resolve_device", "save_as_tif", "blob_sample"]
