from .device import get_device, resolve_device
from .metrics import dice_coefficient, iou, pixel_accuracy
from .synth import blob_sample
from .utils import png_to_grayscale_tiff, save_as_tif

__all__ = ["get_device", "resolve_device", "save_as_tif", "png_to_grayscale_tiff", "iou",
           "dice_coefficient", "pixel_accuracy", "blob_sample"]
