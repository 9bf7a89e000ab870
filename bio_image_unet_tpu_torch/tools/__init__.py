"""Host-side helpers of the port (counterpart of ``bio_image_unet_tpu/tools``):
so far the Siam training-input generators (``siam_inputs``).  Nothing here
needs a GUI or an external binary."""

from .siam_inputs import (generate_coupled_image, generate_coupled_image_from_self,
                          utilize_search_result)

__all__ = ["generate_coupled_image", "generate_coupled_image_from_self", "utilize_search_result"]
