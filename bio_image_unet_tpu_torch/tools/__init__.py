"""Host-side helpers of the port (counterpart of ``bio_image_unet_tpu/tools``;
the reference's L6 tools: siam_unet/helpers/*, utils/image_annotator.py):
frame search, folder image operations, movie export, the napari annotator,
the Siam training-input generators and host/device introspection.

All host-side; external binaries (ffmpeg) and GUI or plotting packages
(napari, cv2, matplotlib) are imported at call time, so the package imports
without them.
"""

from .annotator import ImageAnnotator
from .frame_search import (
    fetch_frame,
    find_frame_of_image,
    frame_generator,
    individual_tif_generator,
    mse,
    stream_write,
)
from .imageops import (
    average_tifs,
    create_pixel_value_histogram,
    generate_plain_image,
    threshold_images,
)
from .movie import (
    compare_videos_vstack,
    create_zoomed_in_comparison,
    crop_zoom,
    extract_frames,
    tif_to_mp4,
)
from .siam_inputs import (
    generate_coupled_image,
    generate_coupled_image_from_self,
    utilize_search_result,
)
from .sysinfo import (
    cpu_count,
    device_test,
    get_info_file_header,
    md5sum,
    md5sum_folder,
    write_info_file,
)

__all__ = [
    "ImageAnnotator",
    "generate_coupled_image",
    "generate_coupled_image_from_self",
    "utilize_search_result",
    "find_frame_of_image",
    "frame_generator",
    "fetch_frame",
    "individual_tif_generator",
    "stream_write",
    "mse",
    "tif_to_mp4",
    "extract_frames",
    "compare_videos_vstack",
    "create_zoomed_in_comparison",
    "crop_zoom",
    "average_tifs",
    "threshold_images",
    "generate_plain_image",
    "create_pixel_value_histogram",
    "device_test",
    "cpu_count",
    "md5sum",
    "md5sum_folder",
    "get_info_file_header",
    "write_info_file",
]
