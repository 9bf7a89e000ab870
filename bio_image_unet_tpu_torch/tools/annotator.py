"""napari-based label painting GUI (counterpart of
``bio_image_unet_tpu/tools/annotator.py``; reference
utils/image_annotator.py:9-162).  napari/qtpy are optional — the class
raises a clear error at construction when they are absent, so the rest of
the package stays importable on headless hosts."""

from __future__ import annotations

import glob
import os

import numpy as np

from ..data import tiff


class ImageAnnotator:
    """Annotation loop: load image → paint one label layer → save uint8×255
    mask → next image ('n' keybinding or Qt button)."""

    def __init__(self, folder_images, output_folder, labels_folder=None,
                 label_name="Z-bands", brush_size=10, threshold=None):
        try:
            import napari
            from qtpy.QtWidgets import QPushButton
        except ImportError as e:  # pragma: no cover - GUI dependency
            raise ImportError(
                "ImageAnnotator requires napari and qtpy (GUI environment); "
                f"missing: {e.name}"
            ) from e

        self.folder_images = folder_images
        self.output_folder = output_folder
        self.labels_folder = labels_folder
        self.label_name = label_name
        self.brush_size = brush_size
        self.threshold = threshold
        self.list_images = sorted(glob.glob(os.path.join(folder_images, "*.tif")))
        self.current_index = 0
        os.makedirs(output_folder, exist_ok=True)

        self.viewer = napari.Viewer()
        self.labels_layer = None
        self._QPushButton = QPushButton
        self.setup_viewer()

    # -- persistence --

    def save_labels(self, labels, filename) -> None:
        tiff.imwrite(filename, labels.astype(np.uint8) * 255)

    def load_image(self, image_path):
        data = tiff.imread(image_path)
        if len(self.viewer.layers) > 0:
            self.viewer.layers[0].data = data
        else:
            self.viewer.add_image(data)
        return data

    def load_labels(self, image_path, image_shape=None):
        """Preliminary labels for an image: from ``labels_folder`` (optionally
        binarized at ``threshold``) or zeros.  Pass ``image_shape`` from an
        already-loaded image to avoid re-reading the (potentially huge) tif
        just for its shape."""
        shape = image_shape if image_shape is not None else tiff.imread(image_path).shape
        if self.labels_folder is not None:
            candidate = os.path.join(self.labels_folder, os.path.basename(image_path))
            if os.path.exists(candidate):
                labels = tiff.imread(candidate)
                if self.threshold is not None:
                    labels = (labels >= self.threshold).astype(np.uint8)
                else:
                    labels = (labels > 0).astype(np.uint8)
                return labels
        return np.zeros(shape, dtype=np.uint8)

    # -- viewer wiring (reference :128-162) --

    def next_image(self, *_):
        if self.labels_layer is not None:
            out = os.path.join(
                self.output_folder,
                os.path.basename(self.list_images[self.current_index]),
            )
            self.save_labels(np.asarray(self.labels_layer.data), out)
        self.current_index += 1
        if self.current_index >= len(self.list_images):
            print("Annotation complete.")
            self.viewer.close()
            return
        self.show_current()

    def show_current(self):
        path = self.list_images[self.current_index]
        data = self.load_image(path)
        labels = self.load_labels(path, image_shape=data.shape)
        if self.labels_layer is None:
            self.labels_layer = self.viewer.add_labels(labels, name=self.label_name)
            self.labels_layer.brush_size = self.brush_size
            self.labels_layer.mode = "paint"
        else:
            self.labels_layer.data = labels
        self.viewer.title = os.path.basename(path)

    def setup_viewer(self):
        if not self.list_images:
            raise ValueError(f"no .tif images found in {self.folder_images}")
        self.show_current()
        self.viewer.bind_key("n", self.next_image)
        button = self._QPushButton("Next image (n)")
        button.clicked.connect(lambda: self.next_image())
        self.viewer.window.add_dock_widget(button, area="left")
