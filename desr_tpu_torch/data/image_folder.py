"""Recursive image-folder listing (counterpart of ``desr_tpu/data/image_folder.py``)."""

from __future__ import annotations

import os

IMG_EXTENSIONS = [
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM",
    ".bmp", ".BMP", ".tif", ".TIF", ".tiff", ".TIFF", ".npy",
]


def is_image_file(filename):
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def make_dataset(directory, max_dataset_size=2 ** 31):
    if not os.path.isdir(directory):
        raise NotADirectoryError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[: min(max_dataset_size, len(images))]
