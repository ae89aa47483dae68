"""The dataset writer and the CelebA attribute reader, copied from
``inclusivegan_tpu/data/dataset_tool.py``.

``TFRecordExporter`` writes one ``<name>-r{log2res:02d}.tfrecords`` per
resolution (a 2x2 box-filter pyramid down to 4x4) plus ``<name>-rxx.labels``
(float32 .npy). The dataset creators and the verification commands of the
JAX package's tool are not ported: ``dataset_tool.py`` at the root of the
repo writes the same files.
"""

import os

import numpy as np

from . import tfrecord


class TFRecordExporter:
    def __init__(self, tfrecord_dir: str, expected_images: int,
                 print_progress: bool = True, progress_interval: int = 10):
        self.tfrecord_dir = tfrecord_dir
        self.tfr_prefix = os.path.join(tfrecord_dir,
                                       os.path.basename(tfrecord_dir))
        self.expected_images = expected_images
        self.cur_images = 0
        self.shape = None
        self.resolution_log2 = None
        self.tfr_files = []
        self.print_progress = print_progress
        self.progress_interval = progress_interval
        os.makedirs(tfrecord_dir, exist_ok=True)
        self._writers = []

    def set_shape(self, shape):
        self.shape = list(shape)
        self.resolution_log2 = int(np.log2(self.shape[1]))
        assert self.shape[0] in (1, 3)
        assert self.shape[1] == self.shape[2] == 2 ** self.resolution_log2
        for lod in range(self.resolution_log2 - 1):
            path = f"{self.tfr_prefix}-r{self.resolution_log2 - lod:02d}.tfrecords"
            self.tfr_files.append(path)
            self._writers.append(open(path, "wb"))

    def add_image(self, img: np.ndarray):
        if self.print_progress and self.cur_images % self.progress_interval == 0:
            print(f"{self.cur_images} / {self.expected_images}\r", end="",
                  flush=True)
        if self.shape is None:
            self.set_shape(img.shape)
        assert list(img.shape) == self.shape
        img = img.astype(np.float32)
        for lod, writer in enumerate(self._writers):
            if lod:
                img = (img[:, 0::2, 0::2] + img[:, 0::2, 1::2] +
                       img[:, 1::2, 0::2] + img[:, 1::2, 1::2]) * 0.25
            quant = np.rint(img).clip(0, 255).astype(np.uint8)
            tfrecord.write_record(writer, tfrecord.encode_image_example(quant))
        self.cur_images += 1

    def add_labels(self, labels: np.ndarray):
        if self.print_progress:
            print(f"{self.cur_images} / {self.expected_images}")
        assert labels.shape[0] == self.cur_images
        with open(self.tfr_prefix + "-rxx.labels", "wb") as f:
            np.save(f, labels.astype(np.float32))

    def close(self):
        for w in self._writers:
            w.close()
        self._writers = []
        if self.print_progress:
            print(f"Added {self.cur_images} images.")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_celeba_attributes(attr_file: str):
    """Parse list_attr_celeba.txt -> (attr_names, {filename: 0/1 vector}),
    for the IMLE minority-attribute filter (``--attr-interesting``)."""
    with open(attr_file) as f:
        lines = f.read().splitlines()
    attr_names = lines[1].split()
    table = {}
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        vals = np.array([1.0 if v == "1" else 0.0 for v in parts[1:]],
                        np.float32)
        table[parts[0]] = vals
    return attr_names, table
