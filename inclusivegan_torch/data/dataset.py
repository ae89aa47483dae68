"""``SyntheticDataset``, copied from ``inclusivegan_tpu/data/dataset.py``:
deterministic random uint8 images and one-hot labels from a seed, with the
reader interface the IMLE orchestrator and the training step use. The
TFRecord reader comes with the training loop."""

import numpy as np


class SyntheticDataset:
    """Deterministic random-image dataset for tests and benchmarks."""

    def __init__(self, resolution=32, num_channels=3, num_images=256,
                 label_size=0, seed=0, **_kwargs):
        r = np.random.RandomState(seed)
        self._images = r.randint(0, 256, (num_images, num_channels,
                                          resolution, resolution)).astype(np.uint8)
        self._np_labels = np.zeros((num_images, label_size), np.float32)
        if label_size:
            self._np_labels[np.arange(num_images),
                            r.randint(label_size, size=num_images)] = 1.0
        self.shape = [num_channels, resolution, resolution]
        self.resolution = resolution
        self.resolution_log2 = int(np.log2(resolution))
        self.dynamic_range = [0, 255]
        self.label_size = label_size
        self.num_images = num_images
        self._rng = np.random.RandomState(seed + 1)

    def get_minibatch_np(self, minibatch_size):
        idx = self._rng.randint(self.num_images, size=minibatch_size)
        return self._images[idx], self._np_labels[idx]

    def get_random_labels_np(self, minibatch_size):
        idx = self._rng.randint(self.num_images, size=minibatch_size)
        return self._np_labels[idx]

    def get_all_images(self):
        return self._images

    def get_all_labels(self):
        return self._np_labels
