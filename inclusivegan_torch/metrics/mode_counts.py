"""Stacked-MNIST mode coverage (``mode_counts_24k``), ported from
``inclusivegan_tpu/metrics/mode_counts.py``: the number of distinct
classifier modes (at most 1000) among ``num_images`` fakes, and, from the
same pass, their KL to uniform (``_KL``)."""

import numpy as np

from .KL import fake_modes, kl_to_uniform
from .metric_base import MetricBase


class ModeCounts(MetricBase):
    def __init__(self, name, num_images=24576, minibatch_per_gpu=32,
                 classifier_weights=None, **kwargs):
        super().__init__(name)
        self.num_images = num_images
        self.minibatch = minibatch_per_gpu
        self.classifier_weights = classifier_weights

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        modes, clf = fake_modes(self, sampler, self.num_images, self.classifier_weights)
        self._report_result(float(count_modes(modes)), fmt="-6.0f")
        self._report_result(kl_to_uniform(modes), suffix="_KL")
        if clf.mode != "pretrained":
            self._report_result(1.0, suffix="_untrained_classifier", fmt="-1.0f")


def count_modes(modes: np.ndarray) -> int:
    return int(len(np.unique(modes)))
