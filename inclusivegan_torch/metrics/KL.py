"""Stacked-MNIST KL divergence (``KL24k``), ported from
``inclusivegan_tpu/metrics/KL.py``: KL(histogram of the fakes' modes ||
uniform over 1000) over ``num_images`` fakes, classified by
``StackedMNISTClassifier``."""

import numpy as np

from .metric_base import MetricBase


def kl_to_uniform(modes: np.ndarray, num_modes: int = 1000) -> float:
    hist = np.bincount(modes, minlength=num_modes).astype(np.float64)
    p = hist / hist.sum()
    q = 1.0 / num_modes
    nz = p > 0
    return float(np.sum(p[nz] * np.log(p[nz] / q)))


def fake_modes(metric: MetricBase, sampler, num_images: int, classifier_weights):
    """The mode of each of ``num_images`` fakes, and the classifier."""
    from ..models.feature_nets import StackedMNISTClassifier
    clf = StackedMNISTClassifier(classifier_weights, device=sampler.device)
    modes = metric._fakes_through(sampler, num_images, clf, num_images)
    return modes, clf


class KL(MetricBase):
    def __init__(self, name, num_images=24576, minibatch_per_gpu=32,
                 classifier_weights=None, **kwargs):
        super().__init__(name)
        self.num_images = num_images
        self.minibatch = minibatch_per_gpu
        self.classifier_weights = classifier_weights

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        modes, clf = fake_modes(self, sampler, self.num_images, self.classifier_weights)
        self._report_result(kl_to_uniform(modes))
        if clf.mode != "pretrained":
            self._report_result(1.0, suffix="_untrained_classifier", fmt="-1.0f")
