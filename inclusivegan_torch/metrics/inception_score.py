"""IS, ported from ``inclusivegan_tpu/metrics/inception_score.py``: the
split KL of the classifier's softmax over the sampler's images. The default
classifier is the port's InceptionV3 head; without weights it is a seeded
random classifier, and the result is tagged ``_random_classifier``."""

import numpy as np

from .metric_base import MetricBase


def inception_score(probs: np.ndarray, num_splits: int):
    """(mean, std) over ``num_splits`` splits of exp(E[KL(p(y|x) || p(y))])."""
    scores = []
    for i in range(num_splits):
        part = probs[i * probs.shape[0] // num_splits:
                     (i + 1) * probs.shape[0] // num_splits]
        kl = part * (np.log(part + 1e-16) -
                     np.log(np.expand_dims(np.mean(part, 0) + 1e-16, 0)))
        scores.append(np.exp(np.mean(np.sum(kl, 1))))
    return float(np.mean(scores)), float(np.std(scores))


class IS(MetricBase):
    def __init__(self, name, num_images=50000, num_splits=10, minibatch_per_gpu=8,
                 classifier=None, num_classes=1008, classifier_weights=None, **kwargs):
        super().__init__(name)
        self.num_images = num_images
        self.num_splits = num_splits
        self.minibatch = minibatch_per_gpu
        self.classifier = classifier
        self.num_classes = num_classes
        self.classifier_weights = classifier_weights

    def _default_classifier(self, device):
        from ..models.inception import InceptionV3
        net = InceptionV3(self.classifier_weights, num_logits=self.num_classes,
                          device=device)

        def classify(images_255):
            return net.softmax_probs(images_255)

        classify.mode = net.mode
        classify.label = "InceptionV3 softmax"
        return classify

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        classify = self.classifier or self._default_classifier(sampler.device)
        probs = self._fakes_through(sampler, self.num_images, classify, self.minibatch)
        mean, std = inception_score(probs, self.num_splits)
        self._report_result(mean, suffix="_mean")
        self._report_result(std, suffix="_std")
        if getattr(classify, "mode", "pretrained") != "pretrained":
            self._report_result(1.0, suffix="_random_classifier", fmt="-1.0f")
