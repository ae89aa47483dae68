"""FID, ported from ``inclusivegan_tpu/metrics/frechet_inception_distance.py``.

The embedder is InceptionV3's pool_3 (``feature_net="inception_v3"``, the
default) or the pooled VGG16 features of ``models/feature_nets.py``
(``feature_net="vgg"``). The reals are embedded once per (dataset args, data dir, count, network
checksum, mirror augmentation) and their mean and covariance cached; the
loop over them stops at the dataset's size. The fakes come from the
sampler's Gs. The Frechet distance is taken on the host in float64
(``np.cov``, ``scipy.linalg.sqrtm``). A random-feature embedder (no Inception
weights in the repository) tags the result ``_random_features``.
"""

import os
import pickle

import numpy as np
import scipy.linalg

from .metric_base import MetricBase


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """|mu1 - mu2|^2 + tr(sigma1 + sigma2 - 2 sqrt(sigma1 sigma2)), real part."""
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    return float(np.real(m + np.trace(sigma1 + sigma2 - 2 * s)))


class FID(MetricBase):
    def __init__(self, name, num_images=10000, minibatch_per_gpu=8,
                 feature_net="inception_v3", feature_net_weights=None, **kwargs):
        super().__init__(name)
        self.num_images = num_images
        self.minibatch = minibatch_per_gpu
        self.feature_net = feature_net
        self.feature_net_weights = feature_net_weights

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        if self.feature_net == "inception_v3":
            from ..models.inception import InceptionV3
            feat_net = InceptionV3(self.feature_net_weights, device=sampler.device)
        else:
            from ..models.feature_nets import VGGFeatureNet
            feat_net = VGGFeatureNet(self.feature_net_weights, device=sampler.device)

        cache = self._get_cache_file(dataset_args=repr(dataset_args), data_dir=data_dir,
                                     num_images=self.num_images,
                                     net=feat_net.checksum(),
                                     mirror_augment=self._mirror_augment)
        if os.path.isfile(cache):
            with open(cache, "rb") as f:
                mu_real, sigma_real = pickle.load(f)
        else:
            dataset = self._open_dataset(dataset_args, data_dir)
            feats = []
            done = 0
            while done < self.num_images and done < dataset.num_images:
                imgs, _ = self._reals_batch(
                    dataset, min(self.minibatch, self.num_images - done))
                feats.append(feat_net(imgs.astype(np.float32)))
                done += imgs.shape[0]
            feats = np.concatenate(feats)
            mu_real = np.mean(feats, axis=0)
            sigma_real = np.cov(feats, rowvar=False)
            with open(cache, "wb") as f:
                pickle.dump((mu_real, sigma_real), f)

        feats = self._fakes_through(sampler, self.num_images, feat_net, self.minibatch)
        mu_fake = np.mean(feats, axis=0)
        sigma_fake = np.cov(feats, rowvar=False)
        self._report_result(frechet_distance(mu_fake, sigma_fake, mu_real, sigma_real))
        if feat_net.mode != "pretrained":
            self._report_result(1.0, suffix="_random_features", fmt="-1.0f")
