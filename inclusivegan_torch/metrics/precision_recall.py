"""k-NN precision and recall (``pr50k3``), ported from
``inclusivegan_tpu/metrics/precision_recall.py``.

Each manifold is a set of feature vectors with the squared distance to each
one's k-th nearest neighbour as its radius. Precision is the share of fake
features inside any real ball, recall the share of real features inside
any fake ball. Distances are ``aa - 2ab + bb`` clamped at 0, through
``torch.matmul`` (float32; TF32 stays off, as ``run_metrics.main`` sets it),
in row blocks of 2048 and column blocks of 4096 as in the JAX package. The
features and one row block of distances stay on the device: at 50000
features of 1472 dimensions, 0.29 GB and 0.41 GB.

A finding about the reference, mirrored: the registry gives ``pr50k3``
``row_batch_size=10000`` and ``col_batch_size=10000``, but the JAX class
never stores them (``PR.__init__``), and ``knn_precision_recall_features``
builds each ``ManifoldEstimator`` with its own defaults; the blocks change
no result, only memory. The JAX metric gives its ``VGGFeatureNet`` no
weights, so it runs on random features and tags ``_random_features``; so
does the port.
"""

import time

import numpy as np
import torch

from .metric_base import MetricBase


def _pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, F] x [N, F] -> squared L2 distances [M, N]."""
    aa = a.square().sum(dim=1, keepdim=True)
    bb = b.square().sum(dim=1, keepdim=True)
    return torch.clamp_min(aa - 2 * (a @ b.T) + bb.T, 0.0)


class ManifoldEstimator:
    def __init__(self, features, nhood_size: int = 3, row_batch: int = 2048,
                 col_batch: int = 4096, device="cuda"):
        self._features = torch.as_tensor(np.asarray(features, np.float32), device=device)
        self.nhood_size = nhood_size
        self.row_batch = row_batch
        self.col_batch = col_batch
        n = self._features.shape[0]
        radii = torch.empty(n, device=self._features.device)
        for r0 in range(0, n, row_batch):
            rows = self._features[r0:r0 + row_batch]
            d2 = torch.empty((rows.shape[0], n), device=rows.device)
            for c0 in range(0, n, col_batch):
                d2[:, c0:c0 + col_batch] = _pairwise_d2(rows, self._features[c0:c0 + col_batch])
            # the value at index nhood_size with the self column (distance
            # 0) included, as np.partition gives it: the k-th neighbour
            radii[r0:r0 + rows.shape[0]] = torch.kthvalue(d2, nhood_size + 1, dim=1).values
        self.radii2 = radii

    def evaluate(self, eval_features) -> np.ndarray:
        """Per eval feature, 1 if it falls inside any reference point's
        k-th-neighbour ball, else 0."""
        ef = torch.as_tensor(np.asarray(eval_features, np.float32),
                             device=self._features.device)
        m = self._features.shape[0]
        out = []
        for r0 in range(0, ef.shape[0], self.row_batch):
            rows = ef[r0:r0 + self.row_batch]
            hit = torch.zeros(rows.shape[0], dtype=torch.bool, device=ef.device)
            for c0 in range(0, m, self.col_batch):
                d2 = _pairwise_d2(rows, self._features[c0:c0 + self.col_batch])
                hit |= (d2 <= self.radii2[c0:c0 + self.col_batch][None, :]).any(dim=1)
            out.append(hit)
        return torch.cat(out).float().cpu().numpy()


def knn_precision_recall_features(ref_features, eval_features, nhood_size=3,
                                  device="cuda"):
    """precision: eval points inside the reference manifold; recall:
    reference points inside the eval manifold."""
    ref_mfold = ManifoldEstimator(ref_features, nhood_size, device=device)
    eval_mfold = ManifoldEstimator(eval_features, nhood_size, device=device)
    precision = ref_mfold.evaluate(eval_features).mean()
    recall = eval_mfold.evaluate(ref_features).mean()
    return dict(precision=float(precision), recall=float(recall))


class PR(MetricBase):
    def __init__(self, name, num_images=50000, nhood_size=3, minibatch_per_gpu=8,
                 row_batch_size=2048, col_batch_size=4096, feature_net_weights=None,
                 **kwargs):
        # row_batch_size and col_batch_size are not stored, as in the JAX
        # package: the estimators keep their blocks of 2048 and 4096
        super().__init__(name)
        self.num_images = num_images
        self.nhood_size = nhood_size
        self.minibatch = minibatch_per_gpu
        self.feature_net_weights = feature_net_weights

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        from ..models.feature_nets import VGGFeatureNet
        feat_net = VGGFeatureNet(self.feature_net_weights, device=sampler.device)
        dataset = self._open_dataset(dataset_args, data_dir)
        n = min(self.num_images, dataset.num_images)

        ref = []
        done = 0
        while done < n:
            imgs, _ = self._reals_batch(dataset, min(self.minibatch, n - done))
            ref.append(feat_net(imgs.astype(np.float32)))
            done += imgs.shape[0]
        ref = np.concatenate(ref)
        gen = self._fakes_through(sampler, n, feat_net, self.minibatch)

        t0 = time.perf_counter()
        state = knn_precision_recall_features(ref, gen, self.nhood_size,
                                              device=sampler.device)
        print(f"{self.name}: k-NN precision and recall of {n} + {n} features in "
              f"{time.perf_counter() - t0:.2f} s")
        self._report_result(state["precision"], suffix="_precision")
        self._report_result(state["recall"], suffix="_recall")
        if feat_net.mode != "pretrained":
            self._report_result(1.0, suffix="_random_features", fmt="-1.0f")
