"""Linear separability (``ls``), ported from
``inclusivegan_tpu/metrics/linear_separability.py``.

Generate (z, w, image) triples from ``np.random.RandomState(123)``, score
each of 40 CelebA attributes with ``CelebAAttrClassifier`` (or an injected
``images_255 -> [N, num_attrs]`` scorer), keep the ``num_keep`` samples the
scorer is surest of (largest |p - 0.5|), fit a linear SVM on their latents
in z and in w, and report ``2 ** sum H(Y | Y_hat)`` per space. An attribute
the scorer puts wholly on one side adds 0. The SVM is
``metrics/linear_svm.py`` on the device, in place of scikit-learn's
``LinearSVC(C=0.1, dual="auto")``, which the card's machine lacks. The
generation with its scorer and the SVM fits are timed apart.
"""

import time

import numpy as np
import torch

from .linear_svm import fit_linear_svc, predict
from .metric_base import MetricBase

# attribute names in CelebA order
CELEBA_ATTRS = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]


def conditional_entropy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """H(Y | Y_hat) in bits for binary arrays."""
    joint = np.zeros((2, 2), np.float64)
    for t in (0, 1):
        for p in (0, 1):
            joint[t, p] = np.mean((y_true == t) & (y_pred == p))
    joint /= joint.sum()
    h = 0.0
    for p in (0, 1):
        pp = joint[:, p].sum()
        if pp <= 0:
            continue
        for t in (0, 1):
            if joint[t, p] > 0:
                h -= joint[t, p] * np.log2(joint[t, p] / pp)
    return h


class LS(MetricBase):
    def __init__(self, name, num_samples=200000, num_keep=100000, attrib_indices=range(40),
                 minibatch_per_gpu=4, attribute_classifier=None, classifier_weights=None,
                 **kwargs):
        super().__init__(name)
        self.num_samples = num_samples
        self.num_keep = num_keep
        self.attrib_indices = list(attrib_indices)
        self.minibatch = minibatch_per_gpu
        self.attribute_classifier = attribute_classifier
        self.classifier_weights = classifier_weights

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        device = sampler.device
        if self.attribute_classifier is None:
            from ..models.feature_nets import CelebAAttrClassifier
            clf = CelebAAttrClassifier(weights_path=self.classifier_weights, device=device)
            if clf.mode != "pretrained":
                self._report_result(1.0, suffix="_untrained_classifier", fmt="-1.0f")
            self.attribute_classifier = clf

        G = sampler.G
        rnd = np.random.RandomState(123)
        zs, ws, probs = [], [], []
        done = 0
        t0 = time.perf_counter()
        while done < self.num_samples:
            take = min(self.minibatch * 32, self.num_samples - done)
            z = rnd.randn(take, G.mapping.latent_size).astype(np.float32)
            with torch.no_grad():
                w = G.mapping(torch.from_numpy(z).to(device))
            imgs = sampler.run(z)
            probs.append(self.attribute_classifier(imgs))
            zs.append(z)
            ws.append((w[:, 0] if w.ndim == 3 else w).cpu().numpy())
            done += take
        zs, ws, probs = map(np.concatenate, (zs, ws, probs))
        gen_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        latents = {space: torch.from_numpy(v).to(device) for space, v in
                   (("z", zs), ("w", ws))}
        conditional_entropies = {"z": [], "w": []}
        n_fits = 0
        for attr_idx in self.attrib_indices:
            p = probs[:, attr_idx]
            keep = np.argsort(np.abs(p - 0.5))[-self.num_keep:]
            y = (p[keep] > 0.5).astype(np.int32)
            if len(np.unique(y)) < 2:
                # the scorer puts every sample on one side: a constant
                # predicts it, H(Y | Y_hat) = 0
                for space in ("z", "w"):
                    conditional_entropies[space].append(0.0)
                continue
            keep_t = torch.from_numpy(keep).to(device)
            for space in ("z", "w"):
                x = latents[space][keep_t]
                w_svm, _ = fit_linear_svc(x, torch.from_numpy(y).to(device))
                pred = predict(w_svm, x).cpu().numpy()
                conditional_entropies[space].append(conditional_entropy(y, pred))
                n_fits += 1
        fit_s = time.perf_counter() - t0
        print(f"{self.name}: {self.num_samples} samples generated and scored in "
              f"{gen_s:.2f} s; {n_fits} SVM fits on {min(self.num_keep, self.num_samples)} "
              f"points in {fit_s:.2f} s")
        for space in ("z", "w"):
            self._report_result(float(2 ** np.sum(conditional_entropies[space])),
                                suffix=f"_{space}")
