"""Perceptual path length (``ppl_zfull``, ``ppl_wfull``, ``ppl_zend``,
``ppl_wend``, ``ppl2_wend``), ported from
``inclusivegan_tpu/metrics/perceptual_path_length.py``.

Per pair of latents, two images a step ``epsilon`` apart along the path
(slerp in z, lerp in w; at t uniform in [0, 1) for ``sampling="full"``, at
0 for ``"end"``), cropped to the face window and pooled to at most 256 px,
go through LPIPS; the distance over epsilon squared is the pair's length.
Latents and t come from ``np.random.RandomState(123)`` as in the JAX
package. Each minibatch draws one synthesis noise, shared by every image of
it and so by both ends of every pair, from a ``torch.Generator`` seeded 0
(JAX's stream cannot be reproduced), or from ``noise_fn`` where a test
hands in the JAX package's draws. The mean is taken over the lengths
between the 1st ("lower") and 99th ("higher") percentiles.

1 / epsilon^2 = 1e8 turns every rounding difference between the two ends of
a pair into length, so the images must be computed in float32: TF32 stays
off (``run_metrics.main``).
"""

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.lpips import get_lpips_params, lpips_distance
from ..training.loss import slerp
from .metric_base import MetricBase


def crop_and_downsample(img: torch.Tensor, crop: bool) -> torch.Tensor:
    """With ``crop``, keep the face window, rows [3c, 7c) x cols [2c, 6c)
    with c = H // 8 (faces sit below the centre), then mean-pool to at most
    256 px."""
    ch = img.shape[1]
    if crop:
        c = img.shape[2] // 8
        img = img[:, :, c * 3:c * 7, c * 2:c * 6]
    factor = img.shape[2] // 256
    if factor > 1:
        img = img.reshape(-1, ch, img.shape[2] // factor, factor,
                          img.shape[3] // factor, factor).mean(dim=(3, 5))
    return img


def pair_distances(G, lpips_params, z01: torch.Tensor, t: torch.Tensor,
                   noise: Dict[str, torch.Tensor], space: str = "w",
                   epsilon: float = 1e-4, crop: bool = False,
                   impl: str = "cuda") -> torch.Tensor:
    """z01 [2B, Z]: pair i's ends at rows 2i and 2i + 1; t [B]. Returns the
    B path lengths LPIPS / epsilon^2 (float32)."""
    b = t.shape[0]
    if space == "z":
        z0, z1 = z01[0::2], z01[1::2]
        zt0 = slerp(z0, z1, t[:, None])
        zt1 = slerp(z0, z1, t[:, None] + epsilon)
        w = G.mapping(torch.cat([zt0, zt1]), impl=impl)
    else:
        w01 = G.mapping(z01, impl=impl)
        w0, w1 = w01[0::2], w01[1::2]
        wt0 = w0 + (w1 - w0) * t[:, None, None]
        wt1 = w0 + (w1 - w0) * (t[:, None, None] + epsilon)
        w = torch.cat([wt0, wt1])
    img = G.synthesis(w, noise=noise, randomize_noise=False, impl=impl)
    img = (crop_and_downsample(img, crop) + 1.0) * 127.5
    return lpips_distance(lpips_params, img[:b], img[b:]) * (1.0 / epsilon ** 2)


def filtered_mean(dists: np.ndarray) -> float:
    """The mean of the lengths between the 1st and 99th percentiles."""
    lo = np.percentile(dists, 1, method="lower")
    hi = np.percentile(dists, 99, method="higher")
    return float(np.mean(np.extract(np.logical_and(lo <= dists, dists <= hi), dists)))


class PPL(MetricBase):
    def __init__(self, name, num_samples=50000, epsilon=1e-4, space="w", sampling="full",
                 crop=False, minibatch_per_gpu=16, lpips_weights=None,
                 noise_fn: Optional[Callable[[], Dict[str, torch.Tensor]]] = None,
                 **kwargs):
        """``noise_fn()`` returns one minibatch's synthesis noise
        ({"noise<i>": [1, 1, h, w]}); default: ``init_noise`` from a
        generator seeded 0 on the sampler's device."""
        assert space in ("z", "w") and sampling in ("full", "end")
        super().__init__(name)
        self.num_samples = num_samples
        self.epsilon = epsilon
        self.space = space
        self.sampling = sampling
        self.crop = crop
        self.minibatch = minibatch_per_gpu
        self.lpips_weights = lpips_weights
        self.noise_fn = noise_fn
        self.dists = None

    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        G, device = sampler.G, sampler.device
        lpips_params = get_lpips_params(self.lpips_weights, device=device)
        generator = torch.Generator(device).manual_seed(0)
        noise_fn = self.noise_fn or (lambda: G.synthesis.init_noise(generator))
        rnd = np.random.RandomState(123)
        dists, done = [], 0
        t0 = time.perf_counter()
        with torch.no_grad():
            while done < self.num_samples:
                take = min(self.minibatch, self.num_samples - done)
                z01 = rnd.randn(2 * take, G.mapping.latent_size).astype(np.float32)
                if self.sampling == "full":
                    t = rnd.uniform(0, 1, take).astype(np.float32)
                else:
                    t = np.zeros(take, np.float32)
                dists.append(pair_distances(
                    G, lpips_params, torch.from_numpy(z01).to(device),
                    torch.from_numpy(t).to(device), noise_fn(), self.space,
                    self.epsilon, self.crop))
                done += take
            self.dists = torch.cat(dists).cpu().numpy()
        secs = time.perf_counter() - t0
        print(f"{self.name}: {self.num_samples} pairs in {secs:.2f} s, "
              f"{self.num_samples / max(secs, 1e-9):.1f} pairs/s")
        self._report_result(filtered_mean(self.dists))
