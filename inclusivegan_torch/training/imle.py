"""IMLE orchestration: candidate pool, exact nearest-neighbour retrieval and
the per-iteration rec batches, ported from
``inclusivegan_tpu/training/imle.py`` (the exact backend).

A fixed pool of ``data_size * num_samples_factor`` candidate latents is drawn
once from a seed. A rebuild, due at the staleness boundary (the staleness
doubles at each rebuild after the first), renders every candidate with the
current G, flattens it and, with a projector, multiplies it by a persistent
random matrix; then every real image of the rec dataset, in its fixed
order, retrieves its nearest candidate's latent. ``next_rec_batch`` filters
by distance percentile or attributes, perturbs the retrieved latents by a
slerp towards noise, and returns two independently shuffled rec batches.

The exact search is a chunked float32 ``torch.matmul`` with a running
minimum (or top-k), as the JAX package's ``_knn_topk`` scan is plain XLA:
library calls are right here. Both keep full float32 (the JAX package asks
for ``Precision.HIGHEST``); TF32 would reorder neighbours, so the caller
keeps ``torch.backends.cuda.matmul.allow_tf32`` off. Host-side randomness is
numpy's PCG64, seeded as in the JAX package, so both draw the same pool, the
same perturbations and the same shuffles.
"""

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.misc import adjust_dynamic_range, slerp_np

_KNN_CAND_CHUNK = 65536
_KNN_QUERY_CHUNK = 8192
_EXACT_KNN_MEMORY_BUDGET = 4 << 30  # candidate-feature bytes on the device


def _knn_topk(qfeats, cand, k: int, chunk: int = _KNN_CAND_CHUNK):
    """The k nearest candidates (L2) of each query: (dists [Q, k], ids
    [Q, k] int64), nearest first. ``||c||^2 - 2 q.c`` ranks like the squared
    distance; candidates go by in chunks, with a running best. For k = 1 a
    tie keeps the earlier candidate, as the JAX package's stable top_k does."""
    q = qfeats.shape[0]
    best_d = torch.full((q, k), math.inf, device=qfeats.device)
    best_i = torch.zeros((q, k), dtype=torch.int64, device=qfeats.device)
    for base in range(0, cand.shape[0], chunk):
        c = cand[base:base + chunk]
        scores = (c * c).sum(dim=1)[None, :] - 2.0 * (qfeats @ c.T)
        if k == 1:
            d, i = scores.min(dim=1, keepdim=True)
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_i = torch.where(better, i + base, best_i)
        else:
            negd, i = torch.topk(-scores, min(k, c.shape[0]), dim=1)
            alld = torch.cat([best_d, -negd], dim=1)
            alli = torch.cat([best_i, i + base], dim=1)
            negd, sel = torch.topk(-alld, k, dim=1)
            best_d, best_i = -negd, torch.gather(alli, 1, sel)
    qnorm = (qfeats * qfeats).sum(dim=1, keepdim=True)
    return torch.sqrt(torch.clamp_min(best_d + qnorm, 0.0)), best_i


def _featurize(x, projector, drange_in=None, drange_out=None):
    """Images (uint8 reals in drange_in, or G output already in drange_out)
    -> float32 in drange_out, flattened (@ projector)."""
    x = x.float()
    if drange_in is not None:
        x = adjust_dynamic_range(x, list(drange_in), list(drange_out))
    flat = x.reshape(x.shape[0], -1)
    return flat if projector is None else flat @ projector


def func_proj_dim(init_proj_dim: Optional[int], data_size: int,
                  num_samples_factor: int, image_dim: int) -> int:
    """Projection dimension: None -> the raw image dimension; 0 -> the
    Johnson-Lindenstrauss estimate for eps 0.1."""
    if init_proj_dim is None:
        return image_dim
    if init_proj_dim == 0:
        n = data_size * num_samples_factor
        eps = 0.1
        return int(np.ceil(4 * math.log(n) / (eps ** 2 / 2 - eps ** 3 / 3)))
    return int(init_proj_dim)


def load_or_create_projector(image_dim: int, proj_dim: int,
                             cache_dir: str = ".") -> np.ndarray:
    """A persistent random projector matrix, cached to .npy so that a resumed
    run retrieves in the same space."""
    path = os.path.join(cache_dir, f"random_projector_mat_{image_dim}to{proj_dim}.npy")
    if os.path.isfile(path):
        return np.load(path)
    projector = np.random.normal(
        0.0, 1.0 / float(proj_dim), size=(image_dim, proj_dim)).astype(np.float64)
    np.save(path, projector)
    return projector


class IMLEOrchestrator:
    """Owns the candidate pool, the retrieved latents and the rec cursor."""

    def __init__(self, *, data_size: int, num_samples_factor: int,
                 latent_size: int, image_dim: int,
                 init_proj_dim: Optional[int] = None, init_staleness: int = 10,
                 knn_perturb_factor: float = 0.05,
                 candidate_batch_size: int = 256,
                 exclusive_retrieved_code: bool = False,
                 dist_thres_percentile: float = 100.0,
                 attr_interesting: Optional[str] = None,
                 attr_names: Optional[list] = None, seed: int = 0,
                 drange_data=(0, 255), drange_net=(-1, 1),
                 projector_cache_dir: str = ".", knn_backend: str = "exact",
                 device="cuda"):
        if knn_backend not in ("auto", "exact", "dci"):
            raise ValueError(f"unknown knn_backend {knn_backend!r}")
        n = data_size * num_samples_factor
        self.proj_dim = func_proj_dim(init_proj_dim, data_size, num_samples_factor,
                                      image_dim)
        if knn_backend == "dci" or (
                knn_backend == "auto"
                and n * self.proj_dim * 4 > _EXACT_KNN_MEMORY_BUDGET):
            raise NotImplementedError(
                "knn_backend='dci' (the host DCI index) is not ported yet: it "
                "comes in a later slice; the exact backend takes candidate "
                f"features up to {_EXACT_KNN_MEMORY_BUDGET >> 30} GiB")
        self.data_size = data_size
        self.num_samples_factor = num_samples_factor
        self.latent_size = latent_size
        self.image_dim = image_dim
        self.init_proj_dim = init_proj_dim
        self.staleness = init_staleness
        self.knn_perturb_factor = knn_perturb_factor
        self.candidate_batch_size = candidate_batch_size
        self.exclusive_retrieved_code = exclusive_retrieved_code
        self.dist_thres_percentile = dist_thres_percentile
        self.attr_interesting = attr_interesting
        self.attr_names = attr_names
        self.drange_data = tuple(drange_data)
        self.drange_net = tuple(drange_net)
        self.knn_backend = knn_backend
        self.device = torch.device(device)

        self.projector = None
        if init_proj_dim is not None:
            self.projector = load_or_create_projector(image_dim, self.proj_dim,
                                                      projector_cache_dir)
        rnd = np.random.Generator(np.random.PCG64(seed))
        self.latent_candidates = rnd.standard_normal((n, latent_size),
                                                     dtype=np.float32)
        self.selected_latents: Optional[np.ndarray] = None
        self.selected_dists: Optional[np.ndarray] = None
        self.dist_thres = np.inf
        self.cursor = 0
        self._remainder = None  # carried (reals, labels, latents)
        self._rng = np.random.Generator(np.random.PCG64(seed + 1))
        self.tick_rec_batch = None  # latest rec batch (snapshot grids)

    def needs_rebuild(self, cur_nimg: int, nimg_per_iter: int) -> bool:
        """Staleness boundary test."""
        if self.selected_latents is None:
            return True
        period = self.data_size * self.staleness
        prev = max(cur_nimg - nimg_per_iter, 0)
        return cur_nimg // period != prev // period

    def rebuild(self, generate_images: Callable[[np.ndarray], object],
                rec_dataset, verbose: bool = True) -> None:
        """Render the candidates with the current G and retrieve the nearest
        candidate's latent for every real. ``generate_images``: latents
        [B, Z] (numpy) -> images [B, C, H, W] in drange_net (a tensor or an
        array)."""
        if self.selected_latents is not None:
            self.staleness *= 2
        self._rebuild_exact(generate_images, rec_dataset, verbose)

    def _rebuild_exact(self, generate_images, rec_dataset, verbose):
        n = self.data_size * self.num_samples_factor
        bs = self.candidate_batch_size
        dev = self.device
        projector = (torch.as_tensor(self.projector, dtype=torch.float32, device=dev)
                     if self.projector is not None else None)
        feats = []
        for i in range(0, n, bs):
            if verbose and (i // bs) % 16 == 0:
                print(f"\rCandidates sampling {i}/{n}...", end="", flush=True)
            img = torch.as_tensor(generate_images(self.latent_candidates[i:i + bs]),
                                  device=dev)
            feats.append(_featurize(img, projector))
        cand = torch.cat(feats)[:n]
        del feats
        if verbose:
            print("\rExact kNN (device)...                  ")

        reals = rec_dataset.get_all_images()[:self.data_size]
        nq = reals.shape[0]
        k = self.num_samples_factor if self.exclusive_retrieved_code else 1
        ids = np.empty((nq, k), np.int64)
        dists = np.empty((nq, k), np.float64)
        for j in range(0, nq, _KNN_QUERY_CHUNK):
            r = torch.as_tensor(reals[j:j + _KNN_QUERY_CHUNK], device=dev)
            d, i = _knn_topk(_featurize(r, projector, self.drange_data,
                                        self.drange_net), cand, k)
            ids[j:j + r.shape[0]] = i.cpu().numpy()
            dists[j:j + r.shape[0]] = d.double().cpu().numpy()

        if self.exclusive_retrieved_code:
            used = set()
            sel_ids, sel_dists = [], []
            for row_ids, row_dists in zip(ids, dists):
                pick = 0
                for jj, cand_id in enumerate(row_ids):
                    if cand_id not in used:
                        pick = jj
                        break
                used.add(row_ids[pick])
                sel_ids.append(row_ids[pick])
                sel_dists.append(row_dists[pick])
            nearest_ids = np.array(sel_ids)
            nearest_dists = np.array(sel_dists)
        else:
            nearest_ids = ids[:, 0]
            nearest_dists = dists[:, 0]
        self.selected_latents = self.latent_candidates[nearest_ids]
        self.selected_dists = nearest_dists
        self.dist_thres = np.percentile(nearest_dists, self.dist_thres_percentile)
        if verbose:
            print(f"Exact retrieval done: mean 1-NN dist "
                  f"{nearest_dists.mean():.4f}, staleness now {self.staleness}")

    def _row_filter(self, labels: np.ndarray, dists: np.ndarray) -> np.ndarray:
        """Minority-attribute or distance-percentile row selection."""
        if self.attr_interesting is None:
            return dists <= self.dist_thres
        active = np.ones(labels.shape[0], bool)
        for attr in self.attr_interesting.split(","):
            idx = self.attr_names.index(attr)
            active &= labels[:, idx] == 1
        return active

    def next_rec_batch(self, rec_dataset, minibatch_size: int
                       ) -> Tuple[np.ndarray, ...]:
        """The two rec minibatches of one iteration: (reals_1, labels_1,
        latents_1, reals_2, labels_2, latents_2), reals in the dataset's
        raw range (uint8); the train step converts them on the card."""
        if self.selected_latents is None:
            raise RuntimeError("next_rec_batch before the first rebuild()")
        double = minibatch_size * 2
        reals = labels = latents = None
        if self._remainder is not None and self.cursor % self.data_size != 0:
            reals, labels, latents = self._remainder
            self._remainder = None
        at_epoch_start = self.cursor % self.data_size == 0
        while reals is None or reals.shape[0] < double:
            r, l = rec_dataset.get_minibatch_np(double)
            lo = self.cursor % self.data_size
            z = self.selected_latents[lo:lo + double]
            d = self.selected_dists[lo:lo + double]
            keep = self._row_filter(l, d)
            r, l, z = r[keep], l[keep], z[keep]
            if reals is None or at_epoch_start:
                reals, labels, latents = r, l, z
                at_epoch_start = False
            else:
                reals = np.concatenate([reals, r])
                labels = np.concatenate([labels, l])
                latents = np.concatenate([latents, z])
            self.cursor += double
        if reals.shape[0] > double:
            self._remainder = (reals[double:], labels[double:], latents[double:])
            reals, labels, latents = reals[:double], labels[:double], latents[:double]
        else:
            self._remainder = None

        latents = slerp_np(
            latents, self._rng.standard_normal(latents.shape, dtype=np.float32),
            self.knn_perturb_factor)
        self.tick_rec_batch = (reals.copy(), labels.copy(), latents.copy())

        order = np.arange(minibatch_size)
        self._rng.shuffle(order)
        r1, l1, z1 = (reals[:minibatch_size][order], labels[:minibatch_size][order],
                      latents[:minibatch_size][order])
        self._rng.shuffle(order)
        r2, l2, z2 = (reals[minibatch_size:][order], labels[minibatch_size:][order],
                      latents[minibatch_size:][order])
        return r1, l1, z1, r2, l2, z2
