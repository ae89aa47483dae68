"""IMLE orchestration: candidate pool, nearest-neighbour retrieval (exact on
the card, or through the host DCI index) and the per-iteration rec batches,
ported from ``inclusivegan_tpu/training/imle.py``.

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

The ``dci`` backend keeps the candidate features on the host in float64 and
builds the Prioritized DCI index (``dci/``) over them. The features, and
their projections onto the index's directions, are float32 matrix products
on the card; the host sorts the tables and walks them. ``auto`` takes the
exact backend while the candidate features fit its budget and DCI beyond
it, as the JAX package routes, since the two backends may retrieve
different neighbours; DCI is gated by the host memory its float64 features
take and by its projected construction time.
"""

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dci import DCI
from ..utils.misc import adjust_dynamic_range, slerp_np

_KNN_CAND_CHUNK = 65536
_KNN_QUERY_CHUNK = 8192
# The routing rule between the backends, the JAX package's, so that every
# configuration retrieves with the same backend in both packages: exact
# while the candidate features take at most 4 GiB in float32, DCI beyond,
# while they take at most 32 GiB in float64 on the host.
_EXACT_KNN_MEMORY_BUDGET = 4 << 30
_DCI_HOST_MEM_BUDGET = 32 << 30

# Host-DCI construction time, t = COEF * n**EXP seconds with all the host's
# cores (the production index: dim 512, 3 x 15 directions, 2 levels),
# fitted by chip_smoke.py phase 15 at n = 8192 ... 131072 on the host of an
# NVIDIA H100 80GB HBM3 (700.00 W power limit), os.cpu_count() = 8. It
# routes ``auto`` and makes an explicit ``dci`` warn, instead of stalling
# training for a time nobody predicted.
_DCI_BUILD_COEF = 1.98e-5
_DCI_BUILD_EXP = 1.05
_DCI_BUILD_FIT_CORES = 8
_DCI_BUILD_BUDGET_S = 900.0


def estimate_dci_build_seconds(n: int) -> float:
    """Projected host-DCI construction seconds for an n-point pool on this
    host: the fit, scaled from its host's cores to this one's with the JAX
    package's 70% parallel share (the assignment loop is OpenMP)."""
    cores = max(os.cpu_count() or 1, 1)
    return (_DCI_BUILD_COEF * float(n) ** _DCI_BUILD_EXP
            * (0.3 + 0.7 * _DCI_BUILD_FIT_CORES) / (0.3 + 0.7 * cores))


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


class _Lookahead:
    """Copies batches from the card into host float64 arrays with one batch
    of look-ahead: each batch's copy is queued behind its work and waited
    for only after the next batch is dispatched, so that the card renders
    batch i+1 while the host converts batch i (pinned buffers, CUDA's
    asynchronous launch)."""

    def __init__(self, dev):
        self.dev = dev
        self.pinned = dev.type == "cuda"
        self.pending = None

    def put(self, tensors, outs, at: int):
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pinned)
            h.copy_(t, non_blocking=self.pinned)
            hosts.append(h)
        landed = None
        if self.pinned:
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.dev))
        self.drain()
        self.pending = (hosts, outs, at, landed)

    def drain(self):
        if self.pending is None:
            return
        hosts, outs, at, landed = self.pending
        self.pending = None
        if landed is not None:
            landed.synchronize()
        for h, out in zip(hosts, outs):
            out[at:at + h.shape[0]] = h.numpy()


def _first_unused(ids, dists):
    """Exclusive retrieval: each query, in order, takes the first of its
    neighbours that no earlier query took (its nearest if all were)."""
    used = set()
    sel_ids, sel_dists = [], []
    for row_ids, row_dists in zip(ids, dists):
        pick = 0
        for j, cand in enumerate(row_ids):
            if cand not in used:
                pick = j
                break
        used.add(row_ids[pick])
        sel_ids.append(row_ids[pick])
        sel_dists.append(row_dists[pick])
    return np.array(sel_ids), np.array(sel_dists)


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
                             cache_dir: Optional[str] = ".") -> np.ndarray:
    """A persistent random projector matrix, cached to .npy so that a resumed
    run retrieves in the same space. With ``cache_dir`` None it is drawn
    and not written (a rank that does not write the run dir)."""
    name = f"random_projector_mat_{image_dim}to{proj_dim}.npy"
    path = os.path.join(cache_dir, name) if cache_dir is not None else None
    if path is not None and os.path.isfile(path):
        return np.load(path)
    projector = np.random.normal(
        0.0, 1.0 / float(proj_dim), size=(image_dim, proj_dim)).astype(np.float64)
    if path is not None:
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
                 attr_names: Optional[list] = None,
                 num_comp_indices: int = 3, num_simp_indices: int = 15,
                 num_levels: int = 2, seed: int = 0,
                 drange_data=(0, 255), drange_net=(-1, 1),
                 projector_cache_dir: Optional[str] = ".", knn_backend: str = "auto",
                 device="cuda"):
        if knn_backend not in ("auto", "exact", "dci"):
            raise ValueError(f"unknown knn_backend {knn_backend!r}")
        n = data_size * num_samples_factor
        self.proj_dim = func_proj_dim(init_proj_dim, data_size, num_samples_factor,
                                      image_dim)
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
        self.num_levels = num_levels
        self.device = torch.device(device)

        self.projector = None
        if init_proj_dim is not None:
            self.projector = load_or_create_projector(image_dim, self.proj_dim,
                                                      projector_cache_dir)
        rnd = np.random.Generator(np.random.PCG64(seed))
        self.latent_candidates = rnd.standard_normal((n, latent_size),
                                                     dtype=np.float32)
        # the index is made at the first DCI rebuild, which draws its
        # directions anew (reset) from _rng, as the JAX package does
        self._dci_args = (self.proj_dim, num_comp_indices, num_simp_indices, seed)
        self.dci: Optional[DCI] = None
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
                rec_dataset, verbose: bool = True,
                generate_features: Optional[Callable[[np.ndarray], object]] = None
                ) -> None:
        """Render the candidates with the current G and retrieve the nearest
        candidate's latent for every real. ``generate_images``: latents
        [B, Z] (numpy) -> images [B, C, H, W] in drange_net (a tensor or an
        array). ``generate_features`` is accepted for the JAX package's
        signature and not used: that package fuses the projector into its
        generator call to spare the device-to-host link, while here the
        images stay on the card and are projected there.

        The backend: ``exact``, ``dci``, or ``auto``, which takes exact
        while the candidates' float32 features fit its budget. DCI raises
        when its float64 features would pass the host budget; beyond its
        time budget an explicit ``dci`` warns and runs, and ``auto``
        raises."""
        del generate_features
        if self.selected_latents is not None:
            self.staleness *= 2
        n = self.data_size * self.num_samples_factor
        if self.knn_backend == "exact" or (
                self.knn_backend == "auto"
                and n * self.proj_dim * 4 <= _EXACT_KNN_MEMORY_BUDGET):
            self._rebuild_exact(generate_images, rec_dataset, verbose)
            return
        self._check_dci_budgets(n)
        self._rebuild_dci(generate_images, rec_dataset, verbose)

    def _check_dci_budgets(self, n: int) -> None:
        host_bytes = n * self.proj_dim * 8
        if host_bytes > _DCI_HOST_MEM_BUDGET:
            raise RuntimeError(
                f"host-DCI candidate features ({n:,} x {self.proj_dim} f64 = "
                f"{host_bytes / 2**30:.0f} GiB) exceed the "
                f"{_DCI_HOST_MEM_BUDGET >> 30} GiB host budget. Set init_proj_dim "
                f"(e.g. 512, or 0 for the Johnson-Lindenstrauss estimate) so that "
                f"the features are projected before retrieval.")
        est = estimate_dci_build_seconds(n)
        if est <= _DCI_BUILD_BUDGET_S:
            return
        if self.knn_backend == "dci":
            print(f"WARNING: host-DCI index build for {n:,} candidates is projected "
                  f"to take ~{est / 60:.0f} min on this host (fitted model, "
                  f"imle.estimate_dci_build_seconds); training stalls for the "
                  f"duration. Reduce init_proj_dim so that the exact backend fits "
                  f"its {_EXACT_KNN_MEMORY_BUDGET >> 30} GiB budget if that is "
                  f"unacceptable.", flush=True)
            return
        raise RuntimeError(
            f"knn_backend='auto': candidate features ({n:,} x {self.proj_dim} f32 "
            f"= {n * self.proj_dim * 4 / 2**30:.1f} GiB) exceed the "
            f"{_EXACT_KNN_MEMORY_BUDGET >> 30} GiB exact-backend budget, and the "
            f"host-DCI fallback is projected at ~{est / 60:.0f} min per rebuild on "
            f"this host. Either reduce init_proj_dim (smaller features -> exact "
            f"fits) or set knn_backend='dci' explicitly to accept the host build "
            f"time.")

    def _projector_dev(self):
        if self.projector is None:
            return None
        return torch.as_tensor(self.projector, dtype=torch.float32, device=self.device)

    def _rebuild_exact(self, generate_images, rec_dataset, verbose):
        n = self.data_size * self.num_samples_factor
        bs = self.candidate_batch_size
        dev = self.device
        projector = self._projector_dev()
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
            r = torch.tensor(reals[j:j + _KNN_QUERY_CHUNK], device=dev)  # a copy
            d, i = _knn_topk(_featurize(r, projector, self.drange_data,
                                        self.drange_net), cand, k)
            ids[j:j + r.shape[0]] = i.cpu().numpy()
            dists[j:j + r.shape[0]] = d.double().cpu().numpy()
        if self.exclusive_retrieved_code:
            nearest_ids, nearest_dists = _first_unused(ids, dists)
        else:
            nearest_ids, nearest_dists = ids[:, 0], dists[:, 0]
        self._select(nearest_ids, nearest_dists, "Exact", verbose)

    def _rebuild_dci(self, generate_images, rec_dataset, verbose):
        n = self.data_size * self.num_samples_factor
        bs = self.candidate_batch_size
        dev = self.device
        projector = self._projector_dev()
        if self.dci is None:
            dim, ncomp, nsimp, seed = self._dci_args
            self.dci = DCI(dim, ncomp, nsimp, seed=seed)
        self.dci.reset(seed=int(self._rng.integers(2 ** 31)))
        proj_vec = torch.as_tensor(self.dci.proj_vec.T, dtype=torch.float32, device=dev)
        feats = np.empty((n, self.proj_dim), np.float64)
        proj = np.empty((n, proj_vec.shape[1]), np.float64)
        copies = _Lookahead(dev)
        for i in range(0, n, bs):
            if verbose and (i // bs) % 16 == 0:
                print(f"\rCandidates sampling {i}/{n}...", end="", flush=True)
            img = torch.as_tensor(generate_images(self.latent_candidates[i:i + bs]),
                                  device=dev)
            f = _featurize(img, projector)
            copies.put((f, f @ proj_vec), (feats, proj), i)
        copies.drain()
        if verbose:
            print("\rDCI constructing...                    ")
        self.dci.add(feats, num_levels=self.num_levels, projections=proj)

        reals = rec_dataset.get_all_images()[:self.data_size]
        nq = reals.shape[0]
        qfeats = np.empty((nq, self.proj_dim), np.float64)
        qproj = np.empty((nq, proj_vec.shape[1]), np.float64)
        for j in range(0, nq, _KNN_QUERY_CHUNK):
            r = torch.tensor(reals[j:j + _KNN_QUERY_CHUNK], device=dev)  # a copy
            f = _featurize(r, projector, self.drange_data, self.drange_net)
            copies.put((f, f @ proj_vec), (qfeats, qproj), j)
        copies.drain()
        if self.exclusive_retrieved_code:
            k = self.num_samples_factor
            ids, dists = self.dci.query(qfeats, num_neighbours=k, field_of_view=200,
                                        max_retrieve=max(1024, 32 * k),
                                        projections=qproj)
            nearest_ids, nearest_dists = _first_unused(ids, dists)
        else:
            ids, dists = self.dci.query(qfeats, num_neighbours=1, field_of_view=200,
                                        projections=qproj)
            nearest_ids = np.array([i[0] for i in ids])
            nearest_dists = np.array([d[0] for d in dists])
        self._select(nearest_ids, nearest_dists, "DCI", verbose)

    def _select(self, nearest_ids, nearest_dists, backend: str, verbose: bool):
        self.selected_latents = self.latent_candidates[nearest_ids]
        self.selected_dists = nearest_dists
        self.dist_thres = np.percentile(nearest_dists, self.dist_thres_percentile)
        if verbose:
            print(f"{backend} retrieval done: mean 1-NN dist "
                  f"{nearest_dists.mean():.4f}, staleness now {self.staleness}")

    def selection(self) -> dict:
        """What a rebuild sets (``_select``'s arrays and threshold), with the
        staleness and the state of the host stream it draws from: what a
        rank that did not rebuild needs to assemble the same batches."""
        return dict(selected_latents=self.selected_latents,
                    selected_dists=self.selected_dists, dist_thres=self.dist_thres,
                    staleness=self.staleness, rng=self._rng.bit_generator.state)

    def set_selection(self, sel: dict) -> None:
        """Take another orchestrator's ``selection()``."""
        sel = dict(sel)
        self._rng.bit_generator.state = sel.pop("rng")
        for k, v in sel.items():
            setattr(self, k, v)

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
