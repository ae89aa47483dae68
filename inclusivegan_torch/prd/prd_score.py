"""PRD curves (precision and recall for distributions), ported from
``inclusivegan_tpu/prd/prd_score.py``.

Between a discrete evaluated distribution p and a reference q, at slope
lambda: precision alpha(lambda) = sum_i min(lambda q_i, p_i) and recall
beta(lambda) = alpha(lambda) / lambda, on a grid of angles in (0, pi/2).
``compute_prd``, ``_prd_to_f_beta`` and ``prd_to_max_f_beta_pair`` are the
JAX package's float64 numpy, unchanged.

Embeddings are binned by k-means over the union of both sample sets
(``_cluster_into_bins``). The JAX package calls scikit-learn's
``MiniBatchKMeans``; the port has its own ``kmeans`` in torch, on the
device of the data (a CUDA tensor clusters on the card): k-means++
seeding, Lloyd iterations until the centers move less than ``TOL`` times
the data's mean variance, ``N_INIT`` restarts keeping the lowest inertia,
every draw from an explicit ``torch.Generator``. Distances are one matrix
product per iteration; no TPU kernel exists for them, so no kernel of the
port's own is due.

``plot`` rasterizes the curves itself (axes on [0, 1]^2, one half-opaque
polyline per curve, a legend swatch per label) and writes the PNG with
``utils.misc.write_png``: no matplotlib.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.misc import write_png


def compute_prd(eval_dist, ref_dist, num_angles: int = 1001,
                epsilon: float = 1e-10) -> Tuple[np.ndarray, np.ndarray]:
    if not (epsilon > 0 and epsilon < 0.1):
        raise ValueError("epsilon must be in (0, 0.1]")
    if not (num_angles >= 3 and num_angles <= 1e6):
        raise ValueError("num_angles must be in [3, 1e6]")
    eval_dist = np.asarray(eval_dist, np.float64)
    ref_dist = np.asarray(ref_dist, np.float64)

    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num=num_angles)
    slopes = np.tan(angles)
    slopes_2d = slopes[:, None]
    precision = np.minimum(ref_dist[None] * slopes_2d, eval_dist[None]).sum(1)
    recall = precision / slopes
    return (np.clip(precision, 0, 1), np.clip(recall, 0, 1))


def _sq_dist(x, x_sq, centers):
    """Squared distances [N, k] of the rows of ``x`` to ``centers``."""
    d = x_sq[:, None] - 2.0 * (x @ centers.T) + centers.square().sum(1)[None]
    return d.clamp_min(0.0)


def _kmeans_plus_plus(x, x_sq, k: int, generator) -> torch.Tensor:
    """k-means++ seeding: the first center uniformly, each next one drawn
    with probability proportional to the squared distance to the nearest
    center so far."""
    n = x.shape[0]
    first = torch.randint(n, (1,), generator=generator, device=x.device)
    centers = [x[first]]
    closest = _sq_dist(x, x_sq, centers[0])[:, 0]
    for _ in range(1, k):
        weights = closest + torch.finfo(x.dtype).tiny  # all-equal points: uniform
        pick = torch.multinomial(weights / weights.sum(), 1, generator=generator)
        centers.append(x[pick])
        closest = torch.minimum(closest, _sq_dist(x, x_sq, centers[-1])[:, 0])
    return torch.cat(centers)


def _update_centers(x, labels, dist, k: int) -> torch.Tensor:
    """The mean of each cluster's points (one matrix product, in a fixed
    order). An empty cluster takes the point farthest from its own center,
    the farthest first."""
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [N, k]
    counts = onehot.sum(0)
    centers = (onehot.T @ x) / counts.clamp_min(1)[:, None]
    empty = torch.nonzero(counts == 0)[:, 0]
    if len(empty):
        far = dist.gather(1, labels[:, None])[:, 0].argsort(descending=True)
        centers[empty] = x[far[:len(empty)]]
    return centers


N_INIT = 10  # k-means++ starts per clustering, as the JAX package's MiniBatchKMeans
MAX_ITER = 300
TOL = 1e-4  # of the mean per-feature variance, scikit-learn's default


def kmeans(data: torch.Tensor, num_clusters: int,
           generator: Optional[torch.Generator] = None):
    """Lloyd's k-means of ``data`` [N, D] on its device: ``N_INIT``
    k-means++ starts, each iterated until the centers' squared shift is at
    most ``TOL`` times the mean per-feature variance (or ``MAX_ITER``), the
    lowest inertia kept. Returns (labels [N] int64, centers [k, D], inertia,
    Lloyd iterations over all starts)."""
    if data.ndim != 2 or data.shape[0] < num_clusters:
        raise ValueError(f"kmeans needs [N >= {num_clusters}, D] data, got "
                         f"{tuple(data.shape)}")
    if generator is None:
        generator = torch.Generator(device=data.device).manual_seed(0)
    x = data
    x_sq = x.square().sum(1)
    tol_abs = TOL * x.var(dim=0, unbiased=False).mean().item()
    best, iterations = None, 0
    for _ in range(N_INIT):
        centers = _kmeans_plus_plus(x, x_sq, num_clusters, generator)
        for _ in range(MAX_ITER):
            dist = _sq_dist(x, x_sq, centers)
            new = _update_centers(x, dist.argmin(1), dist, num_clusters)
            shift = (new - centers).square().sum().item()
            centers = new
            iterations += 1
            if shift <= tol_abs:
                break
        dist = _sq_dist(x, x_sq, centers)
        labels = dist.argmin(1)
        inertia = dist.gather(1, labels[:, None]).sum().item()
        if best is None or inertia < best[2]:
            best = (labels, centers, inertia)
    return (*best, iterations)


def _as_float64(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(torch.float64)
    return torch.from_numpy(np.asarray(data, np.float64))


def _cluster_into_bins(eval_data, ref_data, num_clusters: int,
                       generator: Optional[torch.Generator] = None):
    """Histograms (densities over ``num_clusters`` bins) of the k-means
    labels of the eval and the ref samples, clustered together on the
    data's device."""
    eval_data, ref_data = _as_float64(eval_data), _as_float64(ref_data)
    data = torch.cat([eval_data, ref_data.to(eval_data.device)])
    labels = kmeans(data, num_clusters, generator)[0].cpu().numpy()
    eval_labels = labels[:len(eval_data)]
    ref_labels = labels[len(eval_data):]
    eval_bins = np.histogram(eval_labels, bins=num_clusters,
                             range=[0, num_clusters], density=True)[0]
    ref_bins = np.histogram(ref_labels, bins=num_clusters,
                            range=[0, num_clusters], density=True)[0]
    return eval_bins, ref_bins


def compute_prd_from_embedding(eval_data, ref_data, num_clusters: int = 20,
                               num_angles: int = 1001, num_runs: int = 10,
                               enforce_balance: bool = True,
                               generator: Optional[torch.Generator] = None):
    """The PRD curve (precision, recall) of two embedding sets [N, D] (numpy
    arrays, or tensors on the device to cluster on), averaged over
    ``num_runs`` clusterings. ``generator`` (on the data's device) gives
    the k-means draws; None seeds one with 0."""
    eval_data, ref_data = _as_float64(eval_data), _as_float64(ref_data)
    if enforce_balance and len(eval_data) != len(ref_data):
        raise ValueError("eval and ref must have the same size "
                         "(pass enforce_balance=False to override)")
    if generator is None:
        generator = torch.Generator(device=eval_data.device).manual_seed(0)
    precisions, recalls = [], []
    for _ in range(num_runs):
        eval_dist, ref_dist = _cluster_into_bins(eval_data, ref_data, num_clusters,
                                                 generator)
        p, r = compute_prd(eval_dist, ref_dist, num_angles)
        precisions.append(p)
        recalls.append(r)
    return np.mean(precisions, 0), np.mean(recalls, 0)


def _prd_to_f_beta(precision, recall, beta: float = 1, epsilon: float = 1e-10):
    if beta <= 0:
        raise ValueError("beta must be positive")
    if np.any(precision < 0) or np.any(recall < 0):
        raise ValueError("precision and recall must be non-negative")
    return ((1 + beta ** 2) * (precision * recall) /
            (beta ** 2 * precision + recall + epsilon))


def prd_to_max_f_beta_pair(precision, recall, beta: float = 8):
    """The (F_beta, F_1/beta) summary pair."""
    f_beta = np.max(_prd_to_f_beta(np.asarray(precision),
                                   np.asarray(recall), beta))
    f_beta_inv = np.max(_prd_to_f_beta(np.asarray(precision),
                                       np.asarray(recall), 1.0 / beta))
    return float(f_beta), float(f_beta_inv)


# matplotlib's default color cycle, as RGB
_COLORS = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
                    [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
                    [188, 189, 34], [23, 190, 207]], np.float64)
_LEGEND_CORNERS = {"lower left": (0, 1), "lower right": (1, 1), "upper left": (0, 0),
                   "upper right": (1, 0)}


def _stroke(mask, xs, ys, radius):
    """Set the pixels within ``radius`` of the polyline through (xs, ys)."""
    h, w = mask.shape
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        steps = int(np.ceil(max(abs(x1 - x0), abs(y1 - y0)))) + 1
        px = np.linspace(x0, x1, steps)
        py = np.linspace(y0, y1, steps)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                if dx * dx + dy * dy > radius * radius:
                    continue
                cx = np.clip(np.rint(px).astype(int) + dx, 0, w - 1)
                cy = np.clip(np.rint(py).astype(int) + dy, 0, h - 1)
                mask[cy, cx] = True


def plot(precision_recall_pairs, labels: Optional[Sequence[str]] = None,
         out_path: Optional[str] = None, legend_loc: str = "lower left",
         dpi: int = 300):
    """Recall on x, precision on y, both on [0, 1]: one polyline per
    (precision, recall) pair at half opacity over white, inside a black
    frame with ticks every 0.2, on a 3.5 x 3.5 inch canvas at ``dpi``. With
    ``labels``, a legend in ``legend_loc`` holds one color swatch per label,
    in order (no text: the port draws no fonts). Writes the PNG to
    ``out_path``; with None, returns the [H, W, 3] uint8 image."""
    if legend_loc not in _LEGEND_CORNERS:
        raise ValueError(f"legend_loc must be one of {sorted(_LEGEND_CORNERS)}")
    size = int(round(3.5 * dpi))
    margin = size // 10
    span = size - 2 * margin
    line = max(1, dpi // 100)
    canvas = np.full((size, size, 3), 255.0)

    def to_px(v, axis_y):
        v = np.clip(np.asarray(v, np.float64), 0.0, 1.0)
        return margin + (1.0 - v) * span if axis_y else margin + v * span

    for i, (precision, recall) in enumerate(precision_recall_pairs):
        mask = np.zeros((size, size), bool)
        _stroke(mask, to_px(recall, False), to_px(precision, True), line)
        canvas[mask] = 0.5 * canvas[mask] + 0.5 * _COLORS[i % len(_COLORS)]

    frame = np.zeros((size, size), bool)
    lo, hi = margin, margin + span
    frame[lo - line:lo + 1, lo:hi + 1] = frame[hi:hi + line + 1, lo:hi + 1] = True
    frame[lo:hi + 1, lo - line:lo + 1] = frame[lo:hi + 1, hi:hi + line + 1] = True
    tick = max(3, size // 100)
    for v in np.linspace(0.0, 1.0, 6):
        p = int(round(to_px(v, False)))
        frame[hi:hi + tick, p - line // 2:p + line // 2 + 1] = True  # x ticks
        q = int(round(to_px(v, True)))
        frame[q - line // 2:q + line // 2 + 1, lo - tick:lo] = True  # y ticks
    canvas[frame] = 0.0

    if labels is not None:
        sw = max(6, size // 40)
        right, bottom = _LEGEND_CORNERS[legend_loc]
        x0 = hi - 2 * sw if right else lo + sw
        y0 = (hi - sw * (2 * len(labels) + 1)) if bottom else lo + sw
        for i, _ in enumerate(labels):
            y = y0 + 2 * i * sw
            canvas[y:y + sw, x0:x0 + sw] = _COLORS[i % len(_COLORS)]
    img = np.rint(canvas).astype(np.uint8)
    if out_path is None:
        return img
    write_png(out_path, img)
    return None
