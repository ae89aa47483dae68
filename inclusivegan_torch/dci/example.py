#!/usr/bin/env python3
"""DCI example, as the reference's ``dci_code/example.py``: synthetic data of
low intrinsic dimension, index construction, and timed queries against brute
force. ``python -m inclusivegan_torch.dci.example``."""

import time

import numpy as np

from .dci import DCI


def gen_data(ambient_dim, intrinsic_dim, num_points, seed=0):
    """Points on a random ``intrinsic_dim``-dimensional subspace of
    R^ambient_dim: standard-normal coordinates times a uniform [-1, 1]
    basis, both from ``seed``."""
    rs = np.random.RandomState(seed)
    latent = rs.randn(num_points, intrinsic_dim)
    transform = 2 * rs.rand(intrinsic_dim, ambient_dim) - 1
    return np.dot(latent, transform)


def main():
    dim = 5000
    intrinsic_dim = 50
    num_points = 10000
    num_queries = 5
    num_neighbours = 10

    data_and_queries = gen_data(dim, intrinsic_dim, num_points + num_queries)
    data = data_and_queries[:num_points]
    queries = data_and_queries[num_points:]

    dci = DCI(dim, num_comp_indices=2, num_simp_indices=7)
    t0 = time.time()
    dci.add(data, num_levels=2)
    print(f"construction: {time.time() - t0:.2f}s for {num_points} points")

    t0 = time.time()
    ids, dists = dci.query(queries, num_neighbours=num_neighbours,
                           field_of_view=10, max_retrieve=200)
    print(f"query: {(time.time() - t0) / num_queries * 1000:.1f} ms/query")

    t0 = time.time()
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    bf = d2.argsort(1)[:, :num_neighbours]
    print(f"brute force: {(time.time() - t0) / num_queries * 1000:.1f} ms/query")
    recall = np.mean([len(set(ids[i]) & set(bf[i])) / num_neighbours
                      for i in range(num_queries)])
    print(f"recall@{num_neighbours}: {recall:.3f}")


if __name__ == "__main__":
    main()
