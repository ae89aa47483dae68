"""Recall@1 of the JAX package's DCI and the port's at the IMLE
orchestrator's index settings (dim 512, 3 x 15 directions, field of view
200, k = 1, the default budgets: ``max_retrieve`` 512, ``max_visits`` 8192),
on ``dci/example.py``'s low-intrinsic-dimension generator (intrinsic dim 50),
against the exact 1-NN in float64, at several ``num_levels`` and
``max_visits`` (the last, 10**7, never binds: the walk stops when 512
points have been seen in all the directions of a composite index); and
whether the two packages return the same ids and distances at each. Both
are builds of the same C++ source. Run it from the root of the repository
(about a minute at the defaults):

    python tests/torch_golden/dci_recall.py [--n 16384] [--queries 500]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

DIM, INTRINSIC, TABLES, FOV = 512, 50, (3, 15), 200
LEVELS = (1, 2, 3)
# None: the default, 8192; 10**7: a walk that stops only at max_retrieve
MAX_VISITS = (None, 32768, 131072, 524288, 10 ** 7)


def sample(n, num_queries, seed=0):
    """(data, queries, exact 1-NN ids of the queries) from the generator."""
    from inclusivegan_torch.dci.example import gen_data
    x = gen_data(DIM, INTRINSIC, n + num_queries, seed=seed)
    data, queries = x[:n], x[n:]
    d2 = ((queries ** 2).sum(1)[:, None] - 2 * queries @ data.T
          + (data ** 2).sum(1)[None])
    return data, queries, d2.argmin(1)


def query(index, queries, max_visits):
    """(ids, dists) of the k = 1 query at the orchestrator's settings."""
    return index.query(queries, num_neighbours=1, field_of_view=FOV,
                       max_visits=max_visits)


def recall(ids, exact):
    return float(np.mean(np.array([i[0] if i else -1 for i in ids]) == exact))


def main():
    from inclusivegan_torch.dci import DCI
    from inclusivegan_tpu.dci import DCI as JDCI
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=500)
    args = ap.parse_args()
    data, queries, exact = sample(args.n, args.queries)
    print(f"n {args.n} x {DIM}, {args.queries} queries, {TABLES[0]} x {TABLES[1]} "
          f"directions, field of view {FOV}, k 1; {os.cpu_count()} host cores")
    for levels in LEVELS:
        port, jax_pkg = DCI(DIM, *TABLES, seed=1), JDCI(DIM, *TABLES, seed=1)
        t = time.perf_counter()
        port.add(data, num_levels=levels)
        build_s = time.perf_counter() - t
        jax_pkg.add(data, num_levels=levels)
        for mv in MAX_VISITS:
            p, j = query(port, queries, mv), query(jax_pkg, queries, mv)
            print(f"levels {levels} (port build {build_s:.2f} s), max_visits "
                  f"{mv or 'default 8192'}: recall@1 JAX package {recall(j[0], exact):.4f}, "
                  f"port {recall(p[0], exact):.4f}; ids and distances equal: {p == j}",
                  flush=True)


if __name__ == "__main__":
    main()
