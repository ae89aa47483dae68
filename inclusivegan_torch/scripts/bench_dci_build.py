#!/usr/bin/env python3
"""Host-DCI index construction time against the pool size, fitted as the
power law that ``knn_backend="auto"`` routes by: the port's
``scripts/bench_dci_build.py``, with its flags, data and fit, on the port's
``dci.DCI`` (the JAX package's C++, built with ``g++``).

For each size n, ``dci.add`` of n seeded standard-normal points (one
``numpy.random.default_rng(0)`` stream over the sizes in order) into a
fresh index, timed on the host clock; then the fit t = c * n**p in log
space and its extrapolation to 2,400,000 points (the 240k stacked-MNIST
run's candidate pool at 10 samples per real).

    python -m inclusivegan_torch.scripts.bench_dci_build [--dim 128] [--sizes 8192,...]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--sizes", default="8192,16384,32768,65536,131072")
    ap.add_argument("--num-comp", type=int, default=3)
    ap.add_argument("--num-simp", type=int, default=15)
    ap.add_argument("--num-levels", type=int, default=2)
    args = ap.parse_args(argv)

    from inclusivegan_torch.dci import DCI

    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        data = rng.standard_normal((n, args.dim))
        dci = DCI(args.dim, args.num_comp, args.num_simp, seed=1)
        t0 = time.perf_counter()
        dci.add(data, num_levels=args.num_levels)
        dt = time.perf_counter() - t0
        rows.append((n, dt))
        print(f"n={n:>8d}  build {dt:8.2f} s  ({n / dt:,.0f} pts/s)", flush=True)

    ns = np.log([r[0] for r in rows])
    ts = np.log([r[1] for r in rows])
    p, logc = np.polyfit(ns, ts, 1)
    c = float(np.exp(logc))
    print(f"\nfit: t = {c:.3e} * n**{p:.3f}")
    for target in (240_000 * 10,):
        est = c * target ** p
        print(f"extrapolated build at n={target:,}: {est:,.0f} s ({est / 60:.1f} min)")
    return rows, c, p


if __name__ == "__main__":
    main()
