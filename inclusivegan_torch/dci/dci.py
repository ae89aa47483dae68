"""ctypes binding of the Prioritized DCI library (``csrc/``), with the JAX
package's API (``inclusivegan_tpu/dci/dci.py``): ``DCI(dim,
num_comp_indices, num_simp_indices, seed)`` over float64 C-contiguous inputs,
``add(data, num_levels, field_of_view, prop_to_retrieve, projections)``,
``query(queries, num_neighbours, field_of_view, prop_to_retrieve,
max_retrieve, max_visits, projections) -> (ids, dists)`` as ragged per-query
lists, ``clear``/``reset`` and the ``proj_vec`` property.

``add`` and ``query`` take precomputed ``projections`` (``data @
proj_vec.T``), so that the projection GEMM, the construction's largest cost,
runs as one matrix product on the card (``training/imle.py``) and the host
only sorts tables and walks them. The library is built at the first
``DCI``, never at import.
"""

import ctypes
import math
from typing import List, Optional, Tuple

import numpy as np

from .build import build_dci_lib

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        c = ctypes.CDLL(str(build_dci_lib()))
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        c.dci_new.restype = p
        c.dci_new.argtypes = [i, i, i, ctypes.c_ulonglong]
        c.dci_free.argtypes = [p]
        c.dci_add.argtypes = [p, l, p, p, i]
        c.dci_query.argtypes = [p, l, p, p, i, l, l, i, p, p, p]
        c.dci_clear.argtypes = [p]
        c.dci_reset.argtypes = [p, ctypes.c_ulonglong]
        c.dci_num_points.restype = l
        c.dci_num_points.argtypes = [p]
        c.dci_num_levels.restype = i
        c.dci_num_levels.argtypes = [p]
        c.dci_get_proj_vecs.argtypes = [p, p]
        _LIB = c
    return _LIB


def _as_f64(arr, name: str) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {arr.shape}")
    return arr


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class DCI:
    """A Prioritized DCI index over points of dimension ``dim``:
    ``num_comp_indices`` composite indices of ``num_simp_indices`` random
    unit directions each, drawn from ``seed``."""

    def __init__(self, dim: int, num_comp_indices: int = 2,
                 num_simp_indices: int = 7, seed: int = 0):
        self._dim = int(dim)
        self._num_comp = int(num_comp_indices)
        self._num_simp = int(num_simp_indices)
        self._handle = _lib().dci_new(self._dim, self._num_comp, self._num_simp, seed)
        self._data = None  # the library borrows these buffers: keep them alive
        self._proj = None
        self.num_points = 0

    def __del__(self):
        if getattr(self, "_handle", None):
            _lib().dci_free(self._handle)
            self._handle = None

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def num_comp_indices(self) -> int:
        return self._num_comp

    @property
    def num_simp_indices(self) -> int:
        return self._num_simp

    @property
    def num_levels(self) -> int:
        return _lib().dci_num_levels(self._handle)

    @property
    def proj_vec(self) -> np.ndarray:
        """The random unit directions, [num_comp * num_simp, dim] float64."""
        out = np.empty((self._num_comp * self._num_simp, self._dim), np.float64)
        _lib().dci_get_proj_vecs(self._handle, _ptr(out))
        return out

    def _projections(self, projections, n: int, name: str):
        if projections is None:
            return None
        projections = _as_f64(projections, name)
        want = (n, self._num_comp * self._num_simp)
        if projections.shape != want:
            raise ValueError(f"{name}: shape {projections.shape}, expected {want}")
        return projections

    def add(self, data, num_levels: int = 2, field_of_view: int = 10,
            prop_to_retrieve: float = 0.002,
            projections: Optional[np.ndarray] = None) -> None:
        """Build the index over ``data`` [n, dim] in one call (one add per
        reset, as the reference). ``projections``: optional [n, m * L] =
        ``data @ proj_vec.T``. ``field_of_view`` and ``prop_to_retrieve``
        are kept for the reference's signature; the construction's search
        budgets are internal."""
        data = _as_f64(data, "data")
        if data.shape[1] != self._dim:
            raise ValueError(f"data: dimension {data.shape[1]}, index {self._dim}")
        if self.num_points:
            raise RuntimeError("call clear() or reset() before adding again")
        projections = self._projections(projections, data.shape[0], "projections")
        self._data, self._proj = data, projections
        _lib().dci_add(self._handle, data.shape[0], _ptr(data),
                       None if projections is None else _ptr(projections),
                       int(num_levels))
        self.num_points = data.shape[0]

    def query(self, queries, num_neighbours: int = 1, field_of_view: int = 100,
              prop_to_retrieve: float = 1.0, max_retrieve: Optional[int] = None,
              max_visits: Optional[int] = None,
              projections: Optional[np.ndarray] = None
              ) -> Tuple[List[List[int]], List[List[float]]]:
        """k nearest neighbours of each query, nearest first, as ragged
        per-query (ids, dists) lists. The budgets: ``max_retrieve =
        min(ceil(prop_to_retrieve * n), max(512, 32 k))`` candidates (at
        least k) are ranked exactly per query, and ``field_of_view`` cells
        are descended per level; ``max_visits`` defaults to
        ``max(16 max_retrieve, 2048)``."""
        queries = _as_f64(queries, "queries")
        if queries.shape[1] != self._dim:
            raise ValueError(f"queries: dimension {queries.shape[1]}, index {self._dim}")
        n = self.num_points
        if n == 0:
            raise RuntimeError("the index is empty")
        k = int(num_neighbours)
        if max_retrieve is None:
            cap = max(512, 32 * k)
            max_retrieve = min(max(int(math.ceil(prop_to_retrieve * n)), k), cap)
        if max_visits is None:
            max_visits = max(16 * max_retrieve, 2048)
        projections = self._projections(projections, queries.shape[0],
                                        "query projections")
        nq = queries.shape[0]
        out_ids = np.empty((nq, k), np.int32)
        out_dists = np.empty((nq, k), np.float64)
        out_counts = np.empty((nq,), np.int32)
        _lib().dci_query(self._handle, nq, _ptr(queries),
                         None if projections is None else _ptr(projections), k,
                         int(max_retrieve), int(max_visits), int(field_of_view),
                         _ptr(out_ids), _ptr(out_dists), _ptr(out_counts))
        ids = [out_ids[i, :out_counts[i]].tolist() for i in range(nq)]
        dists = [out_dists[i, :out_counts[i]].tolist() for i in range(nq)]
        return ids, dists

    def clear(self) -> None:
        """Drop the points; keep the directions."""
        _lib().dci_clear(self._handle)
        self._data = self._proj = None
        self.num_points = 0

    def reset(self, seed: int = 0) -> None:
        """Drop the points and draw new directions from ``seed``."""
        _lib().dci_reset(self._handle, seed)
        self._data = self._proj = None
        self.num_points = 0
