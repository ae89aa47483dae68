"""A persistent DCI index that tensor code can query, the counterpart of the
JAX package's ``dci/jax_op.py::DciNnSearch`` (the reference's TF CPU op
``DciNnSearch``).

``update_db`` rebuilds the index; ``nn_search`` answers a batch of queries
given as a tensor on any device and returns ``(ids int32, dists float32)``
of shape [Nq, k] on that device, padded with -1 where a query found fewer
than k neighbours. An ``RLock`` guards the index, as the reference's mutexes
do. The IMLE loop calls ``DCI`` directly; this exists for the API.
"""

import threading
from typing import Tuple

import numpy as np
import torch

from .dci import DCI


class DciNnSearch:
    def __init__(self, dim: int, num_comp_indices: int = 2,
                 num_simp_indices: int = 7, num_levels: int = 2, seed: int = 0):
        self._dci = DCI(dim, num_comp_indices, num_simp_indices, seed=seed)
        self._num_levels = num_levels
        self._lock = threading.RLock()

    def update_db(self, data) -> None:
        """Rebuild the persistent index over ``data`` [n, dim]."""
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        with self._lock:
            if self._dci.num_points:
                self._dci.clear()
            self._dci.add(np.asarray(data, np.float64), num_levels=self._num_levels)

    def nn_search(self, queries: torch.Tensor, num_neighbours: int = 1,
                  max_retrieve: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
        """[Nq, dim] -> (ids [Nq, k] int32, dists [Nq, k] float32) on the
        queries' device."""
        k = num_neighbours
        q = queries.detach().cpu().numpy().astype(np.float64)
        with self._lock:
            ids, dists = self._dci.query(q, num_neighbours=k, max_retrieve=max_retrieve)
        out_ids = np.full((q.shape[0], k), -1, np.int32)
        out_d = np.full((q.shape[0], k), -1.0, np.float32)
        for i, (row_i, row_d) in enumerate(zip(ids, dists)):
            out_ids[i, :len(row_i)] = row_i
            out_d[i, :len(row_d)] = row_d
        return (torch.from_numpy(out_ids).to(queries.device),
                torch.from_numpy(out_d).to(queries.device))
