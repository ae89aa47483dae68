"""Self-registering scalar statistics ("autosummary" equivalent), copied
from ``inclusivegan_tpu/utils/stats.py``.

The training step returns its loss scalars; the loop reads them to the host
now and then and accumulates them here. The flush at each tick writes a
JSONL record (``stats.jsonl`` in the run dir) and returns the means, which
the loop also writes as TensorBoard events (``tfevents.py``).
"""

import json
import math
import os
import threading
import time
from typing import Dict, Optional


class _Moments:
    __slots__ = ("n", "s", "s2")

    def __init__(self):
        self.n = 0.0
        self.s = 0.0
        self.s2 = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            return
        self.n += weight
        self.s += v * weight
        self.s2 += v * v * weight

    @property
    def mean(self) -> float:
        return self.s / self.n if self.n > 0 else float("nan")

    @property
    def std(self) -> float:
        if self.n <= 0:
            return float("nan")
        var = max(self.s2 / self.n - self.mean ** 2, 0.0)
        return math.sqrt(var)


class StatsCollector:
    """Accumulates named scalars between flushes."""

    def __init__(self, run_dir: Optional[str] = None):
        self._moments: Dict[str, _Moments] = {}
        self._lock = threading.Lock()
        self._file = None
        if run_dir is not None:
            self.set_run_dir(run_dir)

    def set_run_dir(self, run_dir: str) -> None:
        if self._file is not None:
            self._file.close()
        self._file = open(os.path.join(run_dir, "stats.jsonl"), "a")

    def report(self, name: str, value, weight: float = 1.0) -> None:
        with self._lock:
            m = self._moments.setdefault(name, _Moments())
            m.update(float(value), weight)

    def report_dict(self, scalars: Dict[str, float], prefix: str = "") -> None:
        for k, v in scalars.items():
            self.report(prefix + k, v)

    def means(self) -> Dict[str, float]:
        with self._lock:
            return {k: m.mean for k, m in self._moments.items() if m.n > 0}

    def flush(self, step: Optional[int] = None) -> Dict[str, float]:
        """Return means since the last flush, reset accumulators, and append a
        JSONL record to the run dir if one is attached."""
        with self._lock:
            out = {k: m.mean for k, m in self._moments.items() if m.n > 0}
            self._moments.clear()
        if self._file is not None:
            rec = dict(out)
            rec["_step"] = step
            rec["_time"] = time.time()
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        return out

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
