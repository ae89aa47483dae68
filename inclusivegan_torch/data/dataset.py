"""Dataset readers of the training loop, copied from
``inclusivegan_tpu/data/dataset.py``: ``TFRecordDataset`` (the
``<name>-r{log2res:02d}.tfrecords`` shards and the ``<name>-rxx.labels``
float32 .npy), ``SyntheticDataset``, ``load_dataset`` and the
``Prefetcher``.

A dataset is held in host memory as one uint8 array and served as uint8
numpy minibatches, in a fixed order or shuffled by
``np.random.RandomState(seed)``; the IMLE cursor arithmetic depends on that
order. The train step converts to [-1, 1] on the card, so the host-to-card
copies stay uint8.
"""

import glob
import os
import threading
import queue as queue_mod
from typing import Optional, Tuple

import numpy as np

from . import tfrecord

# decoded-shard cache shared by concurrently-open streams (weak: freed once
# no dataset holds the array)
import weakref
_IMAGE_CACHE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class TFRecordDataset:
    def __init__(self, tfrecord_dir: str, resolution: Optional[int] = None,
                 label_file: Optional[str] = None, max_label_size=0,
                 repeat: bool = True, shuffle: bool = True, seed: int = 0,
                 in_memory: bool = True, max_images: Optional[int] = None,
                 **_kwargs):
        self.tfrecord_dir = tfrecord_dir
        self.name = os.path.basename(os.path.abspath(tfrecord_dir))
        tfr_files = sorted(glob.glob(os.path.join(tfrecord_dir, "*.tfrecords")))
        assert len(tfr_files) >= 1, f"no tfrecords in {tfrecord_dir}"
        # resolve per-LOD shards by the -rNN suffix
        by_res = {}
        for f in tfr_files:
            stem = os.path.basename(f)[:-len(".tfrecords")]
            try:
                res_log2 = int(stem.rsplit("-r", 1)[1])
            except (IndexError, ValueError):
                continue
            by_res[2 ** res_log2] = f
        assert by_res, f"no -rNN.tfrecords shards in {tfrecord_dir}"
        self.available_resolutions = sorted(by_res)
        self.resolution = resolution or max(by_res)
        assert self.resolution in by_res, (self.resolution, list(by_res))
        self._tfr_file = by_res[self.resolution]

        # load images — bulk-decoded, and shared across streams: the loop
        # opens train + rec streams over the same shard (reference
        # training_loop.py:169-170), so cache the decoded array by file
        key = (os.path.abspath(self._tfr_file), max_images)
        cached = _IMAGE_CACHE.get(key)
        if cached is None:
            cached = tfrecord.load_image_records(self._tfr_file,
                                                 max_images=max_images)
            cached.flags.writeable = False  # shared across streams
            _IMAGE_CACHE[key] = cached
        images = cached
        self._images = images if in_memory else None
        self.shape = list(images[0].shape)  # [C,H,W]
        self.dtype = "uint8"
        self.dynamic_range = [0, 255]
        self.resolution_log2 = int(np.log2(self.resolution))
        self.num_images = len(images)

        # labels (reference: float32 npy next to the shards, dataset.py:87-95)
        if label_file is None:
            guess = sorted(glob.glob(os.path.join(tfrecord_dir, "*.labels")))
            label_file = guess[0] if guess else None
        self._np_labels = None
        if label_file is not None and os.path.exists(label_file):
            self._np_labels = np.load(label_file).astype(np.float32)
            if self._np_labels.ndim == 1:
                self._np_labels = self._np_labels[:, None]
            self._np_labels = self._np_labels[:self.num_images]
        if self._np_labels is None or (max_label_size == 0):
            self._np_labels = np.zeros((self.num_images, 0), np.float32)
        elif max_label_size != "full":
            self._np_labels = self._np_labels[:, :int(max_label_size)]
        self.label_size = self._np_labels.shape[1]
        self.label_dtype = "float32"

        self._rng = np.random.RandomState(seed)
        self._repeat = repeat
        self._shuffle = shuffle
        self._order = np.arange(self.num_images)
        self._cursor = self.num_images  # force reshuffle on first use

    # ------------------------------------------------------------------
    def get_minibatch_np(self, minibatch_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Next shuffled minibatch (wraps around epochs)."""
        idx = np.empty(minibatch_size, np.int64)
        filled = 0
        while filled < minibatch_size:
            if self._cursor >= self.num_images:
                if self._shuffle:
                    self._rng.shuffle(self._order)
                self._cursor = 0
            take = min(minibatch_size - filled, self.num_images - self._cursor)
            idx[filled:filled + take] = self._order[self._cursor:self._cursor + take]
            self._cursor += take
            filled += take
        return self._images[idx], self._np_labels[idx]

    def get_random_labels_np(self, minibatch_size: int) -> np.ndarray:
        if self.label_size == 0:
            return np.zeros((minibatch_size, 0), np.float32)
        idx = self._rng.randint(self.num_images, size=minibatch_size)
        return self._np_labels[idx]

    def get_all_images(self) -> np.ndarray:
        return self._images

    def get_all_labels(self) -> np.ndarray:
        return self._np_labels


class SyntheticDataset:
    """Deterministic random-image dataset for tests and benchmarks."""

    def __init__(self, resolution=32, num_channels=3, num_images=256,
                 label_size=0, seed=0, **_kwargs):
        r = np.random.RandomState(seed)
        self._images = r.randint(0, 256, (num_images, num_channels,
                                          resolution, resolution)).astype(np.uint8)
        self._np_labels = np.zeros((num_images, label_size), np.float32)
        if label_size:
            self._np_labels[np.arange(num_images),
                            r.randint(label_size, size=num_images)] = 1.0
        self.shape = [num_channels, resolution, resolution]
        self.resolution = resolution
        self.resolution_log2 = int(np.log2(resolution))
        self.dynamic_range = [0, 255]
        self.label_size = label_size
        self.num_images = num_images
        self._rng = np.random.RandomState(seed + 1)

    def get_minibatch_np(self, minibatch_size):
        idx = self._rng.randint(self.num_images, size=minibatch_size)
        return self._images[idx], self._np_labels[idx]

    def get_random_labels_np(self, minibatch_size):
        idx = self._rng.randint(self.num_images, size=minibatch_size)
        return self._np_labels[idx]

    def get_all_images(self):
        return self._images

    def get_all_labels(self):
        return self._np_labels


def load_dataset(class_name: str = "inclusivegan_torch.data.dataset.TFRecordDataset",
                 data_dir: Optional[str] = None, verbose: bool = False,
                 **kwargs):
    """Factory by dotted class name; ``tfrecord_dir`` is taken under
    ``data_dir``."""
    from ..utils.registry import get_obj_by_name
    if "tfrecord_dir" in kwargs and data_dir is not None:
        kwargs = dict(kwargs)
        kwargs["tfrecord_dir"] = os.path.join(data_dir, kwargs["tfrecord_dir"])
    ds = get_obj_by_name(class_name)(**kwargs)
    if verbose:
        print(f"Dataset shape = {ds.shape}")
        print(f"Dynamic range = {ds.dynamic_range}")
        print(f"Label size    = {ds.label_size}")
    return ds


class _PrefetchError:
    """Exception wrapper distinguishable from legitimate fn() results."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Background-thread minibatch prefetch so host batch assembly overlaps
    device steps.

    ``fn`` must return host arrays (numpy): the training loop copies each
    batch to the card on its own thread, on the step's stream, so that no
    copy issued from the worker can race the step.

    The worker is the SOLE consumer of whatever iterator state ``fn``
    touches while the prefetcher is open: every ``fn()`` result is delivered
    exactly once and in order (a full queue blocks the worker — it never
    re-invokes ``fn`` to retry a put), so prefetched and inline assembly
    produce identical batch streams. ``close()`` joins the worker before
    returning, after which the caller may safely mutate the shared state
    (e.g. an IMLE candidate rebuild) — at most ``depth``+1 already-assembled
    batches are discarded."""

    def __init__(self, fn, depth: int = 2):
        self._fn = fn
        self._q = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._fn()
            except BaseException as e:  # surface in get()
                item = _PrefetchError(e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue_mod.Full:
                    continue
            if isinstance(item, _PrefetchError):
                return

    def get(self):
        while True:
            try:
                item = self._q.get(timeout=10.0)
                break
            except queue_mod.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("Prefetcher worker exited without "
                                       "producing a batch")
        if isinstance(item, _PrefetchError):
            raise item.exc
        return item

    def close(self):
        """Stop the worker and join it; pending batches are discarded."""
        self._stop.set()
        while self._thread.is_alive():
            try:  # unblock a worker stuck on a full queue
                self._q.get_nowait()
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.2)
