"""The metric framework, ported from ``inclusivegan_tpu/metrics/metric_base.py``.

Each metric evaluates the Gs of a network pickle on its own: ``GsSampler``
loads it with ``snapshot.load_snapshot`` (the stored compute dtype dropped,
so float32, as the JAX package loads it), draws the latents as one
contiguous seeded PCG64 stream, so that both packages draw the same latents
from the same seed, and quantizes the images to uint8 on the card. The
synthesis noise of each batch comes from the sampler's ``torch.Generator``
(JAX's stream cannot be reproduced), or from ``noise_fn`` where a test hands
in the JAX package's draws.

``MetricBase.run`` caches real statistics under ``INCLUSIVEGAN_CACHE``
(default ``~/.cache/inclusivegan_torch``), keyed by the md5 of the evaluation
arguments; recovers the dataset and mirror augmentation from the run dir
when not given; appends its result line to ``<run_dir>/metric-<name>.txt``;
and returns {name + suffix: value}.
"""

import hashlib
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..snapshot import load_snapshot
from ..utils.registry import get_obj_by_name


def _cache_dir() -> str:
    d = os.environ.get("INCLUSIVEGAN_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache",
                                    "inclusivegan_torch"))
    os.makedirs(d, exist_ok=True)
    return d


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8 [0, 255] on their device: rint(clip((x + 1)
    * 127.5, 0, 255)), rounding half to even as ``jnp.rint`` does."""
    return torch.round(torch.clamp((images + 1.0) * 127.5, 0, 255)).to(torch.uint8)


class GsSampler:
    """Batched eval-mode sampler of a snapshot's Gs on one device.

    ``truncation_psi`` None samples without truncation. ``noise_fn``, given
    a batch size, returns that batch's synthesis noise dict
    ({"noise<i>": [B, 1, h, w]}); by default it is drawn from a generator
    seeded with ``seed``."""

    def __init__(self, network_pkl: str, minibatch_size: int = 32,
                 truncation_psi: Optional[float] = None, seed: int = 1000,
                 device="cuda",
                 noise_fn: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None):
        self.device = torch.device(device)
        self.G = load_snapshot(network_pkl, device=self.device)
        self.minibatch = minibatch_size
        self.latent_size = self.G.mapping.latent_size
        self.label_size = self.G.mapping.label_size
        self.resolution = self.G.synthesis.resolution
        self.num_channels = self.G.synthesis.num_channels
        self._psi = 1.0 if truncation_psi is None else truncation_psi
        generator = torch.Generator(self.device).manual_seed(seed)
        self._noise_fn = noise_fn or (
            lambda bs: self.G.synthesis.draw_noise(bs, generator))

    def _sample(self, z: torch.Tensor) -> torch.Tensor:
        labels = torch.zeros((z.shape[0], self.label_size), device=self.device)
        return to_uint8(self.G(z, labels, truncation_psi=self._psi,
                               noise=self._noise_fn(z.shape[0]), randomize_noise=False))

    def run(self, latents: np.ndarray) -> np.ndarray:
        """latents [N, Z] -> uint8 images [N, C, H, W], in batches of
        ``minibatch`` padded with zeros. The batches are queued on the card
        and copied to the host once."""
        outs = []
        bs = self.minibatch
        with torch.no_grad():
            for i in range(0, latents.shape[0], bs):
                z = latents[i:i + bs]
                n = z.shape[0]
                if n < bs:
                    z = np.concatenate([z, np.zeros((bs - n, z.shape[1]), z.dtype)])
                outs.append(self._sample(torch.as_tensor(z, device=self.device))[:n])
            return torch.cat(outs).cpu().numpy()

    def random_images(self, num: int, seed: int = 0) -> Iterator[np.ndarray]:
        """Yields image chunks of ``max(minibatch, 1024)`` for ``num`` latents
        drawn as one contiguous PCG64 stream from ``seed``."""
        rnd = np.random.Generator(np.random.PCG64(seed))
        chunk = max(self.minibatch, 1024)
        done = 0
        while done < num:
            take = min(chunk, num - done)
            yield self.run(rnd.standard_normal((take, self.latent_size),
                                               dtype=np.float32))
            done += take


def apply_in_batches(fn, images: np.ndarray, minibatch: int) -> np.ndarray:
    """``fn`` over ``images`` in slices of ``minibatch``, concatenated: the
    feature nets see the metric's own batch size, whatever the chunks."""
    return np.concatenate([fn(images[i:i + minibatch])
                           for i in range(0, images.shape[0], minibatch)])


class MetricBase:
    def __init__(self, name: str):
        self.name = name
        self._results = []
        self._eval_time = 0.0
        self._network_name = ""
        self._mirror_augment = False
        self._mirror_rng = np.random.default_rng(123)

    def _get_cache_file(self, extension="pkl", **kwargs) -> str:
        md5 = hashlib.md5(repr(sorted(kwargs.items())).encode()).hexdigest()
        return os.path.join(_cache_dir(), f"{md5}-{self.name}.{extension}")

    def run(self, network_pkl: str, run_dir: Optional[str] = None,
            dataset_args: dict = {}, data_dir: Optional[str] = None,
            minibatch_size: int = 32, mirror_augment: Optional[bool] = None,
            device="cuda", **eval_kwargs) -> Dict[str, float]:
        """Evaluate the snapshot's Gs; print and return the results."""
        from ..utils.misc import parse_config_for_previous_run
        self._results = []
        self._network_name = os.path.splitext(os.path.basename(network_pkl))[0]
        if mirror_augment is None and run_dir is not None:
            # the run's own augmentation, so that real statistics match the
            # distribution training saw
            try:
                mirror_augment = bool(parse_config_for_previous_run(run_dir)
                                      ["train"].get("mirror_augment", False))
            except Exception:
                mirror_augment = False
        self._mirror_augment = bool(mirror_augment or False)
        self._mirror_rng = np.random.default_rng(123)
        if not dataset_args and run_dir is not None:
            try:
                dataset_args = parse_config_for_previous_run(run_dir)["dataset"]
            except Exception as e:
                print(f"warning: no dataset config recoverable from {run_dir} ({e}); "
                      "metrics needing reals will fail")
                dataset_args = {}
        t0 = time.time()
        sampler = GsSampler(network_pkl, minibatch_size=minibatch_size, device=device)
        self._evaluate(sampler, dataset_args=dict(dataset_args), data_dir=data_dir,
                       **eval_kwargs)
        self._eval_time = time.time() - t0

        result_str = self.get_result_str()
        print(result_str)
        if run_dir is not None:
            with open(os.path.join(run_dir, f"metric-{self.name}.txt"), "a") as f:
                f.write(result_str + "\n")
        return {f"{self.name}{suffix}": value for value, suffix, _fmt in self._results}

    def get_result_str(self) -> str:
        out = f"{self._network_name:<30s} time {self._eval_time:<12.1f}"
        for value, suffix, fmt in self._results:
            out += f" {self.name}{suffix} {value:{fmt}}"
        return out

    def _report_result(self, value, suffix="", fmt="-10.4f"):
        self._results.append((value, suffix, fmt))

    def _open_dataset(self, dataset_args, data_dir):
        from ..data.dataset import load_dataset
        return load_dataset(data_dir=data_dir, shuffle=False, **dataset_args)

    def _reals_batch(self, dataset, n):
        """A real minibatch with the run's mirror augmentation applied."""
        from ..utils.misc import apply_mirror_augment
        imgs, labels = dataset.get_minibatch_np(n)
        if self._mirror_augment:
            imgs = apply_mirror_augment(imgs, self._mirror_rng)
        return imgs, labels

    def _fakes_through(self, sampler: GsSampler, num: int, fn, minibatch: int
                       ) -> np.ndarray:
        """``fn`` over ``num`` of the sampler's images in slices of
        ``minibatch``, concatenated. Prints the images/s of the Gs and of
        ``fn`` on the host clock (both end in a copy to the host, which waits
        for the card)."""
        outs, t_gs, t_fn = [], 0.0, 0.0
        images = sampler.random_images(num)
        while True:
            t0 = time.perf_counter()
            imgs = next(images, None)
            t1 = time.perf_counter()
            if imgs is None:
                break
            outs.append(apply_in_batches(fn, imgs, minibatch))
            t_gs += t1 - t0
            t_fn += time.perf_counter() - t1
        print(f"{self.name}: Gs {num} images in {t_gs:.2f} s, "
              f"{num / max(t_gs, 1e-9):.1f} images/s")
        print(f"{self.name}: {getattr(fn, 'label', 'feature net')} {num} images in "
              f"{t_fn:.2f} s, {num / max(t_fn, 1e-9):.1f} images/s")
        return np.concatenate(outs)

    def _evaluate(self, sampler: GsSampler, dataset_args, data_dir, **kwargs):
        raise NotImplementedError


class DummyMetric(MetricBase):
    def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
        self._report_result(0.0)


class MetricGroup:
    def __init__(self, metric_arg_list):
        self.metrics = [make_metric(**args) for args in metric_arg_list]

    def run(self, *args, **kwargs):
        results = {}
        for metric in self.metrics:
            results.update(metric.run(*args, **kwargs))
        return results


def make_metric(name: str, func_name: str, **kwargs) -> MetricBase:
    """The metric of a registry entry (``metric_defaults``)."""
    return get_obj_by_name(func_name)(name=name, **kwargs)


def run_metric(args: dict, network_pkl: str, dataset_args: dict = {},
               data_dir: Optional[str] = None, run_dir: Optional[str] = None,
               **kwargs) -> Dict[str, float]:
    metric = make_metric(**dict(args))
    return metric.run(network_pkl, run_dir=run_dir, dataset_args=dataset_args,
                      data_dir=data_dir, **kwargs)
