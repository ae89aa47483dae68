"""The LPIPS latent projector of the IvOM metric, ported from
``inclusivegan_tpu/projector.py``.

Each step blends the latents towards per-step noise latents by slerp with
a strength that decays quadratically, runs the eval-mode Gs
(``truncation_psi=1``, its stored noise images), brings the images to
[0, 255] and mean-pools them to at most 256 px, and takes the sum over the
minibatch of the LPIPS distances to the targets as the loss. Its gradient
with respect to the latents comes from autograd, through the kernels'
backward passes (``bias_lrelu_grad`` and upfirdn2d transposed on a CUDA
tensor), into ``training.optimizer.adam_apply`` (0.9, 0.999, 1e-8) with a
cosine learning-rate ramp up and down. The noise latents are drawn from a
``torch.Generator`` seeded at ``start``, or come from ``noise_fn(step)``
where a test hands in the JAX package's draws. ``set_network`` freezes the
Gs's parameters: only the latents are differentiated.
"""

from typing import Callable, Optional

import numpy as np
import torch

from .models.lpips import get_lpips_params, lpips_distance
from .training.loss import slerp
from .training.optimizer import adam_apply, init_adam
from .utils.easydict import EasyDict


def _pool_to(x: torch.Tensor, res: int) -> torch.Tensor:
    if x.shape[2] > res:
        f = x.shape[2] // res
        x = x.reshape(-1, x.shape[1], x.shape[2] // f, f, x.shape[3] // f, f).mean(dim=(3, 5))
    return x


def _proc(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> [0, 255], mean-pooled to at most 256 px."""
    return _pool_to((img + 1.0) * (255.0 / 2.0), 256)


class Projector:
    def __init__(self, num_steps: int = 1000, initial_learning_rate: float = 0.1,
                 initial_noise_factor: float = 0.05, lr_rampdown_length: float = 0.25,
                 lr_rampup_length: float = 0.05, noise_ramp_length: float = 0.75,
                 lpips_weights: Optional[str] = None, verbose: bool = False,
                 impl: str = "cuda",
                 noise_fn: Optional[Callable[[int], torch.Tensor]] = None):
        """``impl="plain"`` runs the plain versions of the kernels, to
        compare with them on the card. ``noise_fn(step)`` gives that step's
        noise latents [minibatch, latent_size]."""
        self.num_steps = num_steps
        self.initial_learning_rate = initial_learning_rate
        self.initial_noise_factor = initial_noise_factor
        self.lr_rampdown_length = lr_rampdown_length
        self.lr_rampup_length = lr_rampup_length
        self.noise_ramp_length = noise_ramp_length
        self.verbose = verbose
        self.impl = impl
        self.noise_fn = noise_fn
        self._lpips_weights = lpips_weights
        self._cur_step = None

    def _info(self, *args):
        if self.verbose:
            print("Projector:", *args)

    def set_network(self, G, minibatch_size: int = 1, num_steps: int = 1000,
                    initial_noise_factor: float = 0.05):
        """``G``: the eval-mode Gs (``GMain``) on its device."""
        self._G = G.requires_grad_(False)
        self._device = G.dlatent_avg.device
        self._minibatch = minibatch_size
        self.num_steps = num_steps
        self.initial_noise_factor = initial_noise_factor
        self._lpips_params = get_lpips_params(self._lpips_weights, device=self._device)
        self._proc_res = min(G.synthesis.resolution, 256)
        self._labels = torch.zeros((minibatch_size, G.mapping.label_size),
                                   device=self._device)

    def _images(self, z: torch.Tensor) -> torch.Tensor:
        return self._G(z, self._labels, truncation_psi=1.0, randomize_noise=False,
                       impl=self.impl)

    def ramps(self, step: int):
        """(noise strength, learning rate) at ``step``."""
        t = step / self.num_steps
        noise_strength = self.initial_noise_factor * max(
            0.0, 1.0 - t / self.noise_ramp_length) ** 2
        lr_ramp = min(1.0, (1.0 - t) / self.lr_rampdown_length)
        lr_ramp = 0.5 - 0.5 * np.cos(lr_ramp * np.pi)
        lr_ramp = lr_ramp * min(1.0, t / self.lr_rampup_length)
        return noise_strength, self.initial_learning_rate * lr_ramp

    def loss_and_grad(self, latents, noise_latents, noise_strength):
        """The LPIPS distances to the targets [minibatch], their sum and its
        gradient with respect to ``latents``."""
        lat = latents.detach().requires_grad_(True)
        z = slerp(lat, noise_latents, torch.tensor(noise_strength, dtype=torch.float32,
                                                   device=self._device))
        dist = lpips_distance(self._lpips_params, _proc(self._images(z)), self._targets_proc)
        loss = dist.sum()
        (grad,) = torch.autograd.grad(loss, [lat])
        return dist.detach(), loss.detach(), grad

    def start(self, target_images, init_latents=None, seed: int = 0):
        """``target_images`` [minibatch, C, H, W] in [-1, 1]; the latents start
        from ``init_latents``, else ``np.random.RandomState(seed)``."""
        target_images = np.asarray(target_images, np.float32)
        assert target_images.shape[0] == self._minibatch
        targets = torch.from_numpy(target_images).to(self._device)
        self._targets_proc = _pool_to((targets + 1.0) * (255.0 / 2.0), self._proc_res)
        if init_latents is None:
            init_latents = np.random.RandomState(seed).randn(
                self._minibatch, self._G.mapping.latent_size)
        self._latents = torch.as_tensor(np.asarray(init_latents, np.float32),
                                        device=self._device)
        self._opt_state = init_adam({"z": self._latents})
        self._generator = torch.Generator(self._device).manual_seed(seed)
        self._cur_step = 0
        self._last_dist = None

    def step(self):
        if self._cur_step >= self.num_steps:
            return
        noise_strength, learning_rate = self.ramps(self._cur_step)
        if self.noise_fn is not None:
            noise_latents = torch.as_tensor(self.noise_fn(self._cur_step),
                                            device=self._device)
        else:
            noise_latents = torch.randn(self._latents.shape, generator=self._generator,
                                        device=self._device)
        dist, loss, grad = self.loss_and_grad(self._latents, noise_latents, noise_strength)
        new, self._opt_state, _ = adam_apply(
            {"z": self._latents}, {"z": grad}, self._opt_state,
            learning_rate=learning_rate, beta1=0.9, beta2=0.999, epsilon=1e-8)
        self._latents = new["z"]
        self._last_dist = dist
        self._cur_step += 1
        if self._cur_step == self.num_steps or self._cur_step % 10 == 0:
            self._info(f"{self._cur_step:<8d}{float(dist.mean()):<12g}{float(loss):<12g}")

    def run(self, target_images):
        self.start(target_images)
        while self._cur_step < self.num_steps:
            self.step()
        return EasyDict(latents=self.get_latents(), images=self.get_images(),
                        dist=self.get_dist())

    def get_cur_step(self):
        return self._cur_step

    def get_latents(self) -> np.ndarray:
        return self._latents.cpu().numpy()

    def _eval_outputs(self):
        # noise strength 0: no blend (the mapping's pixel norm makes the
        # slerp's renormalization a no-op for the image anyway)
        with torch.no_grad():
            img = self._images(self._latents)
            return img, lpips_distance(self._lpips_params, _proc(img), self._targets_proc)

    def get_images(self) -> np.ndarray:
        return self._eval_outputs()[0].cpu().numpy()

    def get_dist(self) -> np.ndarray:
        return self._eval_outputs()[1].cpu().numpy()
