"""StyleGAN2 generator and discriminator, ported from
``inclusivegan_tpu/models/stylegan2.py``.

``GMapping``, ``GSynthesis`` (skip, resnet and orig), ``GMain`` in eval mode
with truncation and in training mode with style mixing (``map_latents``,
``forward(is_training=True)``), ``minibatch_stddev`` and the
``Discriminator`` with its features head (skip, resnet and orig, one body).
Parameters and buffers carry the JAX package's names
(``synthesis.4x4.Conv.weight`` is ``params["synthesis"]["4x4"]["Conv"]
["weight"]``); dense weights keep the JAX layout [in, out], conv weights are
OIHW ([k, k, I, O] there). ``snapshot.gmain_from_params`` and
``snapshot.discriminator_from_params`` carry a JAX parameter tree across.

Parameters keep the dtype they were loaded with (the CelebA snapshot stores
float16) while activations run in float32 (the JAX package's bf16 compute
knob is not ported yet). Scalings of a
parameter by a Python constant round in the parameter's dtype, as JAX's weak
typing does (``_scale``), so the port computes what the JAX package computes.

Random draws are explicit: synthesis noise is a dict of tensors (the
``noise`` buffers by default, or per-example [B, 1, h, w] draws from
``GSynthesis.draw_noise``) or, with ``randomize_noise=True``, comes from the
``torch.Generator`` the caller passes. Style mixing takes its second latents
and its cutoff as an argument (``GMain.draw_mixing`` draws them), so that a
test can hand in the JAX package's draws.
"""

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (conv_downsample2d, downsample2d, fused_bias_act,
                   upsample2d, upsample_conv2d)


def nf(stage: int, fmap_base: int = 16 << 10, fmap_decay: float = 1.0,
       fmap_min: int = 1, fmap_max: int = 512) -> int:
    """Feature-map count schedule."""
    return int(np.clip(int(fmap_base / (2.0 ** (stage * fmap_decay))),
                       fmap_min, fmap_max))


def _wcoef(fan_in: int, gain: float = 1.0, use_wscale: bool = True,
           lrmul: float = 1.0) -> float:
    """Equalized-learning-rate runtime coefficient."""
    he_std = gain / math.sqrt(fan_in)
    return he_std * lrmul if use_wscale else lrmul


def _scale(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t * s`` with ``s`` rounded to ``t``'s dtype first, as JAX multiplies
    an array by a Python float."""
    return t * torch.tensor(s, dtype=t.dtype, device=t.device)


def _dense(x, w, lrmul=1.0, gain=1.0):
    """x @ (w * coef), w: [in, out]."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    coef = _wcoef(w.shape[0], gain=gain, lrmul=lrmul)
    return x @ _scale(w, coef).to(x.dtype)


def _bias_act(x, b, act="linear", lrmul=1.0, gain=None, axis=1, impl="cuda"):
    return fused_bias_act(x, _scale(b, lrmul).to(x.dtype), axis=axis, act=act,
                          gain=gain, impl=impl)


def _conv2d(x, w, up=False, down=False, resample_kernel=None, lrmul=1.0,
            gain=1.0, impl="cuda"):
    """SAME conv with optional fused resample. w: [O, I, k, k] raw param."""
    coef = _wcoef(w[0].numel(), gain=gain, lrmul=lrmul)
    w = _scale(w, coef).to(x.dtype)
    if up:
        return upsample_conv2d(x, w, resample_kernel, factor=2, impl=impl)
    if down:
        return conv_downsample2d(x, w, resample_kernel, factor=2, impl=impl)
    return F.conv2d(x, w, padding=w.shape[2] // 2)


def _modulated_conv2d(x, style_w, p, *, up=False, down=False, demodulate=True,
                      resample_kernel=None, lrmul=1.0, impl="cuda"):
    """Modulated conv in the scale -> conv -> scale form, with demodulation.

    p: module with ``weight`` [O, I, k, k], ``mod_weight`` [D, I] and
    ``mod_bias`` [I]. style_w: [B, D] dlatent slice for this layer."""
    w = p.weight
    s = _dense(style_w.float(), p.mod_weight)
    s = s + p.mod_bias + 1.0  # bias initialized to 0 -> style ~ 1
    x = x * s[:, :, None, None].to(x.dtype)
    x = _conv2d(x, w, up=up, down=down, resample_kernel=resample_kernel,
                lrmul=lrmul, impl=impl)
    if demodulate:
        coef = _wcoef(w[0].numel(), lrmul=lrmul)
        wsq = _scale(w.float(), coef).square().sum(dim=(2, 3)).t()  # [I, O]
        d = torch.rsqrt(s.square() @ wsq + 1e-8)  # [B, O]
        x = x * d[:, :, None, None].to(x.dtype)
    return x


def _params(**shapes) -> nn.Module:
    """A module holding one zero parameter per (name, shape); the values come
    from ``snapshot.gmain_from_params``."""
    m = nn.Module()
    for name, shape in shapes.items():
        m.register_parameter(name, nn.Parameter(torch.zeros(shape)))
    return m


def minibatch_stddev(x, group_size: int = 6, num_new_features: int = 1,
                     contiguous: bool = False):
    """Append the mean standard deviation over groups of the batch as
    ``num_new_features`` channels. Example n joins group n % M (strided) or,
    with ``contiguous=True``, group n // g. Statistics in float32."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    if n % g != 0:  # groups must divide the batch; else one group of all
        g = n
    f = num_new_features
    if contiguous:
        y = x.reshape(-1, g, f, c // f, h, w).float()
        y = (y - y.mean(dim=1, keepdim=True)).square().mean(dim=1)
    else:
        y = x.reshape(g, -1, f, c // f, h, w).float()
        y = (y - y.mean(dim=0, keepdim=True)).square().mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(2, 3, 4), keepdim=True).mean(dim=2).to(x.dtype)  # [M, f, 1, 1]
    if contiguous:
        y = y.repeat_interleave(g, dim=0).repeat(1, 1, h, w)
    else:
        y = y.repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


class GMapping(nn.Module):
    """Mapping network: normalize z, ``mapping_layers`` dense layers,
    broadcast to ``dlatent_broadcast`` layers. Labels are ignored, as in the
    JAX package."""

    def __init__(self, latent_size=512, label_size=0, dlatent_size=512,
                 dlatent_broadcast=None, mapping_layers=8, mapping_fmaps=512,
                 mapping_lrmul=0.01, mapping_nonlinearity="lrelu",
                 normalize_latents=True, init_mul=1.0):
        super().__init__()
        self.latent_size = latent_size
        self.label_size = label_size
        self.dlatent_size = dlatent_size
        self.dlatent_broadcast = dlatent_broadcast
        self.mapping_layers = mapping_layers
        self.mapping_lrmul = mapping_lrmul
        self.mapping_nonlinearity = mapping_nonlinearity
        self.normalize_latents = normalize_latents
        in_dim = latent_size
        for i in range(mapping_layers):
            out_dim = dlatent_size if i == mapping_layers - 1 else mapping_fmaps
            self.add_module(f"Dense{i}", _params(weight=(in_dim, out_dim),
                                                 bias=(out_dim,)))
            in_dim = out_dim

    def forward(self, latents, labels=None, impl="cuda"):
        x = latents.float()
        if self.normalize_latents:
            x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
        for i in range(self.mapping_layers):
            p = getattr(self, f"Dense{i}")
            x = _dense(x, p.weight, lrmul=self.mapping_lrmul)
            x = _bias_act(x, p.bias, act=self.mapping_nonlinearity,
                          lrmul=self.mapping_lrmul, impl=impl)
        if self.dlatent_broadcast is not None:
            x = x[:, None].repeat(1, self.dlatent_broadcast, 1)
        return x


class GSynthesis(nn.Module):
    """Synthesis network: const 4x4 input, modulated convs with per-layer
    noise, ``skip``, ``resnet`` or ``orig`` architecture."""

    def __init__(self, dlatent_size=512, num_channels=3, resolution=1024,
                 fmap_base=16 << 10, fmap_decay=1.0, fmap_min=1, fmap_max=512,
                 architecture="skip", nonlinearity="lrelu",
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), init_mul=1.0):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        rlog2 = int(np.log2(resolution))
        if resolution != 2 ** rlog2 or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 >= 4, got {resolution}")
        self.resolution_log2 = rlog2
        self.resolution = resolution
        self.num_channels = num_channels
        self.num_layers = rlog2 * 2 - 2
        self.architecture = architecture
        self.nonlinearity = nonlinearity
        self.resample_kernel = list(resample_kernel)

        def n(stage):
            return nf(stage, fmap_base, fmap_decay, fmap_min, fmap_max)

        def modconv(k, cin, cout, noise=True):
            shapes = dict(weight=(cout, cin, k, k), mod_weight=(dlatent_size, cin),
                          mod_bias=(cin,), bias=(cout,))
            if noise:
                shapes["noise_strength"] = ()
            return _params(**shapes)

        b4 = nn.Module()
        b4.add_module("Const", _params(const=(1, n(1), 4, 4)))
        b4.add_module("Conv", modconv(3, n(1), n(1)))
        if architecture == "skip" or rlog2 == 2:
            b4.add_module("ToRGB", modconv(1, n(1), num_channels, noise=False))
        self.add_module("4x4", b4)
        for res in range(3, rlog2 + 1):
            blk = nn.Module()
            blk.add_module("Conv0_up", modconv(3, n(res - 2), n(res - 1)))
            blk.add_module("Conv1", modconv(3, n(res - 1), n(res - 1)))
            if architecture == "resnet":
                blk.add_module("Skip", _params(weight=(n(res - 1), n(res - 2), 1, 1)))
            if architecture == "skip" or res == rlog2:
                blk.add_module("ToRGB", modconv(1, n(res - 1), num_channels,
                                                noise=False))
            self.add_module(f"{2 ** res}x{2 ** res}", blk)

    def noise_shapes(self) -> Dict[str, tuple]:
        """Shapes of the per-layer noise images used with
        ``randomize_noise=False``."""
        return {f"noise{i}": (1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))
                for i in range(self.num_layers - 1)}

    def draw_noise(self, batch: int, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
        """One [batch, 1, h, w] standard-normal image per layer, on the
        generator's device: the training-mode noise, to pass as ``noise``
        with ``randomize_noise=False``."""
        return {k: torch.randn((batch,) + s[1:], generator=generator,
                               device=generator.device)
                for k, s in self.noise_shapes().items()}

    def forward(self, dlatents, *, noise: Optional[Dict[str, torch.Tensor]] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None, impl="cuda"):
        """dlatents: [B, num_layers, dlatent_size] -> images [B, C, R, R]."""
        if randomize_noise and generator is None:
            raise ValueError("randomize_noise=True needs a torch.Generator")
        if not randomize_noise and noise is None:
            raise ValueError("randomize_noise=False needs the noise images")
        rk = self.resample_kernel
        batch = dlatents.shape[0]
        dlatents = dlatents.float()

        def layer(x, p, layer_idx, up=False):
            x = _modulated_conv2d(x, dlatents[:, layer_idx], p, up=up,
                                  resample_kernel=rk, impl=impl)
            if randomize_noise:
                nz = torch.randn((batch, 1, x.shape[2], x.shape[3]),
                                 generator=generator, dtype=x.dtype,
                                 device=generator.device).to(x.device)
            else:
                nz = noise[f"noise{layer_idx}"].to(x.dtype)
            x = x + nz * p.noise_strength.to(x.dtype)
            return _bias_act(x, p.bias, act=self.nonlinearity, impl=impl)

        def torgb(x, y, res, p):
            t = _modulated_conv2d(x, dlatents[:, res * 2 - 3], p,
                                  demodulate=False, impl=impl)
            t = _bias_act(t, p.bias, impl=impl)
            return t if y is None else y + t

        b4 = getattr(self, "4x4")
        x = b4.Const.const.float().repeat(batch, 1, 1, 1)
        x = layer(x, b4.Conv, 0)
        y = None
        if self.architecture == "skip":
            y = torgb(x, y, 2, b4.ToRGB)
        for res in range(3, self.resolution_log2 + 1):
            blk = getattr(self, f"{2 ** res}x{2 ** res}")
            t = x
            x = layer(x, blk.Conv0_up, res * 2 - 5, up=True)
            x = layer(x, blk.Conv1, res * 2 - 4)
            if self.architecture == "resnet":
                t = _conv2d(t, blk.Skip.weight, up=True, resample_kernel=rk,
                            impl=impl)
                x = _scale(x + t, 1 / np.sqrt(2))
            if self.architecture == "skip":
                y = upsample2d(y, rk, impl=impl)
            if self.architecture == "skip" or res == self.resolution_log2:
                y = torgb(x, y, res, blk.ToRGB)
        return y


class GMain(nn.Module):
    """Full generator in eval mode: mapping, truncation towards
    ``dlatent_avg``, synthesis."""

    def __init__(self, mapping: GMapping, synthesis: GSynthesis,
                 truncation_psi: Optional[float] = 0.6,
                 truncation_cutoff: Optional[int] = None,
                 dlatent_avg_beta: float = 0.995, style_mixing_prob: float = 0.9):
        super().__init__()
        self.mapping = mapping
        self.synthesis = synthesis
        self.truncation_psi = truncation_psi
        self.truncation_cutoff = truncation_cutoff
        self.dlatent_avg_beta = dlatent_avg_beta
        self.style_mixing_prob = style_mixing_prob
        noise = nn.Module()
        for name, shape in synthesis.noise_shapes().items():
            noise.register_buffer(name, torch.zeros(shape))
        self.noise = noise
        self.register_buffer("dlatent_avg", torch.zeros(mapping.dlatent_size))

    def draw_mixing(self, batch: int, generator: torch.Generator,
                    style_mixing_prob="default"):
        """Style-mixing draws of one training-mode mapping, as the JAX
        package draws them: second latents [batch, latent_size] and a
        cutoff layer, ``randint(1, num_layers)`` with probability
        ``style_mixing_prob``, else ``num_layers`` (no mixing). A 0-d tensor
        on the generator's device, so that nothing waits for the card.
        None when ``style_mixing_prob`` is None."""
        if style_mixing_prob == "default":
            style_mixing_prob = self.style_mixing_prob
        if style_mixing_prob is None:
            return None
        dev = generator.device
        num_layers = self.synthesis.num_layers
        latents2 = torch.randn((batch, self.mapping.latent_size),
                               generator=generator, device=dev)
        mix = torch.rand((), generator=generator, device=dev) < style_mixing_prob
        layer = torch.randint(1, num_layers, (), generator=generator, device=dev)
        return latents2, torch.where(mix, layer, torch.full_like(layer, num_layers))

    def map_latents(self, latents, labels=None, *, mixing=None,
                    impl: str = "cuda"):
        """Training-mode mapping and style mixing: latents [B, Z] ->
        dlatents [B, L, D] (float32) and the batch average of the first
        layer's dlatents, which the caller folds into ``dlatent_avg``
        (``training.loss.fold_dlatent_avg``). ``mixing``: (latents2,
        cutoff) from ``draw_mixing``; layers at and past the cutoff take
        the dlatents of latents2. None mixes nothing."""
        dlatents = self.mapping(latents, labels, impl=impl).float()
        batch_avg = dlatents[:, 0].mean(dim=0)
        if mixing is not None:
            latents2, cutoff = mixing
            dlatents2 = self.mapping(latents2.to(latents.device), labels,
                                     impl=impl).float()
            layer_idx = torch.arange(self.synthesis.num_layers,
                                     device=dlatents.device)[None, :, None]
            dlatents = torch.where(layer_idx < torch.as_tensor(
                cutoff, device=dlatents.device), dlatents, dlatents2)
        return dlatents, batch_avg

    def forward(self, latents, labels=None, *, truncation_psi=None,
                truncation_cutoff="default", noise=None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None,
                return_dlatents: bool = False, is_training: bool = False,
                mixing=None, impl: str = "cuda"):
        """latents [B, latent_size] -> images [B, C, R, R], then the
        dlatents when asked, then, in training mode, the batch average for
        the ``dlatent_avg`` EMA. Eval mode truncates (``truncation_psi=None``
        takes the model's, 1 turns it off); training mode mixes styles with
        ``mixing`` (see ``map_latents``) and never truncates. ``noise``
        defaults to the ``noise`` buffers."""
        if truncation_psi is None:
            truncation_psi = self.truncation_psi
        if truncation_cutoff == "default":
            truncation_cutoff = self.truncation_cutoff
        if is_training:
            truncation_psi = None
        if truncation_psi is not None and truncation_psi == 1:
            truncation_psi = None
        num_layers = self.synthesis.num_layers
        dlatents, batch_avg = self.map_latents(
            latents, labels, mixing=mixing if is_training else None, impl=impl)
        if truncation_psi is not None:
            layer_idx = np.arange(num_layers)[None, :, None]
            layer_psi = np.ones(layer_idx.shape, np.float32)
            if truncation_cutoff is None:
                layer_psi = layer_psi * truncation_psi
            else:
                layer_psi = np.where(layer_idx < truncation_cutoff,
                                     layer_psi * truncation_psi, layer_psi)
            psi = torch.from_numpy(np.asarray(layer_psi, np.float32)).to(dlatents.device)
            dlatents = self.dlatent_avg + (dlatents - self.dlatent_avg) * psi
        if noise is None:
            noise = dict(self.noise.named_buffers())
        images = self.synthesis(dlatents, noise=noise,
                                randomize_noise=randomize_noise,
                                generator=generator, impl=impl)
        out = [images]
        if return_dlatents:
            out.append(dlatents)
        if is_training:
            out.append(batch_avg)
        return tuple(out) if len(out) > 1 else images


class Discriminator(nn.Module):
    """Discriminator with the features head: FromRGB, one block per
    resolution down to 8x8 (two convs, the second downsampling), minibatch
    stddev, a 4x4 conv, a dense layer and the score. ``resnet`` adds a 1x1
    downsampling skip per block, ``skip`` a FromRGB per block fed by the
    downsampled image; ``orig`` has neither. Labels are ignored, as in the
    JAX package."""

    def __init__(self, num_channels=3, resolution=1024, label_size=0,
                 fmap_base=16 << 10, fmap_decay=1.0, fmap_min=1, fmap_max=512,
                 architecture="resnet", nonlinearity="lrelu",
                 mbstd_group_size=6, mbstd_num_features=1,
                 mbstd_contiguous=False,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), init_mul=1.0):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        rlog2 = int(np.log2(resolution))
        if resolution != 2 ** rlog2 or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 >= 4, got {resolution}")
        self.resolution_log2 = rlog2
        self.label_size = label_size
        self.architecture = architecture
        self.nonlinearity = nonlinearity
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_features = mbstd_num_features
        self.mbstd_contiguous = mbstd_contiguous
        self.resample_kernel = list(resample_kernel)

        def n(stage):
            return nf(stage, fmap_base, fmap_decay, fmap_min, fmap_max)

        def conv(k, cin, cout, bias=True):
            return _params(weight=(cout, cin, k, k), **({"bias": (cout,)} if bias else {}))

        for res in range(rlog2, 2, -1):
            blk = nn.Module()
            if architecture == "skip" or res == rlog2:
                blk.add_module("FromRGB", conv(1, num_channels, n(res - 1)))
            blk.add_module("Conv0", conv(3, n(res - 1), n(res - 1)))
            blk.add_module("Conv1_down", conv(3, n(res - 1), n(res - 2)))
            if architecture == "resnet":
                blk.add_module("Skip", conv(1, n(res - 1), n(res - 2), bias=False))
            self.add_module(f"{2 ** res}x{2 ** res}", blk)
        b4 = nn.Module()
        if architecture == "skip":
            b4.add_module("FromRGB", conv(1, num_channels, n(1)))
        mbstd_ch = mbstd_num_features if mbstd_group_size > 1 else 0
        b4.add_module("Conv", conv(3, n(1) + mbstd_ch, n(1)))
        b4.add_module("Dense0", _params(weight=(n(1) * 16, n(0)), bias=(n(0),)))
        self.add_module("4x4", b4)
        self.add_module("Output", _params(weight=(n(0), 1), bias=(1,)))

    def forward(self, images, labels=None, impl: str = "cuda"):
        """images [B, C, R, R] -> (scores [B], features [B, F]); features
        concatenate every intermediate activation, each flattened and
        divided by the square root of its length, in float32."""
        rk = self.resample_kernel
        act = self.nonlinearity
        feats = []

        def feat(x):
            length = int(np.prod(x.shape[1:]))
            feats.append((x.float() / float(np.sqrt(np.float32(length))))
                         .reshape(x.shape[0], -1))

        def fromrgb(x, y, p):
            t = _bias_act(_conv2d(y, p.weight, impl=impl), p.bias, act=act,
                          impl=impl)
            return t if x is None else x + t

        y = images.float()
        feat(y)
        x = None
        for res in range(self.resolution_log2, 2, -1):
            blk = getattr(self, f"{2 ** res}x{2 ** res}")
            if self.architecture == "skip" or res == self.resolution_log2:
                x = fromrgb(x, y, blk.FromRGB)
                feat(x)
            t = x
            x = _bias_act(_conv2d(x, blk.Conv0.weight, impl=impl),
                          blk.Conv0.bias, act=act, impl=impl)
            x = _bias_act(_conv2d(x, blk.Conv1_down.weight, down=True,
                                  resample_kernel=rk, impl=impl),
                          blk.Conv1_down.bias, act=act, impl=impl)
            if self.architecture == "resnet":
                t = _conv2d(t, blk.Skip.weight, down=True, resample_kernel=rk,
                            impl=impl)
                x = _scale(x + t, 1 / np.sqrt(2))
            feat(x)
            if self.architecture == "skip":
                y = downsample2d(y, rk, impl=impl)

        b4 = getattr(self, "4x4")
        if self.architecture == "skip":
            x = fromrgb(x, y, b4.FromRGB)
        if self.mbstd_group_size > 1:
            x = minibatch_stddev(x, self.mbstd_group_size,
                                 self.mbstd_num_features,
                                 contiguous=self.mbstd_contiguous)
        x = _bias_act(_conv2d(x, b4.Conv.weight, impl=impl), b4.Conv.bias,
                      act=act, impl=impl)
        feat(x)
        x = _bias_act(_dense(x, b4.Dense0.weight), b4.Dense0.bias, act=act,
                      impl=impl)
        feat(x)
        x = _bias_act(_dense(x, self.Output.weight), self.Output.bias, impl=impl)
        feat(x)
        return x[:, 0], torch.cat(feats, dim=1)
