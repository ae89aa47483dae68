"""StyleGAN1 networks, ported from ``inclusivegan_tpu/models/stylegan.py``.

``GStyle`` (mapping, truncation with a layer cutoff, style mixing) over
``GSynthesisStyleGAN1``, and ``DBasic`` with its label switch, in the
'linear' progressive structure: every resolution branch is computed and
``lerp_clip`` blends the RGB heads by ``lod``. The synthesis epilogue is
noise, bias and lrelu, instance norm, then the style modulation; every
resampling is blurred by [1, 2, 1].

Both kernels of the port run here: ``blur2d`` is ``ops.upfirdn2d`` with
3x3 taps, up = down = 1 and pad 1 (its gradient the same kernel at the
transposed configuration), and every lrelu epilogue, every D layer and the
mapping go through ``stylegan2._bias_act``, the bias+lrelu kernel on a CUDA
tensor. ``upscale2d``, ``downscale2d`` and the convolutions are tensor code,
as the JAX package leaves them to XLA.

Parameters and buffers carry the JAX package's names
(``synthesis.4x4.Const.StyleMod.weight``); conv weights are OIHW, dense
weights [in, out], as in ``stylegan2.py``; ``snapshot.gstyle_from_params``
and ``snapshot.dbasic_from_params`` carry a JAX parameter tree across.
Every random draw is an argument: the per-layer noise (``noise``, or
``generator`` with ``randomize_noise=True``) and the style-mixing latents
and cutoff (``mixing``, from ``draw_mixing``). The compute dtype is float32
unless ``create(dtype=...)`` or ``stylegan2.set_compute_dtype`` asks for
another, with float32 islands where the JAX package has them: the
dlatents, the style dense layer and the instance-norm statistics.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import setup_filter, upfirdn2d
from .stylegan2 import (GMain, GMapping, _bias_act, _dense, _normal_, _params,
                        _scale, _wcoef, _zeros_, compute_dtype, dtype_name,
                        minibatch_stddev)

BLUR_FILTER = (1, 2, 1)


def blur2d(x, f=BLUR_FILTER, impl: str = "cuda"):
    """Depthwise normalized blur: the upfirdn2d kernel with the outer
    product of ``f`` over its sum, padded by 1 on each side."""
    return upfirdn2d(x, setup_filter(f), up=1, down=1, pad=(1, 1, 1, 1), impl=impl)


def upscale2d(x, factor: int = 2):
    """Nearest-neighbour upsampling by ``factor``."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h, 1, w, 1).expand(n, c, h, factor, w, factor)
    return x.reshape(n, c, h * factor, w * factor)


def downscale2d(x, factor: int = 2):
    """Box downsampling: the mean of each ``factor`` x ``factor`` block."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // factor, factor, w // factor, factor).mean(dim=(3, 5))


def _conv2d_sg1(x, w, gain: float = math.sqrt(2)):
    """SAME convolution with the equalized-learning-rate coefficient; ``w``
    is OIHW."""
    coef = _wcoef(w[0].numel(), gain=gain)
    return F.conv2d(x, _scale(w, coef).to(x.dtype), padding=w.shape[2] // 2)


def instance_norm(x, eps: float = 1e-8):
    """Per-example, per-channel normalization over H, W, in float32."""
    x32 = x.float()
    x32 = x32 - x32.mean(dim=(2, 3), keepdim=True)
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=(2, 3), keepdim=True) + eps)
    return x32.to(x.dtype)


def pixel_norm(x, eps: float = 1e-8):
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


def lerp_clip(a, b, t):
    """``a + (b - a) * clip(t, 0, 1)``; a Python ``t`` is rounded to the
    operands' dtype first, as JAX does."""
    if isinstance(t, torch.Tensor):
        return a + (b - a) * t.clamp(0.0, 1.0).to(a.dtype)
    return a + _scale(b - a, min(max(float(t), 0.0), 1.0))


def _sg1_nf(stage, fmap_base, fmap_decay, fmap_max) -> int:
    return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)


class GSynthesisStyleGAN1(nn.Module):
    """Synthesis: a learned 4x4 const, two 3x3 convs per resolution (the
    first after a nearest upscale, then blurred), an epilogue after each,
    and one ToRGB head per resolution blended by ``lod``."""

    def __init__(self, dlatent_size=512, num_channels=3, resolution=1024,
                 fmap_base=8192, fmap_decay=1.0, fmap_max=512,
                 use_pixel_norm=False, use_instance_norm=True, dtype="float32"):
        super().__init__()
        rlog2 = int(np.log2(resolution))
        if resolution != 2 ** rlog2 or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 >= 4, got {resolution}")
        self.resolution_log2 = rlog2
        self.resolution = resolution
        self.num_channels = num_channels
        self.num_layers = rlog2 * 2 - 2
        self.use_pixel_norm = use_pixel_norm
        self.use_instance_norm = use_instance_norm
        self.dtype = compute_dtype(dtype)
        self.config = dict(
            dlatent_size=dlatent_size, num_channels=num_channels, resolution=resolution,
            fmap_base=fmap_base, fmap_decay=fmap_decay, fmap_max=fmap_max,
            use_pixel_norm=use_pixel_norm, use_instance_norm=use_instance_norm,
            dtype=dtype_name(dtype))

        def n(stage):
            return _sg1_nf(stage, fmap_base, fmap_decay, fmap_max)

        def layer(fmaps, **shapes):
            m = _params(noise_weight=(fmaps,), bias=(fmaps,), **shapes)
            m.add_module("StyleMod", _params(weight=(dlatent_size, 2 * fmaps),
                                             bias=(2 * fmaps,)))
            return m

        b4 = nn.Module()
        b4.add_module("Const", layer(n(1), const=(1, n(1), 4, 4)))
        b4.add_module("Conv", layer(n(1), weight=(n(1), n(1), 3, 3)))
        self.add_module("4x4", b4)
        for res in range(3, rlog2 + 1):
            blk = nn.Module()
            blk.add_module("Conv0_up", layer(n(res - 1), weight=(n(res - 1), n(res - 2), 3, 3)))
            blk.add_module("Conv1", layer(n(res - 1), weight=(n(res - 1), n(res - 1), 3, 3)))
            self.add_module(f"{2 ** res}x{2 ** res}", blk)
        for res in range(2, rlog2 + 1):
            self.add_module(f"ToRGB_lod{rlog2 - res}",
                            _params(weight=(num_channels, n(res - 1), 1, 1),
                                    bias=(num_channels,)))

    def init(self, generator: torch.Generator) -> "GSynthesisStyleGAN1":
        """Fresh parameters, as the JAX package's ``init``: the const input
        ones, conv, ToRGB and style weights N(0, 1), the rest zeros."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[1]
            if leaf == "const":
                p.data = torch.ones(tuple(p.shape), device=p.device)
            elif leaf == "weight":
                _normal_(p, generator)
            else:  # bias, noise_weight
                _zeros_(p)
        return self

    def noise_shapes(self) -> Dict[str, tuple]:
        """Shapes of the per-layer noise images of ``randomize_noise=False``."""
        return {f"noise{i}": (1, 1, 2 ** (i // 2 + 2), 2 ** (i // 2 + 2))
                for i in range(self.num_layers)}

    def init_noise(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return {k: torch.randn(s, generator=generator, device=generator.device)
                for k, s in self.noise_shapes().items()}

    def draw_noise(self, batch: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One [batch, 1, h, w] standard-normal image per layer."""
        return {k: torch.randn((batch,) + s[1:], generator=generator,
                               device=generator.device)
                for k, s in self.noise_shapes().items()}

    def forward(self, dlatents, *, lod: float = 0.0,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None, impl: str = "cuda"):
        """dlatents [B, num_layers, dlatent_size] -> images [B, C, R, R]."""
        if randomize_noise and generator is None:
            raise ValueError("randomize_noise=True needs a torch.Generator")
        if not randomize_noise and noise is None:
            raise ValueError("randomize_noise=False needs the noise images")
        dlatents = dlatents.float()
        batch = dlatents.shape[0]

        def epilogue(x, p, layer_idx):
            if randomize_noise:
                nz = torch.randn((batch, 1, x.shape[2], x.shape[3]), generator=generator,
                                 device=generator.device).to(x.device, x.dtype)
            else:
                nz = noise[f"noise{layer_idx}"].to(x.dtype)
            x = x + nz * p.noise_weight[None, :, None, None].to(x.dtype)
            x = _bias_act(x, p.bias, act="lrelu", impl=impl)
            if self.use_pixel_norm:
                x = pixel_norm(x)
            if self.use_instance_norm:
                x = instance_norm(x)
            style = _dense(dlatents[:, layer_idx], p.StyleMod.weight) + p.StyleMod.bias
            style = style.reshape(-1, 2, x.shape[1], 1, 1)
            return x * (style[:, 0] + 1).to(x.dtype) + style[:, 1].to(x.dtype)

        def torgb(x, res):
            p = getattr(self, f"ToRGB_lod{self.resolution_log2 - res}")
            y = _conv2d_sg1(x, p.weight, gain=1.0)
            return y + p.bias[None, :, None, None].to(y.dtype)

        b4 = getattr(self, "4x4")
        x = b4.Const.const.to(self.dtype).repeat(batch, 1, 1, 1)
        x = epilogue(x, b4.Const, 0)
        x = _conv2d_sg1(x, b4.Conv.weight)
        x = epilogue(x, b4.Conv, 1)
        images_out = torgb(x, 2)
        for res in range(3, self.resolution_log2 + 1):
            cur_lod = self.resolution_log2 - res
            blk = getattr(self, f"{2 ** res}x{2 ** res}")
            x = upscale2d(x)
            x = _conv2d_sg1(x, blk.Conv0_up.weight)
            x = blur2d(x, impl=impl)
            x = epilogue(x, blk.Conv0_up, res * 2 - 4)
            x = _conv2d_sg1(x, blk.Conv1.weight)
            x = epilogue(x, blk.Conv1, res * 2 - 3)
            img = torgb(x, res)
            images_out = lerp_clip(img, upscale2d(images_out), lod - cur_lod)
        return images_out


class GStyle(nn.Module):
    """The StyleGAN1 generator: mapping, truncation towards ``dlatent_avg``
    for the layers under ``truncation_cutoff`` (eval mode), style mixing
    (training mode), synthesis."""

    draw_mixing = GMain.draw_mixing

    def __init__(self, mapping: GMapping, synthesis: GSynthesisStyleGAN1,
                 truncation_psi: Optional[float] = 0.7,
                 truncation_cutoff: Optional[int] = 8,
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

    @property
    def config(self) -> dict:
        return dict(mapping=dict(self.mapping.config),
                    synthesis=dict(self.synthesis.config),
                    truncation_psi=self.truncation_psi,
                    truncation_cutoff=self.truncation_cutoff,
                    dlatent_avg_beta=self.dlatent_avg_beta,
                    style_mixing_prob=self.style_mixing_prob)

    @staticmethod
    def create(resolution=1024, num_channels=3, latent_size=512, dlatent_size=512,
               fmap_base=8192, fmap_max=512, mapping_layers=8, mapping_fmaps=512,
               dtype="float32", **_kwargs) -> "GStyle":
        """The generator of the JAX package's ``GStyle.create``, with zero
        placeholder parameters until ``init`` or a snapshot fills them."""
        synthesis = GSynthesisStyleGAN1(
            dlatent_size=dlatent_size, num_channels=num_channels, resolution=resolution,
            fmap_base=fmap_base, fmap_max=fmap_max, dtype=dtype)
        mapping = GMapping(latent_size=latent_size, dlatent_size=dlatent_size,
                           dlatent_broadcast=synthesis.num_layers,
                           mapping_layers=mapping_layers, mapping_fmaps=mapping_fmaps,
                           dtype=dtype)
        return GStyle(mapping, synthesis)

    def init(self, generator: torch.Generator) -> "GStyle":
        """Fresh mapping and synthesis parameters, noise images and a zero
        ``dlatent_avg``."""
        self.mapping.init(generator)
        self.synthesis.init(generator)
        for name, v in self.synthesis.init_noise(generator).items():
            setattr(self.noise, name, v.to(self.dlatent_avg.device))
        self.dlatent_avg = torch.zeros(self.mapping.dlatent_size,
                                       device=self.dlatent_avg.device)
        return self

    def forward(self, latents, labels=None, *, lod: float = 0.0, is_training=False,
                truncation_psi=None, truncation_cutoff="default", noise=None,
                randomize_noise: bool = True, generator: Optional[torch.Generator] = None,
                mixing=None, impl: str = "cuda"):
        """latents [B, latent_size] -> images [B, C, R, R]. Eval mode
        truncates (``truncation_psi=None`` takes the model's); training mode
        mixes styles with ``mixing`` = (latents2, cutoff): layers at and past
        the cutoff take latents2's dlatents. ``noise`` defaults to the
        ``noise`` buffers when ``randomize_noise`` is False."""
        if truncation_psi is None:
            truncation_psi = self.truncation_psi
        if truncation_cutoff == "default":
            truncation_cutoff = self.truncation_cutoff
        if is_training:
            truncation_psi = None
        num_layers = self.synthesis.num_layers
        dlatents = self.mapping(latents, labels, impl=impl).float()
        if is_training and mixing is not None:
            latents2, cutoff = mixing
            dlatents2 = self.mapping(latents2.to(latents.device), labels, impl=impl).float()
            layer_idx = torch.arange(num_layers, device=dlatents.device)[None, :, None]
            dlatents = torch.where(layer_idx < torch.as_tensor(cutoff, device=dlatents.device),
                                   dlatents, dlatents2)
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
        if noise is None and not randomize_noise:
            noise = dict(self.noise.named_buffers())
        return self.synthesis(dlatents, lod=lod, noise=noise,
                              randomize_noise=randomize_noise, generator=generator,
                              impl=impl)


class DBasic(nn.Module):
    """The StyleGAN1 discriminator: one FromRGB head per resolution blended
    by ``lod``, two 3x3 convs per block (the second blurred, then box
    downscaled), minibatch stddev, a 4x4 conv and two dense layers; with
    labels, the score is the output picked by the one-hot label."""

    def __init__(self, num_channels=1, resolution=32, label_size=0, fmap_base=8192,
                 fmap_decay=1.0, fmap_max=512, mbstd_group_size=4,
                 mbstd_num_features=1, dtype="float32"):
        super().__init__()
        rlog2 = int(np.log2(resolution))
        if resolution != 2 ** rlog2 or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 >= 4, got {resolution}")
        self.resolution_log2 = rlog2
        self.label_size = label_size
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_features = mbstd_num_features
        self.dtype = compute_dtype(dtype)
        self.config = dict(
            num_channels=num_channels, resolution=resolution, label_size=label_size,
            fmap_base=fmap_base, fmap_decay=fmap_decay, fmap_max=fmap_max,
            mbstd_group_size=mbstd_group_size, mbstd_num_features=mbstd_num_features,
            dtype=dtype_name(dtype))

        def n(stage):
            return _sg1_nf(stage, fmap_base, fmap_decay, fmap_max)

        def conv(cin, cout, k=3):
            return _params(weight=(cout, cin, k, k), bias=(cout,))

        for res in range(rlog2, 2, -1):
            blk = nn.Module()
            blk.add_module("Conv0", conv(n(res - 1), n(res - 1)))
            blk.add_module("Conv1_down", conv(n(res - 1), n(res - 2)))
            self.add_module(f"{2 ** res}x{2 ** res}", blk)
        for res in range(2, rlog2 + 1):
            self.add_module(f"FromRGB_lod{rlog2 - res}", conv(num_channels, n(res - 1), k=1))
        mbstd_ch = mbstd_num_features if mbstd_group_size > 1 else 0
        b4 = nn.Module()
        b4.add_module("Conv", conv(n(1) + mbstd_ch, n(1)))
        b4.add_module("Dense0", _params(weight=(n(1) * 16, n(0)), bias=(n(0),)))
        b4.add_module("Dense1", _params(weight=(n(0), max(label_size, 1)),
                                        bias=(max(label_size, 1),)))
        self.add_module("4x4", b4)

    def init(self, generator: torch.Generator) -> "DBasic":
        """Fresh parameters: weights N(0, 1), biases 0."""
        for name, p in self.named_parameters():
            if name.endswith("weight"):
                _normal_(p, generator)
            else:
                _zeros_(p)
        return self

    def forward(self, images, labels=None, *, lod: float = 0.0, impl: str = "cuda"):
        """images [B, C, R, R] -> scores [B]."""
        rlog2 = self.resolution_log2

        def fromrgb(img, res):
            p = getattr(self, f"FromRGB_lod{rlog2 - res}")
            return _bias_act(_conv2d_sg1(img, p.weight), p.bias, act="lrelu", impl=impl)

        img = images.to(self.dtype)
        x = fromrgb(img, rlog2)
        for res in range(rlog2, 2, -1):
            cur_lod = rlog2 - res
            blk = getattr(self, f"{2 ** res}x{2 ** res}")
            x = _bias_act(_conv2d_sg1(x, blk.Conv0.weight), blk.Conv0.bias, act="lrelu",
                          impl=impl)
            x = blur2d(x, impl=impl)
            x = downscale2d(_conv2d_sg1(x, blk.Conv1_down.weight))
            x = _bias_act(x, blk.Conv1_down.bias, act="lrelu", impl=impl)
            img = downscale2d(img)
            x = lerp_clip(x, fromrgb(img, res - 1), lod - cur_lod)

        b4 = getattr(self, "4x4")
        if self.mbstd_group_size > 1:
            x = minibatch_stddev(x, self.mbstd_group_size, self.mbstd_num_features)
        x = _bias_act(_conv2d_sg1(x, b4.Conv.weight), b4.Conv.bias, act="lrelu", impl=impl)
        x = _bias_act(_dense(x, b4.Dense0.weight), b4.Dense0.bias, act="lrelu", impl=impl)
        x = _bias_act(_dense(x, b4.Dense1.weight), b4.Dense1.bias, impl=impl)
        if self.label_size:
            x = (x * labels.to(x.dtype)).sum(dim=1, keepdim=True)
        return x[:, 0]
