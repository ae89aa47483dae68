"""generate-images for the port, after the JAX package's ``run_generator.py``.

Latents and noise come from ``numpy.random.RandomState(0)`` exactly as there:
per minibatch, the latents first, then every noise image re-drawn in sorted
name order. The images are converted to uint8 the same way and returned as
NHWC; PNGs are written (without Pillow, ``utils.misc.write_png``) only when
an output directory is given.

The command line switches TF32 off for cuDNN's convolutions and for matrix
products before it loads the network, so that the card computes in float32
as the JAX package does; ``generate_images`` itself leaves the global flags
as the caller set them.

    python -m inclusivegan_torch.run_generator generate-images \
        --network artifacts/celeba_best_weights_fp16.pkl --num-images 8 \
        [--result-dir DIR] [--minibatch-size 4] [--truncation-psi 0.6] \
        [--device cpu]
"""

import argparse
import os
from typing import Optional, Union

import numpy as np
import torch

from .models.stylegan2 import GMain
from .snapshot import load_snapshot
from .utils import generator_output_to_uint8
from .utils.misc import write_png


def generate_images(network: Union[str, GMain], num_images: int,
                    minibatch_size: int = 50,
                    truncation_psi: Optional[float] = None,
                    device="cuda", out_dir: Optional[str] = None,
                    impl: str = "cuda") -> np.ndarray:
    """Generate ``num_images`` images from a snapshot path or a built
    ``GMain`` (already on ``device``); return them as uint8 [N, H, W, C].

    ``impl="plain"`` runs the plain PyTorch version of every kernel, to
    compare with the kernels on the card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    G = load_snapshot(network, device) if isinstance(network, str) else network
    noise_shapes = {name: tuple(buf.shape) for name, buf in G.noise.named_buffers()}
    rnd = np.random.RandomState(0)
    out = []
    with torch.no_grad():
        for _ in range(0, num_images, minibatch_size):
            z = rnd.randn(minibatch_size, G.mapping.latent_size).astype(np.float32)
            noise = {name: torch.from_numpy(
                rnd.randn(*noise_shapes[name]).astype(np.float32)).to(device)
                for name in sorted(noise_shapes)}
            images = G(torch.from_numpy(z).to(device),
                       truncation_psi=truncation_psi, noise=noise,
                       randomize_noise=False, impl=impl)
            out.append(generator_output_to_uint8(images).cpu().numpy())
    images = np.concatenate(out)[:num_images]
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for i, arr in enumerate(images):
            write_png(os.path.join(out_dir, f"{i:06d}.png"), arr)
    return images


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="StyleGAN2 generator (PyTorch/CUDA port).")
    subparsers = parser.add_subparsers(help="Sub-commands", dest="command",
                                       required=True)
    p = subparsers.add_parser(
        "generate-images", help="Generate images (float32, TF32 off for "
        "convolutions and matrix products)")
    p.add_argument("--network", dest="network", required=True)
    p.add_argument("--result-dir", dest="out_dir", default="generation",
                   metavar="DIR")
    p.add_argument("--num-images", type=int, default=30000)
    p.add_argument("--minibatch-size", type=int, default=50)
    p.add_argument("--truncation-psi", type=float, default=None)
    p.add_argument("--device", default="cuda")
    args = vars(parser.parse_args(argv))
    args.pop("command")
    # float32 as in the JAX package: torch's default lets cuDNN convolve in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = generate_images(**args)
    print(f"Wrote {len(images)} images to {args['out_dir']}")


if __name__ == "__main__":
    main()
