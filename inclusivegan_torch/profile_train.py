"""Where the time of one training iteration goes on the card.

Resumes a ``network_snapshot.v1`` pickle as a training state (weights cast
to float32; ``--dtype bfloat16`` computes G, D and the LPIPS trunk in bf16,
as a fresh ``run_training.py --dtype bfloat16`` run does), then runs iterations of ``train_step`` on synthetic uint8 reals
under ``torch.profiler`` after a warm-up, and prints the wall time, the
device's busy share and the kernels' device time by group (the port's
kernels, convolutions, matrix products, the rest), as
``profile_generate`` does. Needs one CUDA card.

    python -m inclusivegan_torch.profile_train \
        [--network artifacts/celeba_best_weights_fp16.pkl] \
        [--lpips artifacts/celeba_perceptual_vgg.npz] [--minibatch 6] \
        [--iterations 2] [--no-reg] [--impl cuda|plain] \
        [--dtype float32|bfloat16] [--trace FILE]
"""

import argparse
import time

import numpy as np
import torch

from .models.lpips import load_lpips_params
from .models.stylegan2 import set_compute_dtype
from .profile_generate import report
from .snapshot import load_networks
from .training.train_state import create_train_state
from .training.train_step import TrainConfig, make_train_step


def synthetic_batch(mb, res, z, label_size, seed=0):
    """Uniform uint8 reals, standard-normal rec latents, zero labels."""
    rnd = np.random.RandomState(seed)
    batch = {}
    for s in ("_1", "_2"):
        batch["reals_rec" + s] = rnd.randint(0, 256, (mb, 3, res, res)).astype(np.uint8)
        batch["latents_rec" + s] = rnd.randn(mb, z).astype(np.float32)
        batch["labels_rec" + s] = np.zeros((mb, label_size), np.float32)
    batch["reals"] = rnd.randint(0, 256, (2 * mb, 3, res, res)).astype(np.uint8)
    batch["labels"] = np.zeros((2 * mb, label_size), np.float32)
    return batch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="artifacts/celeba_best_weights_fp16.pkl")
    parser.add_argument("--lpips", default="artifacts/celeba_perceptual_vgg.npz")
    parser.add_argument("--minibatch", type=int, default=6)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--no-reg", action="store_true",
                        help="run the iterations without the lazy regularizers")
    parser.add_argument("--impl", default="cuda", choices=("cuda", "plain"))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype of G, D and the LPIPS trunk")
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of the window here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    G, D, Gs = load_networks(args.network, device="cuda")
    for net in (G, D, Gs):
        net.float()
        set_compute_dtype(net, args.dtype)
    state = create_train_state(G, D, Gs)
    cfg = TrainConfig(gamma=100.0, mirror_augment=True, lpips_dtype=args.dtype)
    step = make_train_step(G, D, load_lpips_params(args.lpips, device="cuda"), cfg,
                           device="cuda", impl=args.impl)
    batch = synthetic_batch(args.minibatch, G.synthesis.resolution,
                            G.mapping.latent_size, G.mapping.label_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    reg = not args.no_reg
    state, _ = step(state, batch, gen, 0.002, 0.002, 0.999, do_g_reg=reg,
                    do_d_reg=reg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            state, _ = step(state, batch, gen, 0.002, 0.002, 0.999, do_g_reg=reg,
                            do_d_reg=reg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print(f"{torch.cuda.get_device_name(0)}: train_step impl={args.impl} {args.dtype}, "
          f"minibatch {args.minibatch}, {args.iterations} iterations "
          f"{'with' if reg else 'without'} the lazy regularizers")
    print(f"wall {wall_ms:.3f} ms ({wall_ms / args.iterations:.3f} ms per iteration)")
    report(prof, wall_ms, args.trace)


if __name__ == "__main__":
    main()
