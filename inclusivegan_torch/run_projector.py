"""Latent projection CLI of the port (IvOM), with the flags of the JAX
package's ``run_projector.py`` and ``--device``: project ``--num-images``
reals of ``--dataset`` (in order, ``shuffle=False``) in minibatches for
``--num-steps`` steps each, and write into a new run dir under
``--result-dir``: ``image####-target.png``, ``image####-step####.png`` at
``--num-snapshots`` points of each projection, ``image####-final.png``, and
``ivom.txt`` with the mean, standard deviation and count of the final
LPIPS distances, also printed as the IvOM line of the log.

``main`` switches TF32 off for cuDNN's convolutions and for matrix
products, so that the Gs computes in float32 on the card, as in the JAX
package; ``--device cpu`` projects on the CPU.

    python -m inclusivegan_torch.run_projector project-real-images \\
        --network PKL --data-dir DIR --dataset NAME --num-images 3000 \\
        --num-steps 400 --minibatch-size 50 --lpips-weights NPZ
"""

import argparse
import os
import time

import numpy as np
import torch

from .utils.run_harness import SubmitConfig, submit_run


def project_image(proj, targets, run_dir, image_idx_base, snapshot_every=100):
    from .utils.misc import save_image_grid
    proj.start(targets)
    while proj.get_cur_step() < proj.num_steps:
        step = proj.get_cur_step()
        if step % snapshot_every == 0:
            imgs = proj.get_images()
            for i in range(imgs.shape[0]):
                save_image_grid(imgs[i:i + 1], os.path.join(
                    run_dir, f"image{image_idx_base + i:04d}-step{step:04d}.png"))
        print(f"\r{step} / {proj.num_steps} ... ", end="", flush=True)
        proj.step()
    print(f"\r{proj.num_steps} / {proj.num_steps} ... done")
    return proj.get_dist()


def project_real_images(submit_config, network_pkl, dataset_name, data_dir, num_images,
                        num_steps, minibatch_size=10, num_snapshots=5, lpips_weights=None,
                        device="cuda", noise_fn=None):
    """Project the first ``num_images`` reals; returns the mean and standard
    deviation of the final distances. ``noise_fn`` is handed to the
    ``Projector``."""
    from .data.dataset import load_dataset
    from .projector import Projector
    from .snapshot import load_snapshot
    from .utils.misc import adjust_dynamic_range, save_image_grid

    run_dir = submit_config.run_dir
    print(f'Loading networks from "{network_pkl}"...')
    G = load_snapshot(network_pkl, device=device)
    proj = Projector(verbose=True, lpips_weights=lpips_weights, noise_fn=noise_fn)
    proj.set_network(G, minibatch_size=minibatch_size, num_steps=num_steps)

    dataset = load_dataset(data_dir=data_dir, shuffle=False, tfrecord_dir=dataset_name,
                           max_label_size="full")
    all_dists = []
    snapshot_every = max(num_steps // num_snapshots, 1)
    t0 = time.perf_counter()
    for idx in range(0, num_images, minibatch_size):
        print(f"Projecting images {idx}-{idx + minibatch_size}/{num_images} ...")
        images, _labels = dataset.get_minibatch_np(minibatch_size)
        images = adjust_dynamic_range(images.astype(np.float32), dataset.dynamic_range,
                                      [-1, 1])
        for i in range(minibatch_size):
            save_image_grid(images[i:i + 1],
                            os.path.join(run_dir, f"image{idx + i:04d}-target.png"))
        all_dists.append(np.asarray(project_image(proj, images, run_dir, idx,
                                                  snapshot_every)))
        imgs = proj.get_images()
        for i in range(minibatch_size):
            save_image_grid(imgs[i:i + 1],
                            os.path.join(run_dir, f"image{idx + i:04d}-final.png"))
    secs = time.perf_counter() - t0
    all_dists = np.concatenate(all_dists)
    print(f"IvOM (LPIPS after {num_steps} steps over {len(all_dists)} "
          f"images): {all_dists.mean():.4f} +- {all_dists.std():.4f}")
    print(f"projected {len(all_dists)} images in {secs:.2f} s, "
          f"{secs / len(all_dists):.4f} s per image at {num_steps} steps")
    with open(os.path.join(run_dir, "ivom.txt"), "a") as f:
        f.write(f"{all_dists.mean():.6f} {all_dists.std():.6f} {len(all_dists)}\n")
    return float(all_dists.mean()), float(all_dists.std())


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Project real images into latent space (PyTorch/CUDA port, one "
        "card). Computes in float32: TF32 is switched off for convolutions and "
        "matrix products.")
    subparsers = parser.add_subparsers(help="Sub-commands", dest="command", required=True)
    p = subparsers.add_parser("project-real-images", help="Project real images (IvOM)")
    p.add_argument("--network", dest="network_pkl", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--dataset", dest="dataset_name", required=True)
    p.add_argument("--num-images", type=int, default=3000)
    p.add_argument("--num-steps", type=int, default=400)
    p.add_argument("--minibatch-size", type=int, default=50)
    p.add_argument("--num-snapshots", type=int, default=5)
    p.add_argument("--result-dir", default="projection", metavar="DIR")
    p.add_argument("--lpips-weights", default=None, type=str,
                   help="LPIPS npz for the projection objective (default: "
                        "metrics_weights/vgg16_zhang_perceptual.npz if present, else "
                        "the pixel-pyramid fallback)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return vars(parser.parse_args(argv))


def main(argv=None):
    kwargs = parse_args(argv)
    subcmd = kwargs.pop("command")
    # float32 as in the JAX package: torch's default lets cuDNN convolve in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = SubmitConfig()
    sc.run_dir_root = kwargs.pop("result_dir")
    sc.run_desc = subcmd
    return submit_run(sc, "inclusivegan_torch.run_projector.project_real_images", **kwargs)


if __name__ == "__main__":
    main()
