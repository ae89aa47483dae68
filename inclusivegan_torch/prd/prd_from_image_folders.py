"""PRD of image folders, the port's counterpart of
``inclusivegan_tpu/prd/prd_from_image_folders.py``: embed a reference
folder and each evaluated folder with ``models.feature_nets.VGGFeatureNet``
on the card (an md5-keyed cache of the embeddings), compute PRD with k-means
on the card, print the (F_8, F_1/8) pair of each folder and write the plot.

    python -m inclusivegan_torch.prd.prd_from_image_folders \
        --reference_dir REAL --eval_dirs FAKE1 FAKE2 --eval_labels a b \
        [--num_images 50000] [--plot_path prd.png] [--device cuda]

PNGs are read with ``utils.misc.read_png``; JPEGs need Pillow, imported
only when a folder holds them.
"""

import argparse
import glob
import hashlib
import os
import tempfile

import numpy as np
import torch

from ..utils.misc import read_png


def load_images_from_folder(folder: str, num_images: int) -> np.ndarray:
    """The first ``num_images`` of the folder's sorted ``*.png`` then
    ``*.jpg`` files as float32 [N, C, H, W] in [0, 255]."""
    files = sorted(glob.glob(os.path.join(folder, "*.png")) +
                   glob.glob(os.path.join(folder, "*.jpg")))
    assert len(files) >= num_images, (folder, len(files), num_images)
    imgs = []
    for f in files[:num_images]:
        if f.endswith(".png"):
            arr = read_png(f)
        else:
            from PIL import Image
            arr = np.asarray(Image.open(f))
        if arr.ndim == 2:
            arr = arr[None]
        else:
            arr = arr.transpose(2, 0, 1)
        imgs.append(arr)
    return np.stack(imgs).astype(np.float32)


def embed_folder(folder: str, num_images: int, cache_dir: str, batch: int = 64,
                 device="cuda") -> np.ndarray:
    """The folder's VGG features [N, 1472], read from ``cache_dir`` when the
    same folder, count and network were embedded before."""
    from ..models.feature_nets import VGGFeatureNet
    net = VGGFeatureNet(device=device)
    key = hashlib.md5(f"{os.path.abspath(folder)}|{num_images}|"
                      f"{net.checksum()}".encode()).hexdigest()
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"prd_embed_{key}.npy")
    if os.path.exists(cache):
        return np.load(cache)
    imgs = load_images_from_folder(folder, num_images)
    feats = np.concatenate([net(imgs[i:i + batch])
                            for i in range(0, len(imgs), batch)])
    np.save(cache, feats)
    return feats


def main(argv=None):
    from . import prd_score
    parser = argparse.ArgumentParser(
        prog="python -m inclusivegan_torch.prd.prd_from_image_folders",
        description="Assess generative models with PRD (PyTorch port).")
    parser.add_argument("--reference_dir", required=True)
    parser.add_argument("--eval_dirs", nargs="+", required=True)
    parser.add_argument("--eval_labels", nargs="+", required=True)
    parser.add_argument("--num_clusters", type=int, default=20)
    parser.add_argument("--num_angles", type=int, default=1001)
    parser.add_argument("--num_runs", type=int, default=10)
    parser.add_argument("--plot_path", default="prd.png")
    parser.add_argument("--cache_dir", default=os.path.join(tempfile.gettempdir(),
                                                            "prd_cache"))
    parser.add_argument("--num_images", type=int, default=50000)
    parser.add_argument("--silent", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="where the embeddings and the k-means run")
    args = parser.parse_args(argv)
    if len(args.eval_dirs) != len(args.eval_labels):
        parser.error("--eval_dirs and --eval_labels must have the same length")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")

    def embedding(folder):
        feats = embed_folder(folder, args.num_images, args.cache_dir, device=args.device)
        return torch.from_numpy(feats).to(args.device)

    ref_feats = embedding(args.reference_dir)
    generator = torch.Generator(device=args.device).manual_seed(0)
    prd_pairs = []
    for d in args.eval_dirs:
        prd_pairs.append(prd_score.compute_prd_from_embedding(
            embedding(d), ref_feats, num_clusters=args.num_clusters,
            num_angles=args.num_angles, num_runs=args.num_runs, generator=generator))
    f_beta_pairs = [prd_score.prd_to_max_f_beta_pair(p, r) for p, r in prd_pairs]
    if not args.silent:
        print("F_8   F_1/8     model")
        for label, (f8, f1_8) in zip(args.eval_labels, f_beta_pairs):
            print(f"{f8:.3f} {f1_8:.3f}     {label}")
    prd_score.plot(prd_pairs, labels=args.eval_labels, out_path=args.plot_path)
    return f_beta_pairs


if __name__ == "__main__":
    main()
