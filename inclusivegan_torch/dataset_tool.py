"""The dataset tool's command line, the port's counterpart of the
repository's ``dataset_tool.py``: the same subcommands, argument names and
defaults, calling ``inclusivegan_torch.data.dataset_tool``.

    python -m inclusivegan_torch.dataset_tool create_mnistrgb DIR MNIST_DIR
    python -m inclusivegan_torch.dataset_tool display DIR
"""

import argparse
import sys

from .data import dataset_tool as dt


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m inclusivegan_torch.dataset_tool",
        description="Tool for creating datasets (PyTorch port).",
        epilog='Type "%(prog)s <command> -h" for more information.')
    sub = parser.add_subparsers(dest="command")
    sub.required = False

    p = sub.add_parser("display", help="Display dataset info")
    p.add_argument("tfrecord_dir")

    p = sub.add_parser("extract", help="Extract images as PNG")
    p.add_argument("tfrecord_dir")
    p.add_argument("output_dir")
    p.add_argument("--num_images", type=int, default=None)

    p = sub.add_parser("compare", help="Compare two datasets")
    p.add_argument("tfrecord_dir_a")
    p.add_argument("tfrecord_dir_b")
    p.add_argument("--ignore_labels", type=int, default=0)

    p = sub.add_parser("create_mnist", help="Create dataset for MNIST")
    p.add_argument("tfrecord_dir")
    p.add_argument("mnist_dir")

    p = sub.add_parser("create_mnistrgb", help="Create stacked-MNIST dataset")
    p.add_argument("tfrecord_dir")
    p.add_argument("mnist_dir")
    p.add_argument("--num_images", type=int, default=1000000)
    p.add_argument("--random_seed", type=int, default=123)

    p = sub.add_parser("create_cifar10", help="Create dataset for CIFAR-10")
    p.add_argument("tfrecord_dir")
    p.add_argument("cifar10_dir")

    p = sub.add_parser("create_cifar100", help="Create dataset for CIFAR-100")
    p.add_argument("tfrecord_dir")
    p.add_argument("cifar100_dir")

    p = sub.add_parser("create_svhn", help="Create dataset for SVHN")
    p.add_argument("tfrecord_dir")
    p.add_argument("svhn_dir")

    p = sub.add_parser("create_lsun", help="Create dataset from LSUN lmdb")
    p.add_argument("tfrecord_dir")
    p.add_argument("lmdb_dir")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--max_images", type=int, default=None)

    p = sub.add_parser("create_celeba", help="Create dataset for CelebA")
    p.add_argument("tfrecord_dir")
    p.add_argument("celeba_dir")
    p.add_argument("--cx", type=int, default=89)
    p.add_argument("--cy", type=int, default=121)
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--attr_file", type=str, default=None)

    p = sub.add_parser("create_celebahq",
                       help="Create CelebA-HQ from raw CelebA + deltas")
    p.add_argument("tfrecord_dir")
    p.add_argument("celeba_dir")
    p.add_argument("delta_dir")
    p.add_argument("--out_img_dir", type=str, default=None)
    p.add_argument("--num_threads", type=int, default=4)
    p.add_argument("--num_tasks", type=int, default=100)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--strict", type=int, default=1)
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--expected_images", type=int, default=202599,
                   help="corpus-size invariant; lower it for partial corpora")

    p = sub.add_parser("create_from_images", help="Create from image folder")
    p.add_argument("tfrecord_dir")
    p.add_argument("image_dir")
    p.add_argument("--shuffle", type=int, default=0)

    p = sub.add_parser("create_from_hdf5", help="Create from legacy HDF5")
    p.add_argument("tfrecord_dir")
    p.add_argument("hdf5_filename")
    p.add_argument("--shuffle", type=int, default=0)

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        sys.exit(1)
    kwargs = vars(args)
    cmd = kwargs.pop("command")
    for key in ("shuffle", "ignore_labels", "strict"):
        if key in kwargs:
            kwargs[key] = bool(kwargs[key])
    getattr(dt, cmd)(**kwargs)


if __name__ == "__main__":
    main()
