"""Convert a reference network's variables to a ``network_snapshot.v1``
pickle: the port's ``scripts/convert_reference_pkl.py`` (stage 2).

The reference's pickles embed their TF module source and re-exec it on
load, so they unpickle only in a TF1 environment. Stage 1 runs there
(``python scripts/dump_reference_vars.py network.pkl vars.npz``) and writes
``{"<net>/<variable scope>/<name>": value}`` for G, D and Gs. This stage maps
those names onto the parameter trees, which are keyed by the same variable
scopes, and writes the pickle that ``snapshot.load_networks`` and
``pretrained_networks.load_networks`` read in either package: the same
``format`` string, the same G, Gs and D trees, and each network's config
dict from the port's ``GMain.create(...).config`` and
``Discriminator(...).config``, which equal the JAX package's
``dataclasses.asdict`` of the same networks key for key.

The command line takes the JAX script's flags with their defaults, and
``--label-size`` for a conditional network, which the JAX script's command
line cannot convert. After writing, the pickle is loaded into the port's G,
D and Gs on ``--device`` (``cuda`` unless ``cpu`` is passed), so a tree that
does not fit the networks raises here.

    python -m inclusivegan_torch.scripts.convert_reference_pkl vars.npz out.pkl \\
        --resolution 128 [--device cpu]
"""

import argparse
import pickle

import numpy as np
import torch

from ..models.stylegan2 import Discriminator, GMain
from ..snapshot import SNAPSHOT_FORMAT, load_networks


def vars_to_tree(var_dict, prefix):
    """'G_synthesis/4x4/Conv/weight' style names → nested dict tree."""
    tree = {}
    for name, value in var_dict.items():
        if not name.startswith(prefix):
            continue
        parts = name[len(prefix):].strip("/").split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def convert(vars_npz: str, out_pkl: str, resolution: int, num_channels: int,
            latent_size: int = 512, fmap_base: int = 8 << 10,
            g_arch: str = "skip", d_arch: str = "resnet",
            g_kwargs: dict = {}, d_kwargs: dict = {}):
    data = dict(np.load(vars_npz))

    def g_tree(net):
        mapping = vars_to_tree(data, f"{net}/G_mapping")
        synthesis = vars_to_tree(data, f"{net}/G_synthesis")
        noise = {k: v for k, v in synthesis.items() if k.startswith("noise")}
        for k in noise:
            synthesis.pop(k)
        return {
            "mapping": mapping,
            "synthesis": synthesis,
            "noise": noise,
            "dlatent_avg": np.asarray(
                data.get(f"{net}/dlatent_avg", np.zeros(latent_size))),
        }

    def g_config():
        return _g_config(resolution, num_channels, latent_size, fmap_base, g_arch, **g_kwargs)

    snap = {
        "format": SNAPSHOT_FORMAT + ".v1",
        "G": {"config": g_config(), "params": g_tree("G")},
        "Gs": {"config": g_config(), "params": g_tree("Gs")},
        "D": {"config": _d_config(resolution, num_channels, fmap_base, d_arch, **d_kwargs),
              "params": vars_to_tree(data, "D")},
    }
    with open(out_pkl, "wb") as f:
        pickle.dump(snap, f)
    print(f"wrote {out_pkl}")


def _g_config(resolution, num_channels, latent_size, fmap_base, arch, **kwargs):
    return GMain.create(resolution=resolution, num_channels=num_channels,
                        latent_size=latent_size, dlatent_size=latent_size,
                        fmap_base=fmap_base, architecture=arch, **kwargs).config


def _d_config(resolution, num_channels, fmap_base, arch, **kwargs):
    return Discriminator(resolution=resolution, num_channels=num_channels,
                         fmap_base=fmap_base, architecture=arch, **kwargs).config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("vars_npz")
    parser.add_argument("out_pkl")
    parser.add_argument("--resolution", type=int, required=True)
    parser.add_argument("--num-channels", type=int, default=3)
    parser.add_argument("--latent-size", type=int, default=512)
    parser.add_argument("--fmap-base", type=int, default=8 << 10)
    parser.add_argument("--g-arch", default="skip")
    parser.add_argument("--d-arch", default="resnet")
    parser.add_argument("--label-size", type=int, default=0,
                        help="labels of a conditional G and D, as a CelebA run's 40 "
                             "attributes (default 0, the JAX script's)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu: where the "
                        "written pickle is loaded into the port's networks")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    labels = dict(label_size=args.label_size)
    convert(args.vars_npz, args.out_pkl, args.resolution, args.num_channels,
            args.latent_size, args.fmap_base, args.g_arch, args.d_arch, labels, labels)
    load_networks(args.out_pkl, args.device)
    print(f"loaded G, D and Gs of {args.out_pkl} into the port's networks on {args.device}")


if __name__ == "__main__":
    main()
