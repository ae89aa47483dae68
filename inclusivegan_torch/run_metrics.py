"""Metric evaluation CLI of the port, with the flags of the JAX package's
``run_metrics.py``: each metric of ``--metrics`` evaluates the Gs of
``--network`` against the ``--dataset`` under ``--data-dir``, and appends
its line to ``metric-<name>.txt`` in a new run dir under ``--result-dir``.

Every name of the registry runs; an unknown one raises before anything
loads. As in the JAX package, ``--lpips-weights`` goes to the PPL metrics
only, and ``--classifier-weights`` to ``mode_counts_*`` and ``KL*`` only.
``main`` switches TF32 off for cuDNN's convolutions and for matrix
products, so that the Gs and the metrics' nets compute in float32 on the
card, as in the JAX package; ``--device cpu`` evaluates on the CPU.
``--num-gpus N`` evaluates on N ranks, one card each (N gloo CPU processes
with ``--device cpu``): each Gs minibatch is split over the ranks, and rank
0 runs the metrics on the gathered images and writes the run dir. More
cards than are present raise before the run dir is made.

    python -m inclusivegan_torch.run_metrics --network PKL --data-dir DIR \\
        --dataset NAME --metrics fid30k,is50k,pr50k3,ppl_wend,ls \\
        --mirror-augment true --lpips-weights NPZ
"""

import argparse

import torch

from .metrics.metric_defaults import metric_args, metric_defaults
from .parallel import check_devices
from .utils.run_harness import SubmitConfig, submit_run


def metric_with_weights(args, lpips_weights=None, classifier_weights=None) -> dict:
    """A registry entry with the command line's weights where the JAX
    package's CLI routes them: LPIPS to PPL, the stacked-MNIST classifier to
    mode_counts and KL."""
    func_name = args.get("func_name", "")
    if lpips_weights and "perceptual_path_length" in func_name:
        args = dict(args, lpips_weights=lpips_weights)
    if classifier_weights and ("mode_counts" in func_name or func_name.endswith("KL.KL")):
        args = dict(args, classifier_weights=classifier_weights)
    return args


def run(submit_config, network_pkl, metrics, dataset, data_dir, mirror_augment=False,
        lpips_weights=None, classifier_weights=None, device="cuda"):
    """Evaluate ``metrics`` (registry entries) on ``network_pkl``; returns
    {name + suffix: value}."""
    from .metrics import metric_base
    print(f'Evaluating metrics "{",".join(m.name for m in metrics)}" '
          f'for "{network_pkl}"...')
    dataset_args = {"tfrecord_dir": dataset, "max_label_size": "full"}
    results = {}
    for args in metrics:
        args = metric_with_weights(args, lpips_weights, classifier_weights)
        results.update(metric_base.run_metric(
            args, network_pkl=network_pkl, dataset_args=dataset_args,
            data_dir=data_dir, run_dir=submit_config.run_dir,
            mirror_augment=mirror_augment, device=device))
    return results


def _str_to_bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _parse_comma_sep(s):
    if s is None or s.lower() == "none" or s == "":
        return []
    return s.split(",")


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Run StyleGAN2 metrics (PyTorch/CUDA port). Computes "
        "in float32: TF32 is switched off for convolutions and matrix products.")
    parser.add_argument("--result-dir", default="results", metavar="DIR")
    parser.add_argument("--network", dest="network_pkl", required=True)
    parser.add_argument("--metrics", default="fid30k", type=_parse_comma_sep,
                        help="comma-separated registry names: "
                             + ", ".join(metric_defaults))
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--num-gpus", "--num-devices", dest="num_devices", type=int,
                        default=1, metavar="N", help="ranks, one CUDA card each "
                        "(CPU processes with --device cpu)")
    parser.add_argument("--mirror-augment", default=False, type=_str_to_bool,
                        metavar="BOOL", help="mirror-augment the reals, so that their "
                        "statistics match an augmented training run")
    parser.add_argument("--lpips-weights", default=None, type=str,
                        help="LPIPS npz for the perceptual metrics (ppl_*); default: "
                             "metrics_weights/vgg16_zhang_perceptual.npz if present, "
                             "else the pixel-pyramid fallback")
    parser.add_argument("--classifier-weights", default=None, type=str,
                        help="stacked-MNIST classifier npz for mode_counts_*/KL*; "
                             "default: metrics_weights/stacked_mnist_classifier.npz "
                             "if present, else a tagged random-init classifier")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return vars(parser.parse_args(argv))


def main(argv=None):
    args = parse_args(argv)
    num_devices = args.pop("num_devices")
    check_devices(num_devices, args["device"])
    metrics = metric_args(args.pop("metrics"))
    # float32 as in the JAX package: torch's default lets cuDNN convolve in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = SubmitConfig()
    sc.run_dir_root = args.pop("result_dir")
    sc.run_desc = "run_metrics"
    sc.num_devices = num_devices
    return submit_run(sc, "inclusivegan_torch.run_metrics.run", metrics=metrics, **args)


if __name__ == "__main__":
    main()
