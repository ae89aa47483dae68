"""Metric evaluation CLI of the port, with the flags of the JAX package's
``run_metrics.py``: each metric of ``--metrics`` evaluates the Gs of
``--network`` against the ``--dataset`` under ``--data-dir``, and appends
its line to ``metric-<name>.txt`` in a new run dir under ``--result-dir``.

FID (``fid30k``, ``fid10k``), IS (``is50k``) and ``dummy`` are ported; naming
another metric of the registry raises ``NotImplementedError`` with its
``ROADMAP.md`` item before anything loads. ``main`` switches TF32 off for
cuDNN's convolutions and for matrix products, so that Gs and InceptionV3
compute in float32 on the card, as in the JAX package; ``--device cpu``
evaluates on the CPU.

    python -m inclusivegan_torch.run_metrics --network PKL --data-dir DIR \\
        --dataset NAME --metrics fid30k,is50k --mirror-augment true
"""

import argparse

import torch

from .metrics.metric_defaults import metric_args
from .utils.run_harness import SubmitConfig, submit_run


def run(submit_config, network_pkl, metrics, dataset, data_dir, mirror_augment=False,
        device="cuda"):
    """Evaluate ``metrics`` (registry entries) on ``network_pkl``; returns
    {name + suffix: value}."""
    from .metrics import metric_base
    print(f'Evaluating metrics "{",".join(m.name for m in metrics)}" '
          f'for "{network_pkl}"...')
    dataset_args = {"tfrecord_dir": dataset, "max_label_size": "full"}
    results = {}
    for args in metrics:
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
        description="Run StyleGAN2 metrics (PyTorch/CUDA port, one card). Computes "
        "in float32: TF32 is switched off for convolutions and matrix products.")
    parser.add_argument("--result-dir", default="results", metavar="DIR")
    parser.add_argument("--network", dest="network_pkl", required=True)
    parser.add_argument("--metrics", default="fid30k", type=_parse_comma_sep,
                        help="comma-separated registry names; ported: fid30k, "
                             "fid10k, is50k, dummy")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--num-gpus", "--num-devices", dest="num_devices", type=int,
                        default=1, metavar="N", help="1 only: more cards are not "
                        "ported yet")
    parser.add_argument("--mirror-augment", default=False, type=_str_to_bool,
                        metavar="BOOL", help="mirror-augment the reals, so that their "
                        "statistics match an augmented training run")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return vars(parser.parse_args(argv))


def main(argv=None):
    args = parse_args(argv)
    if args.pop("num_devices") > 1:
        raise NotImplementedError("--num-gpus over 1: evaluation on more than one card "
                                  "is not ported yet (ROADMAP.md, queue 1 item 6)")
    metrics = metric_args(args.pop("metrics"))
    # float32 as in the JAX package: torch's default lets cuDNN convolve in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = SubmitConfig()
    sc.run_dir_root = args.pop("result_dir")
    sc.run_desc = "run_metrics"
    return submit_run(sc, "inclusivegan_torch.run_metrics.run", metrics=metrics, **args)


if __name__ == "__main__":
    main()
