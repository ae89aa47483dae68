"""Training CLI of the port, with the flags of the JAX package's
``run_training.py`` and its ``run()``: the same config table (config-e* and
config-f; config-a to -d refused as there), the same run-dir description,
and the same keyword arguments for the loop, which it submits as
``inclusivegan_torch.training.training_loop.training_loop`` on one CUDA card
(``--device cpu`` trains on the CPU).

``main`` switches TF32 off for cuDNN's convolutions and for matrix products
before anything loads, so that the card computes in float32 as the JAX
package does; the IMLE retrieval relies on it. ``--dtype bfloat16`` computes
G, D and the LPIPS trunk in bfloat16 from a fresh init (the JAX package's
float32 islands kept). ``--metrics`` takes the registry's names (default
``none``) and runs them at every network snapshot; an unknown name raises
before the run starts. ``--invariant-rng true``, ``--knn-backend dci`` and
``--num-gpus`` over 1 raise ``NotImplementedError`` before the run starts
(each names its ``ROADMAP.md`` item; an ``auto``
backend over the exact budget, and a minibatch that needs gradient
accumulation, are refused by the loop before it builds the networks).

The CelebA production run (``scripts/run_celeba_quality_loop.sh``):

    python -m inclusivegan_torch.run_training --data-dir DIR --dataset NAME \\
        --config config-e-Gskip-Dresnet --num-gpus 1 --data-size 30000 \\
        --metrics fid30k --mirror-augment true --init-proj-dim 512 \\
        --candidate-batch-size 1024 \\
        --lpips-weights artifacts/celeba_perceptual_vgg.npz --dtype bfloat16
"""

import argparse
import os
import sys

import torch

from .metrics.metric_defaults import metric_args, metric_defaults
from .utils.easydict import EasyDict
from .utils.run_harness import SubmitConfig, submit_run

_valid_configs = [
    "config-a", "config-b", "config-c", "config-d", "config-e", "config-f",
    "config-e-Gorig-Dorig", "config-e-Gorig-Dskip", "config-e-Gorig-Dresnet",
    "config-e-Gskip-Dorig", "config-e-Gskip-Dskip", "config-e-Gskip-Dresnet",
    "config-e-Gresnet-Dorig", "config-e-Gresnet-Dskip",
    "config-e-Gresnet-Dresnet",
]


def _refuse_unported(num_devices, invariant_rng, knn_backend):
    if invariant_rng:
        raise NotImplementedError("--invariant-rng is not ported yet (ROADMAP.md, "
                                  "queue 1 item 4)")
    if knn_backend == "dci":
        raise NotImplementedError("--knn-backend dci is not ported yet "
                                  "(ROADMAP.md, queue 1 item 5)")
    if num_devices > 1:
        raise NotImplementedError(f"--num-gpus {num_devices}: training on more than "
                                  "one card is not ported yet (ROADMAP.md, queue 1 "
                                  "item 6)")


def run(dataset, data_dir, result_dir, config_id, num_devices, gamma,
        mirror_augment, metrics, resume_pkl, minibatch_gpu, data_size,
        num_epochs, init_proj_dim, init_staleness, num_samples_factor,
        knn_perturb_factor, candidate_batch_size, exclusive_retrieved_code,
        NN_rec_lpips_weight, dist_thres_percentile, attr_interesting,
        init_mul, total_kimg=None, smoke_test_max_iters=None,
        resume_checkpoint=None, dtype="float32", knn_backend="auto",
        lpips_weights=None, image_snapshot_ticks=None,
        network_snapshot_ticks=None, invariant_rng=False,
        enable_profiler=False, g_loss_batched=None, lpips_norm=None,
        seed=None, device="cuda"):
    _refuse_unported(num_devices, invariant_rng, knn_backend)
    metrics = metric_args(metrics)
    train = EasyDict()
    G = EasyDict(init_mul=init_mul)
    D = EasyDict(init_mul=init_mul)
    if dtype != "float32":
        # bfloat16 activations; parameters, optimizer and the reductions
        # that the networks keep in float32 stay float32
        G.dtype = D.dtype = dtype
    G_opt = EasyDict(beta1=0.0, beta2=0.99, epsilon=1e-8)
    D_opt = EasyDict(beta1=0.0, beta2=0.99, epsilon=1e-8)
    G_loss = EasyDict(NN_rec_lpips_weight=NN_rec_lpips_weight)
    if g_loss_batched is not None:
        G_loss.batched = g_loss_batched
    D_loss = EasyDict(gamma=10.0)
    sched = EasyDict()
    grid = EasyDict(size="1080p")
    sc = SubmitConfig()

    train.total_kimg = total_kimg if total_kimg is not None else \
        (data_size * num_epochs) // 1000
    train.mirror_augment = mirror_augment
    sched.G_lrate_base = sched.D_lrate_base = 0.002
    sched.minibatch_gpu_base = minibatch_gpu
    sched.minibatch_size_base = minibatch_gpu * num_devices
    train.resume_pkl = resume_pkl
    if resume_checkpoint is not None:
        train.resume_checkpoint = resume_checkpoint
    if lpips_weights is not None:
        train.lpips_weights_path = lpips_weights
    if lpips_norm is not None:
        train.lpips_norm = lpips_norm
    if seed is not None:
        train.seed = seed
    train.update(data_size=data_size, num_epochs=num_epochs,
                 init_proj_dim=init_proj_dim, init_staleness=init_staleness,
                 num_samples_factor=num_samples_factor,
                 knn_perturb_factor=knn_perturb_factor,
                 candidate_batch_size=candidate_batch_size,
                 exclusive_retrieved_code=exclusive_retrieved_code,
                 dist_thres_percentile=dist_thres_percentile,
                 attr_interesting=attr_interesting,
                 knn_backend=knn_backend)
    if enable_profiler:
        train.enable_profiler = True
    if smoke_test_max_iters:
        train.smoke_test_max_iters = smoke_test_max_iters
    if image_snapshot_ticks is not None:
        train.image_snapshot_ticks = image_snapshot_ticks
    if network_snapshot_ticks is not None:
        train.network_snapshot_ticks = network_snapshot_ticks

    desc = "stylegan2"
    desc += "-" + dataset
    dataset_args = EasyDict(tfrecord_dir=dataset, max_label_size="full")
    sc.num_devices = num_devices
    desc += f"-{num_devices}dev"

    assert config_id in _valid_configs
    if config_id in ("config-a", "config-b", "config-c", "config-d"):
        raise SystemExit(
            f"{config_id} is a vestigial preset: the reference fork ships "
            "neither its networks nor its loss. Use config-e*/config-f.")
    desc += "-" + config_id
    desc += "_noProj" if init_proj_dim is None else f"_{init_proj_dim}Proj"
    desc += f"_init_staleness_{init_staleness}"
    desc += f"_num_samples_factor_{num_samples_factor}"
    desc += f"_knn_perturb_factor_{knn_perturb_factor:f}"
    desc += f"_NN_rec_lpips_weight_{NN_rec_lpips_weight:f}"
    if attr_interesting is not None:
        desc += "_" + attr_interesting.replace(",", "_and_")
    desc += "_scratch" if resume_pkl is None or "_scratch" in resume_pkl else "_finetune"

    # configs a-e halve the feature maps of config-f
    if config_id != "config-f":
        G.fmap_base = D.fmap_base = 8 << 10
    if config_id.startswith("config-e"):
        D_loss.gamma = 100
        if "Gorig" in config_id:
            G.architecture = "orig"
        if "Gskip" in config_id:
            G.architecture = "skip"
        if "Gresnet" in config_id:
            G.architecture = "resnet"
        if "Dorig" in config_id:
            D.architecture = "orig"
        if "Dskip" in config_id:
            D.architecture = "skip"
        if "Dresnet" in config_id:
            D.architecture = "resnet"
    if gamma is not None:
        D_loss.gamma = gamma

    kwargs = EasyDict(train)
    kwargs.update(G_args=G, D_args=D, G_opt_args=G_opt, D_opt_args=D_opt,
                  G_loss_args=G_loss, D_loss_args=D_loss,
                  dataset_args=dataset_args, sched_args=sched,
                  grid_args=grid, metric_arg_list=metrics,
                  data_dir=data_dir, num_devices=num_devices, device=device)
    sc.run_dir_root = result_dir
    sc.run_desc = desc
    return submit_run(sc, "inclusivegan_torch.training.training_loop.training_loop",
                      **kwargs)


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
    """The command line as ``run()``'s keyword arguments."""
    parser = argparse.ArgumentParser(
        description="Train StyleGAN2 with IMLE (PyTorch/CUDA port, one card). "
        "Computes in float32, TF32 is switched off for convolutions and matrix "
        "products, unless --dtype bfloat16.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--result-dir", default="results", metavar="DIR")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--config", default="config-e", dest="config_id",
                        metavar="CONFIG")
    parser.add_argument("--init-mul", default=1.0, type=float)
    parser.add_argument("--num-gpus", "--num-devices", dest="num_devices",
                        default=1, type=int, metavar="N",
                        help="1 only: more cards are not ported yet")
    parser.add_argument("--gamma", default=None, type=float)
    parser.add_argument("--mirror-augment", default=False, metavar="BOOL",
                        type=_str_to_bool)
    parser.add_argument("--metrics", default="none", type=_parse_comma_sep,
                        help="none (default) or comma-separated registry names, "
                             "run at every network snapshot: "
                             + ", ".join(metric_defaults))
    parser.add_argument("--minibatch-gpu", metavar="N", default=6, type=int)
    parser.add_argument("--data-size", metavar="N", default=30000, type=int)
    parser.add_argument("--num-epochs", metavar="N", default=10000, type=int)
    parser.add_argument("--total-kimg", metavar="N", default=None, type=int)
    parser.add_argument("--init-proj-dim", metavar="N", default=None, type=int)
    parser.add_argument("--init-staleness", metavar="N", default=10, type=int)
    parser.add_argument("--num-samples-factor", metavar="N", default=10,
                        type=int)
    parser.add_argument("--knn-perturb-factor", default=0.05, type=float)
    parser.add_argument("--knn-backend", default="auto",
                        choices=("auto", "exact", "dci"),
                        help="IMLE retrieval: exact kNN on the card (auto "
                             "takes it while the candidate features fit its "
                             "budget); dci is not ported yet")
    parser.add_argument("--candidate-batch-size", metavar="N", default=256,
                        type=int)
    parser.add_argument("--exclusive-retrieved-code", metavar="N", default=0,
                        type=int)
    parser.add_argument("--NN-rec-lpips-weight", default=2.5, type=float)
    parser.add_argument("--dist-thres-percentile", default=100.0, type=float)
    parser.add_argument("--attr-interesting", default=None, type=str)
    parser.add_argument("--resume-pkl", default=None, type=str)
    parser.add_argument("--resume-checkpoint", default=None, type=str,
                        help="full-state checkpoint (step dir, checkpoints/ "
                             "dir, or run dir)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="activation dtype of G, D and the LPIPS trunk")
    parser.add_argument("--seed", default=None, type=int, metavar="N",
                        help="training_loop seed (numpy and every torch "
                             "generator; default 1000)")
    parser.add_argument("--invariant-rng", default=False, metavar="BOOL",
                        type=_str_to_bool, help="not ported yet")
    parser.add_argument("--lpips-weights", default=None, type=str,
                        help="LPIPS npz for the rec anchor; default: "
                             "metrics_weights/vgg16_zhang_perceptual.npz if "
                             "present, else the pixel-pyramid fallback")
    parser.add_argument("--smoke-test-max-iters", default=None, type=int,
                        help="stop after N iterations")
    parser.add_argument("--g-loss-batched", default=None, metavar="BOOL",
                        type=_str_to_bool,
                        help="one G forward and one LPIPS pass for the G "
                             "phase's four and six (default: the loop's)")
    parser.add_argument("--lpips-norm", default=None, choices=("f32", "trunk"),
                        help="LPIPS tap normalization: f32 (default) normalizes "
                             "float32 copies of the tap maps, trunk keeps them in "
                             "the trunk's dtype")
    parser.add_argument("--enable-profiler", default=False, metavar="BOOL",
                        type=_str_to_bool,
                        help="torch.profiler trace of iterations 8-16 into "
                             "<run_dir>/profile")
    parser.add_argument("--image-snapshot-ticks", default=None, type=int,
                        help="grid-image cadence in ticks (default: derived "
                             "from the data size)")
    parser.add_argument("--network-snapshot-ticks", default=None, type=int,
                        help="snapshot and checkpoint cadence in ticks "
                             "(default: derived from the data size)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    args = parser.parse_args(argv)
    if not os.path.exists(args.data_dir):
        print("Error: dataset root directory does not exist.")
        sys.exit(1)
    if args.config_id not in _valid_configs:
        print("Error: --config value must be one of:",
              ", ".join(_valid_configs))
        sys.exit(1)
    return vars(args)


def main(argv=None):
    # float32 as in the JAX package: torch's default lets cuDNN convolve in
    # TF32, and TF32 would reorder the IMLE retrieval's neighbours
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run(**parse_args(argv))


if __name__ == "__main__":
    main()
