#!/usr/bin/env python3
"""The stacked-MNIST mode-coverage experiment on the card: the port's
``scripts/exp_stacked_mode_coverage.py``, with its flags and defaults.

The repository's north star is a stacked-MNIST mode count of at least
997/1000 (``BASELINE.md``). The run goes through the production pipeline:

  scripts/make_synthetic_mnist.py → dataset_tool create_mnistrgb (1000
  modes) → scripts.train_mnist_classifier → the training loop at
  config-e-Gskip-Dresnet semantics at 32 px in bfloat16 with the full IMLE
  rebuilds (rec and interpolation LPIPS losses) → mode_counts_24k (its KL
  from the same 24576 samples) at every network snapshot.

It submits ``inclusivegan_torch.training.training_loop.training_loop``
through the port's ``submit_run`` with the JAX script's arguments, on
``--device`` (``cuda`` unless ``--device cpu``), with TF32 off as
``run_training`` trains. The run dir is
``<result-root>/NNNNN-stacked-synth-<N>k-mode-coverage`` with a full-state
checkpoint beside every network snapshot, which
``scripts/watchdog_mode_coverage.py`` and
``scripts/mirror_best_checkpoint.py`` read unchanged. It runs as a module
or as a file, as the watchdog launches it:

    python -m inclusivegan_torch.scripts.exp_stacked_mode_coverage \\
        --data-dir D --dataset stacked_synth_240k --data-size 240000 \\
        --classifier metrics_weights/stacked_mnist_classifier.npz \\
        --lpips-weights artifacts/perceptual_vgg.npz
    python3 scripts/watchdog_mode_coverage.py --run-dir RUN --pid-file PID \\
        --exp-script inclusivegan_torch/scripts/exp_stacked_mode_coverage.py \\
        --repo-root . --result-root results --launch-args "..."
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="/tmp/exp/datasets")
    p.add_argument("--dataset", default="stacked_synth_16k")
    p.add_argument("--data-size", type=int, default=16384)
    p.add_argument("--classifier", default="/tmp/exp/stacked_mnist_classifier.npz")
    p.add_argument("--result-root", default="results")
    p.add_argument("--num-epochs", type=int, default=200)
    p.add_argument("--minibatch", type=int, default=32)
    p.add_argument("--num-samples-factor", type=int, default=10)
    p.add_argument("--init-proj-dim", type=int, default=512,
                   help="the IMLE random projection's dimension; 0 projects nothing")
    p.add_argument("--candidate-batch-size", type=int, default=1024)
    p.add_argument("--smoke", type=int, default=0,
                   help="if >0, stop after this many iterations")
    p.add_argument("--image-snapshot-ticks", type=int, default=5)
    p.add_argument("--network-snapshot-ticks", type=int, default=10,
                   help="cadence of the snapshot, the checkpoint and the metric")
    p.add_argument("--resume-checkpoint", default=None,
                   help="a step_* dir, a checkpoints/ dir or a run dir to resume the "
                        "full state from")
    p.add_argument("--resume-pkl", default=None,
                   help="weights-only (G, D, Gs) snapshot to resume from, e.g. the "
                        "output of scripts/restore_best_weights.py (fresh Adam moments)")
    p.add_argument("--resume-rampup-kimg", type=float, default=0.0,
                   help="after --resume-pkl: learning rates ramp linearly from 0 over "
                        "this many kimg past the resume point")
    p.add_argument("--resume-g-from-gs", action="store_true",
                   help="start training G from the snapshot's Gs (EMA) weights")
    p.add_argument("--resume-staleness", type=int, default=None,
                   help="override the restored IMLE staleness on resume from a "
                        "checkpoint (smaller = more frequent rebuilds)")
    p.add_argument("--g-lrate", type=float, default=0.002)
    p.add_argument("--d-lrate", type=float, default=0.002)
    p.add_argument("--gamma", type=float, default=100.0, help="R1 gradient-penalty weight")
    p.add_argument("--rec-weight", type=float, default=2.5, help="NN_rec_lpips_weight")
    p.add_argument("--rec-weight-final", type=float, default=None,
                   help="ramp NN_rec_lpips_weight linearly from --rec-weight to this "
                        "value over [--rec-weight-ramp-start, --rec-weight-ramp-end] kimg")
    p.add_argument("--rec-weight-ramp-start", type=float, default=0.0)
    p.add_argument("--rec-weight-ramp-end", type=float, default=0.0)
    p.add_argument("--exclusive-retrieved-code", type=int, default=0,
                   help="each real gets a different retrieved candidate latent")
    p.add_argument("--seed", type=int, default=1000, help="the training loop's seed")
    p.add_argument("--lpips-weights", default=None,
                   help="npz of the perceptual net (scripts.train_perceptual_vgg); "
                        "None falls back to the pixel-pyramid metric")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="compute dtype of G, D and the LPIPS trunk (parameters and "
                        "optimizer stay float32)")
    p.add_argument("--g-loss-batched", type=int, default=1,
                   help="1: the four G forwards and six LPIPS passes fused into one "
                        "each; 0: one per forward")
    p.add_argument("--ema-kimg", type=float, default=10.0, help="G_smoothing_kimg")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    from inclusivegan_torch.scripts._train import training_device
    from inclusivegan_torch.utils.easydict import EasyDict
    from inclusivegan_torch.utils.run_harness import SubmitConfig, submit_run

    device = training_device(args.device)  # TF32 off
    dtype = getattr(torch, args.dtype)

    # mode_counts_24k reports the KL of the same 24576 samples, so KL24k
    # would only repeat the sampling pass
    metrics = []
    for name in ("mode_counts_24k",):
        m = EasyDict(metric_defaults[name])
        m.classifier_weights = args.classifier
        metrics.append(m)

    sc = SubmitConfig()
    sc.run_dir_root = args.result_root
    sc.run_desc = f"stacked-synth-{args.data_size // 1024}k-mode-coverage"
    sc.num_devices = 1

    return submit_run(
        sc, "inclusivegan_torch.training.training_loop.training_loop",
        # config-e-Gskip-Dresnet semantics
        G_args=EasyDict(fmap_base=8 << 10, architecture="skip", dtype=dtype),
        D_args=EasyDict(fmap_base=8 << 10, architecture="resnet", mbstd_group_size=8,
                        dtype=dtype),
        G_opt_args=EasyDict(beta1=0.0, beta2=0.99, epsilon=1e-8),
        D_opt_args=EasyDict(beta1=0.0, beta2=0.99, epsilon=1e-8),
        G_loss_args=EasyDict(NN_rec_lpips_weight=args.rec_weight,
                             batched=bool(args.g_loss_batched)),
        D_loss_args=EasyDict(gamma=args.gamma),
        dataset_args=EasyDict(tfrecord_dir=args.dataset, max_label_size=0),
        sched_args=EasyDict(G_lrate_base=args.g_lrate, D_lrate_base=args.d_lrate,
                            minibatch_size_base=args.minibatch,
                            minibatch_gpu_base=args.minibatch, tick_kimg_base=20),
        grid_args=EasyDict(size="1080p"),
        metric_arg_list=metrics,
        data_dir=args.data_dir,
        seed=args.seed,
        G_smoothing_kimg=args.ema_kimg,
        total_kimg=args.data_size * args.num_epochs // 1000,
        mirror_augment=False,
        data_size=args.data_size,
        num_epochs=args.num_epochs,
        init_proj_dim=args.init_proj_dim or None,
        init_staleness=10,
        num_samples_factor=args.num_samples_factor,
        knn_perturb_factor=0.05,
        candidate_batch_size=args.candidate_batch_size,
        exclusive_retrieved_code=args.exclusive_retrieved_code,
        rec_weight_final=args.rec_weight_final,
        rec_weight_ramp_start_kimg=args.rec_weight_ramp_start,
        rec_weight_ramp_end_kimg=args.rec_weight_ramp_end,
        dist_thres_percentile=100.0,
        attr_interesting=None,
        lpips_weights_path=args.lpips_weights,
        image_snapshot_ticks=args.image_snapshot_ticks,
        network_snapshot_ticks=args.network_snapshot_ticks,
        resume_pkl=args.resume_pkl,
        resume_checkpoint=args.resume_checkpoint,
        resume_staleness=args.resume_staleness,
        resume_lrate_rampup_kimg=args.resume_rampup_kimg,
        resume_g_from_gs=args.resume_g_from_gs,
        num_devices=1,
        smoke_test_max_iters=args.smoke or None,
        save_full_checkpoints=True,
        device=str(device),
    )


if __name__ == "__main__":
    main()
