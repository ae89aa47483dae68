#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Phases, each logged with the seconds since start:
  1. device: require CUDA, print the card's name and power limit, turn TF32
     off for convolutions and matmuls;
  2. build: both CUDA kernels from ``inclusivegan_torch/ops/csrc`` in one
     ``nvcc`` call (budget 60 s);
  3. load the CelebA-128 Gs from ``artifacts/celeba_best_weights_fp16.pkl``
     and record the arguments of every kernel launch of one forward at
     minibatch 4;
  4. every kernel at every one of those shapes against its plain PyTorch
     version on the same inputs, in float32, bfloat16 and float16, exactly;
  5. the main path: ``generate_images`` for 8 images in minibatches of 4,
     with the launch counts set to 0 just before and read just after; the
     images against the plain versions on the card and the JAX golden;
  6. times: each kernel at its largest shape beside its plain version, its
     bound and a library call (CUDA events, medians after warm-up), and
     generate-images at minibatch 16 in images/s on the host clock, with the
     kernels and the plain versions in turns;
  7. the training slice: the arguments of every kernel launch of one
     training iteration of CelebA-128 config-e-Gskip-Dresnet at minibatch 6
     (forward, backward and double backward of both kernels), and each
     kernel at each of those shapes against its plain version, in float32,
     bfloat16 and float16, exactly; then the upfirdn2d kernel in every one of
     its dispatch branches (``FIR_BRANCHES``), in the three dtypes, exactly;
  8. autograd on the card: first- and second-order gradients through the
     kernels' autograd Functions against the plain versions, at the largest
     training shape of each op;
  9. the main path of training: the IMLE rebuild (600 candidates, 512-dim
     projector), ``next_rec_batch`` and iteration 0 (both lazy
     regularizers) through ``train_step``, with the launch counts set to 0
     just before and read just after; then phase by phase, from one state
     and with one set of draws, the kernel path against the plain path:
     loss scalars, every parameter's gradient, pl_mean, the Gs EMA, and
     each phase's launch counts against the counts derived from the model;
 10. the card against the JAX golden of one iteration
     (``inclusivegan_torch/testdata/celeba128_train_golden.npz``, minibatch
     3): loss scalars and each parameter's gradient norm, phase by phase,
     shown with cuDNN's default algorithms and held with convolutions
     through PyTorch's own float32 GEMMs; then the gradient norm farthest
     from the golden under the default algorithms, once more in float64
     through the plain path, and how far the golden and the card's float32
     readings each lie from it;
 11. times: the gradient kernel and upfirdn2d at its largest transposed
     configuration beside their plain versions, bounds and library calls;
     upfirdn2d at every configuration that phase 9's main path launched it
     with (launches, ms, bound, cuDNN's depthwise convolution) and
     sum(launches * (ms - bound)); seconds per phase of an iteration with
     and without the regularizers, kernels and plain versions in turns; the
     IMLE rebuild;
 12. the training loop, in a temporary directory that is deleted after: a
     128 px TFRecord dataset of 60 seeded images with 40 labels, written by
     the port's exporter; ``python -m inclusivegan_torch.run_training`` with
     the CelebA run's flags at float32 from scratch for 4 iterations (exit
     0, finite losses, ``network-final.pkl``); then twice, through
     ``submit_run`` with the loop arguments the command line builds, 24
     iterations resumed from the CelebA snapshot at its stored float16 (3
     ticks, IMLE rebuilds at iterations 0 and 20, image snapshots every
     tick, network snapshots and checkpoints every 2), with the launch
     counts set to 0 just before and read just after: every kernel
     launched, the run dir's files, G and D still float16, and
     ``network-final.pkl`` read back drawing the in-memory Gs's images
     exactly; after the first of them, both forward kernels at every
     configuration its IMLE rebuilds launched them with (candidates padded
     to the batch of 1024, tensors over 2**31 elements) against their plain
     versions, exactly; then 8 iterations resumed from the last checkpoint
     (step, Adam count and IMLE counters go on from it); from the loop's
     own Timing/* stats, sec/kimg and kimg/h per tick, the iterations alone
     (the ticks' synchronized seconds less the rebuilds, snapshots and
     checkpoints in them), each rebuild, snapshot and checkpoint; and the
     card's peak memory;
 13. the production command at bfloat16: one iteration of the CelebA
     networks with G, D and LPIPS in bf16 against the JAX bf16 golden
     (``celeba128_train_golden_bf16.npz``: its bf16 loss scalars, and the
     gradient norms of its float32 iteration) and, phase by phase, the kernel
     path against the plain path, with every kernel configuration of it held
     exactly in its dtype; bf16 against float32 from one fresh full-width
     state, in turns, with and without the regularizers; InceptionV3 float32
     against float64 on 16 Gs images and FID of a feature set with itself;
     then ``run_training`` with the flags of
     ``scripts/run_celeba_quality_loop.sh:49-54`` (``--dtype bfloat16``,
     fresh init, ``--metrics fid30k`` with is50k, both cut to 2048 fakes)
     for 16 iterations on phase 12's dataset, through ``submit_run`` with
     the launch counts set to 0 just before and read just after: bf16
     networks, finite losses, one finite FID and IS per network snapshot
     with their random-feature tags, no metric failure; the loop's times;
     the rebuild's kernels at 1024 bf16 candidates exact; each kernel in
     bf16 at the largest shape the run gave it (ms, plain, bound, library);
     and ``python -m inclusivegan_torch.run_metrics --metrics fid10k`` on
     the CelebA snapshot at 10000 fakes (exit 0, finite, the Gs's and
     InceptionV3's images/s). The metric cache lives in the phase's
     temporary directory.
 14. the evaluation stage of ``scripts/run_celeba_quality_loop.sh:74-99`` on
     the CelebA snapshot, at full width, cut in depth only (each cut
     printed): sigmoid and swish in 16 bits against the CPU's bits; one
     projector step at minibatch 50 (forward and backward through both
     kernels) and PPL's 32-image synthesis, each kernel path against its
     plain path from the same latents and draws; every kernel configuration
     of these and of the stacked-MNIST run's 32 px G, fresh, exact in the
     three dtypes; then, each with its launch counts set to 0 just before
     and read just after (derived counts held): ``run_metrics --metrics
     pr50k3,ppl_wend --lpips-weights`` at 2048 samples on phase 12's
     seeded set extended to 2048 images (pr50k3's k-NN precision and recall
     on the card against the CPU's, on the run's features and on two
     seeded sets that give neither 0 nor 1), ``run_projector
     project-real-images`` for 50 images of 40 steps at minibatch 50 (the
     run dir's files, ``ivom.txt``), ``ls`` at 4096 samples with the CelebA
     attribute classifier (its SVM in float32 against float64 on the card),
     ``mode_counts_24k`` and ``KL24k`` at 2048 images of the 32 px G with
     the stacked-MNIST classifier; seconds per 1000 samples of each; the
     projector's ms per step with the kernels and the plain versions in
     turns, IvOM seconds per image at 400 steps; the kernels at the
     projector's shapes (ms, plain, bound, cuDNN, launches per step).
The build must take under 60 s, phases 3-6 under 180 s, phases 7-11 under
300 s, phase 12 under 240 s, phase 13 under 300 s and phase 14 under 150 s;
a run over any budget fails. Any failure raises and the script
exits non-zero. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Each kernel's record takes its
``launches`` and its timings (shape, ms, plain, bound, library) from the
IvOM projector of phase 14, the main path of the evaluation slice; the
timing of phase 6 or 11 stands under ``earlier_timing``, and every path's
launches under ``launches_by_path``.
"""

import contextlib
import copy
import gc
import io
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
NETWORK = os.path.join(HERE, "artifacts", "celeba_best_weights_fp16.pkl")
GOLDEN = os.path.join(HERE, "inclusivegan_torch", "testdata",
                      "celeba128_gs_golden.npz")
MINIBATCH = 4
NUM_IMAGES = 8
BENCH_BATCH = 16
DEADLINE_S = 900  # fail loudly well before an outer 1200 s limit
BUILD_BUDGET_S = 60
RUN_BUDGET_S = 180  # phases 3-6
TRAIN_BUDGET_S = 300  # phases 7-11

# The training slice: CelebA-128 config-e-Gskip-Dresnet as
# scripts/run_celeba_quality_loop.sh trains it (gamma 100, mirror augment,
# rec weight 2.5, lazy intervals 4 and 16, projector 512, 10 samples per
# real, perturbation 0.05, candidate batches of 1024), at run_training.py's
# --minibatch-gpu default of 6, float32, as the JAX package resumes this
# snapshot.
TRAIN_MB = 6
DATA_SIZE = 60  # divisible by 2 * minibatch; 600 candidates
TRAIN_CONFIG = dict(gamma=100.0, mirror_augment=True, NN_rec_lpips_weight=2.5,
                    G_reg_interval=4, D_reg_interval=16)
IMLE_CONFIG = dict(num_samples_factor=10, init_proj_dim=512,
                   knn_perturb_factor=0.05, candidate_batch_size=1024)
LRATE = 0.002
GS_BETA = 0.5 ** (TRAIN_MB / 10000.0)  # G_smoothing_kimg 10
LPIPS_WEIGHTS = os.path.join(HERE, "artifacts", "celeba_perceptual_vgg.npz")
TRAIN_GOLDEN = os.path.join(HERE, "inclusivegan_torch", "testdata",
                            "celeba128_train_golden.npz")

# Kernel against plain version, elementwise |k - p| <= atol + rtol * |p|:
# exact in every dtype. Both round where the TPU kernels round (bias + lrelu
# after the sum and after each product, in the storage dtype; the FIR once,
# after a float32 sum taken in one order without FMA).
DTYPES = ("float32", "bfloat16", "float16")
TOL = {dtype: (0.0, 0.0) for dtype in DTYPES}
# Images: uint8 levels, against the plain path and the JAX golden.
IMG_MAX_LEVELS = 2
IMG_MAX_FRACTION = 0.005
# Autograd through the kernels against the plain versions (phase 8): the
# relative L2 error of each gradient. Both sum the same float32 terms in
# another order; 1e-5 leaves two orders of magnitude over that.
AUTOGRAD_REL_L2 = 1e-5
# One training phase, kernel path against plain path from the same state
# and draws (phase 9): loss scalars |k - p| <= 1e-4 |p| + 1e-6, and each
# parameter's gradient (the first Adam moment, since beta1 = 0) within a
# relative L2 error of 1e-3: float32 through three networks and LPIPS,
# where the kernels sum in another order than the plain versions.
TRAIN_SCALAR_TOL = (1e-6, 1e-4)
TRAIN_GRAD_REL_L2 = 1e-3
# The card against the JAX golden (phase 10): loss scalars within 1e-3
# relative, gradient L2 norms within 1e-2 relative (other convolution
# algorithms, float32 sums in other orders, full-width networks).
GOLDEN_SCALAR_RTOL = 1e-3
GOLDEN_NORM_RTOL = 1e-2

# Phase 12, the training loop, with the flags of
# scripts/run_celeba_quality_loop.sh:49-54 at float32 (its --dtype bfloat16
# is not ported yet), on DATA_SIZE synthetic 128 px images with the CelebA
# snapshot's 40 attribute labels: 600 candidates and a few dozen iterations
# instead of 300k and 25000 kimg; the width is not cut.
LOOP_BUDGET_S = 240
LOOP_DATASET = "celeba_synth"
LOOP_LABELS = 40
CLI_FLAGS = ["--config", "config-e-Gskip-Dresnet", "--num-gpus", "1",
             "--minibatch-gpu", str(TRAIN_MB), "--mirror-augment", "true",
             "--init-proj-dim", "512", "--candidate-batch-size", "1024",
             "--num-samples-factor", "10", "--lpips-weights", LPIPS_WEIGHTS,
             "--data-size", str(DATA_SIZE), "--metrics", "none"]
CLI_ITERS = 4  # the command line from scratch
LOOP_TICK_KIMG = 0.048  # resumed runs: a tick every 8 iterations of 6 images,
LOOP_TOTAL_KIMG = 0.144  # 24 iterations, 3 ticks;
LOOP_INIT_STALENESS = 2  # rebuilds at iterations 0 and 20, the staleness doubles
LOOP_RESUME_ITERS = 8  # then from the last checkpoint

# Phase 13, the production command of scripts/run_celeba_quality_loop.sh:49-54
# as it stands: --dtype bfloat16 from a fresh init, --metrics fid30k, with
# is50k beside it (the script's evaluation stage runs FID and IS next). Cut in
# depth as phase 12 (two ticks of 8 iterations, a network snapshot at each)
# and in the metrics' sample counts (BF16_METRIC_IMAGES fakes in place of
# 30000 and 50000); the width is not cut.
BF16_BUDGET_S = 300
BF16_METRICS = ("fid30k", "is50k")
BF16_METRIC_IMAGES = 2048
BF16_TOTAL_KIMG = 0.096  # 16 iterations of 6 images, two ticks of 8
BF16_GOLDEN = os.path.join(HERE, "inclusivegan_torch", "testdata",
                           "celeba128_train_golden_bf16.npz")
# bf16 against the JAX bf16 golden: loss scalars within 2e-2 relative. The
# gradient norms of each phase, as one vector, within BF16_NORM_REL_L2
# (relative L2) of the golden's float32 iteration of the same draws (its
# "f32/" entries), not of its bf16 norms: XLA's CPU backend sums a bf16 bias
# gradient over batch and pixels in bf16, which stagnates at 128 px, so
# JAX's bf16 norms lie 10-53% from float32 and are logged beside the card's
# but hold nothing. Each limit lies between the card's readings (g_main
# 9.02-9.12e-3, g_reg 9.205e-2, d_main 2.84-2.87e-3, d_reg 8.28-8.55e-3)
# and controls that drop one float32 rule of the reference: D's resnet
# promotion (g_main 1.01e-2, d_main 4.75e-3, d_reg 1.07e-2), G's style dense
# (g_main 1.09e-2, d_main 4.00e-3) or its demodulation (g_main 1.01e-2,
# d_main 3.79e-3) in bf16. No control moved g_reg past its limit; the G
# controls move pl_penalty 4.2-4.5e-2 from the golden, past the scalar limit
# (sound: 1.678e-2 in every reading). The kernel path against the plain path
# at bf16: the whole gradient within BF16_PATHS_REL_L2 relative L2 (readings
# 0 to 1.2e-3).
BF16_SCALAR_RTOL = 2e-2
BF16_NORM_REL_L2 = {"g_main": 9.6e-3, "g_reg": 1e-1, "d_main": 3.3e-3, "d_reg": 9.5e-3}
BF16_PATHS_REL_L2 = 5e-3
# InceptionV3 on the card (float32, TF32 off): pool_3 features of 16 Gs
# images against the same net in float64, relative L2; FID of a feature set
# against itself, relative to the mean squared feature norm.
INCEPTION_REL_L2 = 1e-4
FID_SELF_REL = 1e-6
CLI_METRIC = "fid10k"  # run_metrics at the registry's full 10000 fakes

# Phase 14, the evaluation stage of scripts/run_celeba_quality_loop.sh:74-99
# on the CelebA snapshot: run_metrics pr50k3,ppl_wend with the CelebA LPIPS
# weights, run_projector project-real-images (IvOM), ls; then mode_counts_24k
# and KL24k on a fresh init of the stacked-MNIST run's 32 px G. Cut in depth
# only: EVAL_IMAGES samples for pr50k3 and ppl_wend (50000), 50 images of 40
# steps for the projector (300 of 400), LS_CUT for ls (200000 and 100000),
# MNIST_IMAGES for mode_counts and KL (24576). The reals are phase 12's
# seeded set, extended to EVAL_IMAGES and written by another process while
# phases 12 and 13 run (the port's pure-Python CRC takes ~20 s for them).
EVAL_BUDGET_S = 150
EVAL_IMAGES = 2048
PROJ_IMAGES, PROJ_MB, PROJ_STEPS, PROJ_SNAPSHOTS = 50, 50, 40, 5
LS_CUT = dict(num_samples=4096, num_keep=2048)
MNIST_IMAGES = 2048
ATTR_WEIGHTS = os.path.join(HERE, "metrics_weights", "celeba_attr_classifier.npz")
MNIST_WEIGHTS = os.path.join(HERE, "metrics_weights", "stacked_mnist_classifier.npz")
# The Gs config of artifacts/best_weights_fp16.pkl (the stacked-MNIST run),
# which does not fit in the card's copy beside the CelebA pickle; the CPU
# tests hold this dict against the pickle.
MNIST_G_CONFIG = dict(resolution=32, num_channels=3, latent_size=512, dlatent_size=512,
                      label_size=0, fmap_base=8192, fmap_max=512, architecture="skip",
                      mapping_layers=8, mapping_fmaps=512, truncation_psi=0.6)
MNIST_D_CONFIG = dict(resolution=32, num_channels=3, label_size=0, fmap_base=8192,
                      fmap_max=512, architecture="resnet", mbstd_group_size=8)
# Kernel path against plain path on the card, from the same latents and
# draws, both with PyTorch's deterministic algorithms: with cuDNN's default
# ones the plain path alone moves the latents' gradient by 8.05e-5 relative
# L2 from run to run, which Adam's near-sign first step turns into 1.6e-4 of
# a latent, and PPL's pair lengths by up to 3.2e-3 (1/epsilon^2 = 1e8
# amplifies any difference of a pair's two images). One projector step's
# LPIPS distances |k - p| <= 1e-5 |p|, its latents' gradient within
# relative L2 1e-5, the latents after Adam within 1e-6; PPL's per-pair
# lengths |k - p| <= 1e-3 |p|. The kernels are exact to their plain
# versions, so the paths agree to float32 rounding (0 in the readings).
PROJ_DIST_RTOL = 1e-5
PROJ_GRAD_REL_L2 = 1e-5
PROJ_LATENT_ATOL = 1e-6
PPL_PAIR_RTOL = 1e-3
# The SVM on the card (float32) against the same solver in float64 on the
# card, on the LS fits' own data: predictions agree on at least this share.
SVM_AGREE = 0.999
# pr50k3's k-NN precision and recall on the card against the same function
# on the CPU, within one point in n (|card - cpu| <= 1/n): on the features of
# the run_metrics run, and on a seeded pair of sets whose answer is neither 0
# nor 1 and whose n crosses the estimator's 2048-row and 4096-column blocks
# (PR_SYNTH_N points of rank PR_SYNTH_RANK in 1472 dimensions, the eval set
# shifted by PR_SYNTH_SHIFT: about 0.84 and 0.82).
PR_SYNTH_N, PR_SYNTH_RANK, PR_SYNTH_SHIFT = 4608, 8, 0.5
# the keys of a kernel record that one timing at one shape gives
TIMING_KEYS = ("shape", "config", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
ACT_BITS = os.path.join(HERE, "inclusivegan_torch", "testdata", "activation_bits.npz")


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def phase(name: str) -> None:
    elapsed = time.time() - T0
    if elapsed > DEADLINE_S:
        raise RuntimeError(f"over the {DEADLINE_S} s deadline before {name}")
    log(f"== {name}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def compare_images(np, a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float(np.mean(d > 0))


PHASES = (("g_main", "g_opt"), ("g_reg", "g_opt"), ("d_main", "d_opt"),
          ("d_reg", "d_opt"))
KERNELS = ("bias_lrelu", "bias_lrelu_grad", "upfirdn2d", "upfirdn2d_transposed")


def expected_launches(G, D):
    """Kernel launches of each phase of one iteration, derived from the
    model: M dense layers per mapping call, S lrelu layers in synthesis, FG
    synthesis FIRs (half after the upsampling convs, half upsampling the
    skip path's RGB image), Dl lrelu layers and FD FIRs in the resnet D.
    Each lrelu forward is one bias_lrelu launch, each gradient through one a
    bias_lrelu_grad launch; each FIR forward is one upfirdn2d launch and its
    gradient one upfirdn2d_transposed launch, whose own gradient is an
    upfirdn2d launch again."""
    if G.synthesis.architecture != "skip" or D.architecture != "resnet":
        raise ValueError("launch counts are derived for a skip G and a resnet D")
    M = G.mapping.mapping_layers
    S = G.synthesis.num_layers - 1
    FG = 2 * (G.synthesis.resolution_log2 - 2)
    blocks = D.resolution_log2 - 2
    Dl = 1 + 2 * blocks + 2  # FromRGB, 2 convs per block, 4x4 conv, dense
    FD = 2 * blocks  # the FIR of Conv1_down and of Skip in each block

    def c(bias, grad, fir, fir_t):
        return dict(zip(KERNELS, (bias, grad, fir, fir_t)))

    return {
        # 4 groups of latents mapped with style mixing (8 mapping calls), one
        # synthesis of the 4n images, D on the arbitrary-latent fakes; the
        # backward passes through all of it
        "g_main": c(8 * M + S + Dl, 8 * M + S + Dl, FG + FD, FG + FD),
        # mapping with mixing (2 calls) and synthesis; the inner gradient to
        # the dlatents through synthesis (S, FG); the outer gradient through
        # that inner one (S, and FG / 2 FIRs: on the skip path the inner
        # gradient is the upsampled image noise, a constant) and through the
        # forward (S lrelu, the FG / 2 conv-path FIRs, 2 M mapping layers)
        "g_reg": c(2 * M + S, 3 * S + 2 * M, FG + FG // 2, FG + FG // 2),
        # fakes without a graph (2 mapping calls, synthesis), one D call over
        # fakes and reals, the backward through D
        "d_main": c(2 * M + S + Dl, Dl, FG + FD, FD),
        # D on the reals; the inner gradient to the images; the outer one
        # through the inner (Dl, FD) and through the forward up to the
        # minibatch stddev (Dl - 2: the 4x4 conv and the dense layer come
        # after it, and only the stddev's gradient depends on activations)
        "d_reg": c(Dl, 3 * Dl - 2, 2 * FD, 2 * FD),
    }


def phase_runners(step, batch, draws, g_lrate, d_lrate, gs_beta, rec_weight):
    ph = step.phases
    return {
        "g_main": lambda s: ph["g_step"](s, batch, draws["g"], g_lrate, rec_weight),
        "g_reg": lambda s: ph["g_reg_step"](s, draws["g_reg"], g_lrate),
        "d_main": lambda s: ph["d_step"](s, batch, draws["d"], d_lrate, gs_beta),
        "d_reg": lambda s: ph["d_reg_step"](s, batch, draws["d_reg"], d_lrate),
    }


def rel_l2(torch, a, b) -> float:
    a, b = a.double(), b.double()
    den = b.norm().item()
    return (a - b).norm().item() / den if den > 0 else (a - b).norm().item()


def check_kernel(name, shape, kernel, plain, dtype, tol):
    """Kernel against plain version on fresh random inputs; max abs err."""
    atol, rtol = tol
    yk, yp = kernel(), plain()
    yk, yp = yk.float(), yp.float()
    err = (yk - yp).abs()
    ok = yk.shape == yp.shape and bool((err <= atol + rtol * yp.abs()).all())
    log(f"{name} {str(dtype)[6:]:8s} {shape}: max abs err {err.max().item():.3e} "
        f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version at {shape} {dtype}")
    return err.max().item()


# Every dispatch branch of the upfirdn2d kernel: the tiled kernel at up and
# down 1 and 2, with odd and even widths (4-byte and 16-byte copies),
# negative pads, taps under 4x4, small images packed several to a step with
# a last step that is not full (N*C not a multiple of the images a block
# walks), images wider and taller than one tile; the direct kernel at taps
# over 4x4 and up or down over 2. (input shape, 1-D taps, up, down, pad, gain)
FIR_BRANCHES = (
    ((24, 128, 129, 129), [1, 3, 3, 1], 1, 1, (1, 1, 1, 1), 1.0),
    ((24, 128, 128, 128), [1, 3, 3, 1], 1, 1, (2, 2, 2, 2), 1.0),
    ((600, 3, 64, 64), [1, 3, 3, 1], 2, 1, (2, 1, 2, 1), 4.0),
    ((24, 3, 128, 128), [1, 3, 3, 1], 1, 2, (1, 1, 1, 1), 1.0),
    ((5, 3, 17, 17), [1, 3, 3, 1], 2, 2, (3, 3, 3, 3), 1.0),
    ((7, 3, 33, 31), [1, 3, 3, 1], 1, 1, (2, -1, -2, 1), 1.0),
    ((3, 4, 12, 20), [1, 3, 3, 1], 1, 1, (-3, -3, 1, 1), 1.0),
    ((13, 3, 8, 8), [1, 3, 3, 1], 1, 2, (-1, 2, 1, 1), 1.0),
    ((11, 7, 9, 9), [1, 2, 1], 2, 1, (1, 2, 0, 1), 4.0),
    ((9, 3, 16, 16), [1], 1, 1, (0, 0, 0, 0), 1.0),
    ((37, 5, 17, 17), [1, 3, 3, 1], 1, 1, (2, 2, 2, 2), 1.0),
    ((41, 3, 4, 4), [1, 3, 3, 1], 2, 1, (2, 1, 2, 1), 4.0),
    ((1, 1, 300, 333), [1, 3, 3, 1], 1, 1, (1, 2, 2, 1), 1.0),
    ((2, 2, 200, 400), [1, 3, 3, 1], 2, 1, (2, 1, 2, 1), 4.0),
    ((3, 5, 19, 21), [1, 2, 3, 3, 2, 1], 1, 1, (3, 2, 3, 2), 1.0),
    ((3, 5, 19, 21), [1, 2, 3, 3, 2, 1], 3, 1, (3, 2, 3, 2), 9.0),
    ((3, 5, 40, 44), [1, 3, 3, 1], 1, 3, (1, 1, 1, 1), 1.0),
)


def check_fir_branches(np, torch, ck, gen):
    """The upfirdn2d kernel against its plain version in every dispatch
    branch and dtype, exactly."""
    from inclusivegan_torch.ops import setup_filter, upfirdn2d
    for shape, taps, up, down, pad, gain in FIR_BRANCHES:
        f = setup_filter(taps)
        for dtype in (getattr(torch, d) for d in DTYPES):
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            check_kernel(f"upfirdn2d branch {f.shape[0]}x{f.shape[1]} taps up {up} "
                         f"down {down} pad {pad}", shape,
                         lambda: ck.upfirdn2d(x, f, up, down, pad, gain),
                         lambda: upfirdn2d(x, f, up=up, down=down, pad=pad, gain=gain,
                                           impl="plain"), dtype, TOL[str(dtype)[6:]])


def float64_gradient_norm(torch, state0, lpips, cfg, batch, draws, phase_name, param,
                          g_lrate, d_lrate, gs_beta, device="cuda"):
    """The L2 norm of one parameter's gradient in one phase, from the state
    ``state0``, with everything in float64 on the card through the plain
    path. The networks and the LPIPS trunk compute in float64; the port's
    float32 islands, where the JAX package promotes (``.float()``), go to
    float64 for this one reading, and so do tensors made from Python
    numbers."""
    from inclusivegan_torch.models.stylegan2 import set_compute_dtype
    from inclusivegan_torch.training.train_step import make_train_step

    def to64(v):
        if isinstance(v, dict):
            return {k: to64(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(to64(x) for x in v)
        return v.double() if torch.is_tensor(v) and v.is_floating_point() else v

    state = copy.deepcopy(state0)
    for net in (state.G, state.D, state.Gs):
        net.double()
        set_compute_dtype(net, torch.float64)
    to_float = torch.Tensor.float
    default = torch.get_default_dtype()
    torch.Tensor.float = lambda self, *args, **kwargs: self.double(*args, **kwargs)
    torch.set_default_dtype(torch.float64)
    try:
        step = make_train_step(state.G, state.D, to64(lpips),
                               cfg._replace(lpips_dtype=torch.float64), device=device,
                               impl="plain")
        runs = phase_runners(step, to64(batch), to64(draws), g_lrate, d_lrate, gs_beta,
                             cfg.NN_rec_lpips_weight)
        opt = dict(PHASES)[phase_name]
        for name, _ in PHASES:  # the phases before it, then it
            state, _s = runs[name](state)
            if name == phase_name:
                break
        grad = getattr(state, opt).m[param]
        if grad.dtype != torch.float64:
            raise RuntimeError(f"the float64 run left a {grad.dtype} gradient")
        return grad.norm().item()
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(default)


def training_slice(np, torch, ck, gen):
    """Phases 7-11. Returns the kernel records of the two new kernels, the
    main path's launch counts and the largest float32 error of each kernel."""
    import ast
    from inclusivegan_torch.data.dataset import SyntheticDataset
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    from inclusivegan_torch.ops.bench import (
        F32_OPS_PER_S, HBM_BYTES_PER_S, Recorder, device_ms, fir_ops, print_rows,
        time_configs)
    from inclusivegan_torch.profile_train import synthetic_batch
    from inclusivegan_torch.snapshot import load_networks
    from inclusivegan_torch.training.imle import IMLEOrchestrator
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.train_step import (
        TrainConfig, draw_train_step, make_train_step, unflatten_draws)

    phase(f"7 training slice: record the kernels' shapes of one iteration, "
          f"minibatch {TRAIN_MB}")
    G, D, Gs = load_networks(NETWORK, device="cuda")
    for net in (G, D, Gs):
        net.float()  # float32 weights on both paths (the snapshot is float16)
    state0 = create_train_state(G, D, Gs)
    lpips = load_lpips_params(LPIPS_WEIGHTS, device="cuda")
    cfg = TrainConfig(**TRAIN_CONFIG)
    steps = {impl: make_train_step(G, D, lpips, cfg, device="cuda", impl=impl)
             for impl in ("cuda", "plain")}
    res, zdim = G.synthesis.resolution, G.mapping.latent_size
    log(f"G {res} px {G.synthesis.architecture}, D {D.architecture} mbstd "
        f"{D.mbstd_group_size}, LPIPS {os.path.basename(LPIPS_WEIGHTS)}, {cfg}")
    batch = steps["cuda"].phases["to_device"](
        synthetic_batch(TRAIN_MB, res, zdim, G.mapping.label_size))
    draws = draw_train_step(G, TRAIN_MB, gen, cfg)
    names = ("bias_lrelu", "bias_lrelu_grad", "upfirdn2d")
    state = copy.deepcopy(state0)
    with Recorder(ck, names) as rec:
        runs = phase_runners(steps["cuda"], batch, draws, LRATE, LRATE, GS_BETA,
                             cfg.NN_rec_lpips_weight)
        for name, _ in PHASES:
            state, _s = runs[name](state)
    torch.cuda.synchronize()
    del state
    log("one iteration: " + ", ".join(
        f"{n} {len(rec.calls[n])} calls at {len(rec.unique(n))} shapes" for n in names))

    errs, _ = check_recorded(np, torch, ck, rec, gen, "training iteration",
                             dtypes=[getattr(torch, d) for d in DTYPES])
    with torch.no_grad():
        check_fir_branches(np, torch, ck, gen)

    phase("8 autograd through the kernels against the plain versions")
    shape, (axis, alpha, gain) = max(rec.unique("bias_lrelu"),
                                     key=lambda k: math.prod(k[0]))
    x = torch.randn(shape, device="cuda", generator=gen)
    b = torch.randn(shape[axis], device="cuda", generator=gen)
    w = torch.randn(shape, device="cuda", generator=gen)
    out = {}
    for impl in ("cuda", "plain"):
        xt, bt = x.clone().requires_grad_(), b.clone().requires_grad_()
        y = fused_bias_act(xt, bt, axis=axis, act="lrelu", alpha=alpha, gain=gain,
                           impl=impl)
        gx, gb = torch.autograd.grad((y.square() * w).sum(), (xt, bt),
                                     create_graph=True)
        ggx, ggb = torch.autograd.grad(gx.square().sum() + gb.square().sum(), (xt, bt))
        out[impl] = (gx.detach(), gb.detach(), ggx, ggb)
    for label, a, p in zip(("dx", "db", "d2x", "d2b"), out["cuda"], out["plain"]):
        e = rel_l2(torch, a, p)
        log(f"bias_lrelu {shape} {label}: relative L2 error {e:.3e} "
            f"(limit {AUTOGRAD_REL_L2:g})")
        if not e <= AUTOGRAD_REL_L2:
            raise RuntimeError(f"bias_lrelu {label} through the kernels disagrees")
    largest = {}  # forward configuration -> its largest input shape
    for shape, (f, up, down, pad, gain, counter) in rec.unique("upfirdn2d"):
        key = (f, up, down, pad, gain)
        if counter == "upfirdn2d" and math.prod(shape) > math.prod(largest.get(key, (0,))):
            largest[key] = shape
    for (f, up, down, pad, gain), shape in largest.items():
        f = np.asarray(f, np.float32)
        x = torch.randn(shape, device="cuda", generator=gen)
        y0 = upfirdn2d(x, f, up=up, down=down, pad=pad, gain=gain)
        w = torch.randn(y0.shape, device="cuda", generator=gen)
        out = {}
        for impl in ("cuda", "plain"):
            xt = x.clone().requires_grad_()
            y = upfirdn2d(xt, f, up=up, down=down, pad=pad, gain=gain, impl=impl)
            (gx,) = torch.autograd.grad((y.square() * w).sum(), xt, create_graph=True)
            (ggx,) = torch.autograd.grad(gx.square().sum(), xt)
            out[impl] = (gx.detach(), ggx)
        for label, a, p in zip(("dx", "d2x"), out["cuda"], out["plain"]):
            e = rel_l2(torch, a, p)
            log(f"upfirdn2d {shape} up {up} down {down} pad {pad} {label}: "
                f"relative L2 error {e:.3e} (limit {AUTOGRAD_REL_L2:g})")
            if not e <= AUTOGRAD_REL_L2:
                raise RuntimeError(f"upfirdn2d {label} through the kernel disagrees")
    del x, w, out

    phase("9 main path: IMLE rebuild, next_rec_batch, train_step iteration 0")
    per_phase = expected_launches(G, D)
    state = copy.deepcopy(state0)
    live_G = state.G
    ggen = torch.Generator(device="cuda").manual_seed(7)

    def generate_images(z):
        with torch.no_grad():
            return live_G(torch.as_tensor(z, device="cuda"), generator=ggen)

    train_set = SyntheticDataset(resolution=res, num_images=DATA_SIZE,
                                 label_size=G.mapping.label_size, seed=0)
    rec_set = SyntheticDataset(resolution=res, num_images=DATA_SIZE,
                               label_size=G.mapping.label_size, seed=0)
    with tempfile.TemporaryDirectory() as projector_dir:
        imle = IMLEOrchestrator(data_size=DATA_SIZE, latent_size=zdim,
                                image_dim=3 * res * res, seed=1000,
                                projector_cache_dir=projector_dir,
                                knn_backend="exact", device="cuda", **IMLE_CONFIG)
    n_cand = DATA_SIZE * IMLE_CONFIG["num_samples_factor"]
    torch.cuda.synchronize()
    ck.reset_launches()
    t = time.perf_counter()
    if not imle.needs_rebuild(0, 2 * TRAIN_MB):
        raise RuntimeError("iteration 0 must rebuild the IMLE pool")
    # the FIR's configurations of the main path, timed in phase 11
    with Recorder(ck, ("upfirdn2d",)) as fir_rec:
        imle.rebuild(generate_images, rec_set, verbose=False)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t
        r1, l1, z1, r2, l2, z2 = imle.next_rec_batch(rec_set, TRAIN_MB)
        reals, labels = train_set.get_minibatch_np(2 * TRAIN_MB)
        main_batch = {"reals_rec_1": r1, "labels_rec_1": l1, "latents_rec_1": z1,
                      "reals_rec_2": r2, "labels_rec_2": l2, "latents_rec_2": z2,
                      "reals": reals, "labels": labels}
        state, scalars = steps["cuda"](state, main_batch, ggen, LRATE, LRATE, GS_BETA,
                                       do_g_reg=True, do_d_reg=True)
        torch.cuda.synchronize()
    launches = dict(ck.launches)
    main_s = time.perf_counter() - t
    batches = math.ceil(n_cand / IMLE_CONFIG["candidate_batch_size"])
    M, S = G.mapping.mapping_layers, G.synthesis.num_layers - 1
    expected = {k: sum(p[k] for p in per_phase.values()) for k in KERNELS}
    expected["bias_lrelu"] += batches * (M + S)  # the candidates, eval mode
    expected["upfirdn2d"] += batches * 2 * (G.synthesis.resolution_log2 - 2)
    log(f"IMLE rebuild of {n_cand} candidates: {rebuild_s:.3f} s; mean 1-NN "
        f"distance {imle.selected_dists.mean():.4f}; main path {main_s:.3f} s")
    log("scalars " + ", ".join(f"{k} {v.item():.6g}" for k, v in scalars.items()))
    log(f"launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"main-path launch counts {launches} != {expected}")
    if len(scalars) != 11 or not all(bool(torch.isfinite(v)) for v in scalars.values()):
        raise RuntimeError("missing or non-finite loss scalars")
    if (int(state.step) != 1 or imle.selected_latents.shape != (DATA_SIZE, zdim)
            or not np.isfinite(imle.selected_dists).all()
            or not all(bool(torch.isfinite(p).all()) for net in (state.G, state.D, state.Gs)
                       for p in net.parameters())):
        raise RuntimeError("the iteration left a bad state")
    main_launches = launches
    del state

    runs = {impl: phase_runners(steps[impl], batch, draws, LRATE, LRATE, GS_BETA,
                                cfg.NN_rec_lpips_weight) for impl in steps}
    # Library ops with run-to-run float noise (cuDNN's transposed-conv forward
    # and weight-gradient algorithms may sum with atomics) move gradients that
    # are sums with heavy cancellation, such as a noise strength's, by more
    # than a kernel fault would: shown here by the plain path twice. The
    # comparison below therefore runs PyTorch's deterministic algorithms, on
    # both paths alike.
    twice = [runs["plain"]["g_main"](copy.deepcopy(state0))[0].g_opt.m for _ in range(2)]
    worst = max((rel_l2(torch, twice[0][k], twice[1][k]), k) for k in twice[0])
    log(f"plain path's G main twice, default algorithms: largest relative L2 "
        f"difference {worst[0]:.3e} ({worst[1]})")
    del twice
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    log("phase by phase from one state, one set of draws, deterministic "
        "algorithms: kernels against plain versions")
    cur = copy.deepcopy(state0)
    atol, rtol = TRAIN_SCALAR_TOL
    for name, opt in PHASES:
        before = copy.deepcopy(cur)
        ck.reset_launches()
        cur, sk = runs["cuda"][name](cur)
        torch.cuda.synchronize()
        counts = dict(ck.launches)
        log(f"{name}: launches {counts} (derived {per_phase[name]})")
        if counts != per_phase[name]:
            raise RuntimeError(f"{name} launch counts {counts} != {per_phase[name]}")
        ref, sp = runs["plain"][name](before)
        torch.cuda.synchronize()
        if any(ck.launches[k] != counts[k] for k in KERNELS):
            raise RuntimeError("the plain path launched a kernel")
        for k, v in sp.items():
            kv, pv = sk[k].item(), v.item()
            ok = abs(kv - pv) <= atol + rtol * abs(pv)
            log(f"{name} {k}: kernels {kv:.9g}, plain {pv:.9g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} {k} disagrees")
        m_k, m_p = getattr(cur, opt).m, getattr(ref, opt).m
        worst = max((rel_l2(torch, m_k[k], m_p[k]), k) for k in m_p)
        log(f"{name}: {len(m_p)} gradients, largest relative L2 error "
            f"{worst[0]:.3e} ({worst[1]}; limit {TRAIN_GRAD_REL_L2:g})")
        if not worst[0] <= TRAIN_GRAD_REL_L2:
            raise RuntimeError(f"{name} gradient of {worst[1]} disagrees")
        extra = []
        if name == "g_reg":
            extra.append(("pl_mean", cur.pl_mean, ref.pl_mean))
        if name == "d_main":
            gs_k, gs_p = dict(cur.Gs.state_dict()), dict(ref.Gs.state_dict())
            extra += [(f"Gs {k}", gs_k[k], gs_p[k]) for k in gs_p]
            extra.append(("dlatent_avg", cur.G.dlatent_avg, ref.G.dlatent_avg))
        for label, a, p in extra:
            e = rel_l2(torch, a, p)
            if not e <= TRAIN_GRAD_REL_L2:
                raise RuntimeError(f"{name} {label} disagrees: {e:.3e}")
        if extra:
            log(f"{name}: {len(extra)} of pl_mean / Gs / dlatent_avg agree, "
                f"largest relative L2 error "
                f"{max(rel_l2(torch, a, p) for _, a, p in extra):.3e}")
        del before, ref
    del cur
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)

    phase("10 the card against the JAX golden of one iteration")
    golden = np.load(TRAIN_GOLDEN)
    gcfg = TrainConfig(**ast.literal_eval(str(golden["config"])))
    gstep = make_train_step(G, D, lpips, gcfg, device="cuda", impl="cuda")
    gbatch = gstep.phases["to_device"](
        {k[len("batch/"):]: golden[k] for k in golden.files if k.startswith("batch/")})
    gdraws = unflatten_draws({k[len("draws/"):]: golden[k] for k in golden.files
                              if k.startswith("draws/")}, device="cuda")
    gruns = phase_runners(gstep, gbatch, gdraws, float(golden["g_lrate"]),
                          float(golden["d_lrate"]), float(golden["gs_beta"]),
                          gcfg.NN_rec_lpips_weight)

    def against_golden():
        """Every phase from the golden's state; returns (what, relative
        difference, limit, the card's value) for each loss scalar, gradient
        norm and pl_mean."""
        out = []
        cur = copy.deepcopy(state0)
        for name, opt in PHASES:
            cur, sk = gruns[name](cur)
            for k, v in sk.items():
                ref = float(golden[f"scalar/{name}/{k}"])
                out.append((f"{name} {k}", abs(v.item() - ref) / abs(ref),
                            GOLDEN_SCALAR_RTOL, v.item()))
            prefix = f"grad_norm/{name}/"
            ref = {k[len(prefix):]: float(golden[k]) for k in golden.files
                   if k.startswith(prefix)}
            m = getattr(cur, opt).m
            if set(ref) != set(m):
                raise RuntimeError(f"{name}: parameters differ from the golden's")
            norms = {k: m[k].double().norm().item() for k in ref}
            out += [(f"{name} gradient norm of {k}",
                     abs(norms[k] - ref[k]) / max(ref[k], 1e-30), GOLDEN_NORM_RTOL,
                     norms[k]) for k in ref]
        ref = float(golden["pl_mean"])
        out.append(("pl_mean", abs(cur.pl_mean.item() - ref) / abs(ref),
                    GOLDEN_SCALAR_RTOL, cur.pl_mean.item()))
        return out

    def summary(rows):
        for phase_name, _ in PHASES:
            mine = [r for r in rows if r[0].startswith(phase_name)]
            worst = max(mine, key=lambda r: r[1] / r[2])
            log(f"  {phase_name}: {len(mine)} values, worst {worst[0]}: relative "
                f"difference {worst[1]:.3e} (limit {worst[2]:g}); "
                f"{sum(r[1] > r[2] for r in mine)} over their limit")

    # cuDNN's default float32 algorithms include FFT convolutions, which
    # round coarser than the JAX golden's CPU convolutions; the gradient of
    # a noise strength sums millions of terms with heavy cancellation and
    # moves by up to 0.55% on a mere change of summation order
    # (tests/torch_golden/fir_order_sensitivity.py). Shown, not held:
    log("default cuDNN algorithms (not held to the limits):")
    default_rows = against_golden()
    summary(default_rows)
    # Held: the same iteration with convolutions through PyTorch's own
    # im2col and float32 GEMMs (cuDNN off) and deterministic algorithms.
    torch.backends.cudnn.enabled = False
    torch.use_deterministic_algorithms(True)
    rows = against_golden()
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.enabled = True
    log("convolutions without cuDNN, deterministic algorithms (held):")
    summary(rows)
    for what, diff, limit, _ in rows:
        if not diff <= limit:
            raise RuntimeError(f"{what} disagrees with the JAX golden: relative "
                               f"difference {diff:.3e} over {limit:g}")

    # The gradient norm farthest from the golden under the default algorithms,
    # once more in float64 through the plain path: how far the JAX golden
    # (float32 on the CPU) and the card's float32 results each lie from it.
    what = max((r for r in default_rows if " gradient norm of " in r[0]),
               key=lambda r: r[1])[0]
    name, param = what.split(" gradient norm of ")
    norm64 = float64_gradient_norm(torch, state0, lpips, gcfg, gbatch, gdraws,
                                   name, param, float(golden["g_lrate"]),
                                   float(golden["d_lrate"]), float(golden["gs_beta"]))
    ref = float(golden[f"grad_norm/{name}/{param}"])
    log(f"{what} in float64 on the card (plain path): {norm64:.9g}")
    readings = [("JAX golden, float32 on the CPU", ref)] + [
        (label, next(r[3] for r in rows_ if r[0] == what))
        for label, rows_ in (("the card, float32, default cuDNN", default_rows),
                             ("the card, float32, convolutions without cuDNN", rows))]
    for label, value in readings:
        log(f"  {label}: relative difference from float64 "
            f"{abs(value - norm64) / norm64:.3e}")

    phase("11 times")
    records = []
    with torch.no_grad():
        shape, (alpha, gain) = max(rec.unique("bias_lrelu_grad"),
                                   key=lambda k: math.prod(k[0]))
        y = torch.randn(shape, device="cuda", generator=gen)
        dy = torch.randn(shape, device="cuda", generator=gen)
        ms = device_ms(lambda: ck.bias_lrelu_grad(y, dy, alpha, gain))
        plain_ms = device_ms(lambda: bias_lrelu_grad_plain(y, dy, alpha, gain))
        t_bytes = 3 * y.numel() * y.element_size() / HBM_BYTES_PER_S
        t_ops = 2 * y.numel() / F32_OPS_PER_S  # a select and a multiply
        records.append(dict(
            name="bias_lrelu_grad", route="cuda",
            source="inclusivegan_torch/ops/csrc/bias_act.cu",
            replaces="inclusivegan_tpu/ops/pallas_kernels.py:113",
            launches=main_launches["bias_lrelu_grad"],
            max_abs_err=errs["bias_lrelu_grad"], ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, shape=list(shape)))
        del y, dy

        shape, (f, up, down, pad, gain, _c) = max(
            (k for k in rec.unique("upfirdn2d") if k[1][5] == "upfirdn2d_transposed"),
            key=lambda k: math.prod(k[0]))
        f = np.asarray(f, np.float32)
        x = torch.randn(shape, device="cuda", generator=gen)
        kern = lambda: ck.upfirdn2d(x, f, up, down, pad, gain,  # noqa: E731
                                    counter="upfirdn2d_transposed")
        ms = device_ms(kern)
        plain_ms = device_ms(lambda: upfirdn2d(x, f, up=up, down=down, pad=pad,
                                                      gain=gain, impl="plain"))
        y = kern()
        library_ms = None
        if up == 1 and len(set(pad)) == 1 and pad[0] >= 0:
            c = shape[1]
            wt = torch.from_numpy(np.ascontiguousarray((f * gain)[::-1, ::-1]))
            wt = wt.to("cuda")[None, None].repeat(c, 1, 1, 1)
            lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
                x, wt, stride=down, padding=pad[0], groups=c)
            lib_err = (lib() - y).abs().max().item()
            log(f"depthwise conv2d vs transposed FIR: max abs err {lib_err:.3e}")
            if lib_err > 1e-4:
                raise RuntimeError("depthwise conv2d does not compute the FIR")
            library_ms = device_ms(lib)
        t_bytes = (x.numel() + y.numel()) * x.element_size() / HBM_BYTES_PER_S
        t_ops = fir_ops(shape, f, up, down, pad) / F32_OPS_PER_S
        records.append(dict(
            name="upfirdn2d_transposed", route="cuda",
            source="inclusivegan_torch/ops/csrc/upfirdn2d.cu",
            replaces="inclusivegan_tpu/ops/pallas_kernels.py:251",
            launches=main_launches["upfirdn2d_transposed"],
            max_abs_err=errs["upfirdn2d_transposed"], ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, shape=list(shape),
            config=dict(up=up, down=down, pad=list(pad), gain=gain)))
        del x, y
    log(f"upfirdn2d at every configuration of the main path (IMLE rebuild and "
        f"iteration 0, {len(fir_rec.calls['upfirdn2d'])} launches):")
    if len(fir_rec.calls["upfirdn2d"]) != (main_launches["upfirdn2d"]
                                           + main_launches["upfirdn2d_transposed"]):
        raise RuntimeError("the recorded FIR calls do not match the launch counts")
    print_rows(time_configs(ck, fir_rec.calls["upfirdn2d"], gen, log=log), log=log)
    for r in records:
        log(f"{r['name']} at {tuple(r['shape'])}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")

    # seconds per phase on the host clock, kernels and plain versions in
    # turns (plain, cuda, cuda, plain, ...), with and without the lazy
    # regularizers; each path keeps its own state
    tstates = {impl: copy.deepcopy(state0) for impl in steps}
    secs = {(impl, regs): {n: [] for n, _ in PHASES} for impl in steps
            for regs in (True, False)}

    def iteration(impl, regs, keep=True):
        for name, _ in PHASES:
            if not regs and name in ("g_reg", "d_reg"):
                continue
            torch.cuda.synchronize()
            t = time.perf_counter()
            tstates[impl], _s = runs[impl][name](tstates[impl])
            torch.cuda.synchronize()
            if keep:
                secs[(impl, regs)][name].append(time.perf_counter() - t)

    for impl in steps:
        iteration(impl, True, keep=False)  # warm-up
    for regs, reps in ((True, 4), (False, 4)):
        for i in range(reps):
            for impl in (("plain", "cuda") if i % 2 == 0 else ("cuda", "plain")):
                iteration(impl, regs)
    for (impl, regs), by_phase in secs.items():
        med = {n: statistics.median(v) for n, v in by_phase.items() if v}
        log(f"iteration {'with' if regs else 'without'} the regularizers, "
            f"minibatch {TRAIN_MB}, impl={impl}: {sum(med.values()):.4f} s = "
            + " + ".join(f"{n} {v:.4f}" for n, v in med.items())
            + " (medians of 4)")
    del tstates
    torch.cuda.synchronize()
    t = time.perf_counter()
    imle.rebuild(generate_images, rec_set, verbose=False)
    torch.cuda.synchronize()
    log(f"IMLE rebuild of {n_cand} candidates: {time.perf_counter() - t:.4f} s "
        f"(the first, in phase 9: {rebuild_s:.4f} s)")
    return records, main_launches, errs


def write_loop_dataset(np, data_dir, res, num=DATA_SIZE):
    """``num`` seeded uint8 images at ``res`` px with LOOP_LABELS binary
    attributes, written by the port's exporter as LOOP_DATASET (the first
    DATA_SIZE are the same for every ``num``)."""
    from inclusivegan_torch.data.dataset_tool import TFRecordExporter
    rng = np.random.default_rng(12)
    with TFRecordExporter(os.path.join(data_dir, LOOP_DATASET), num,
                          print_progress=False) as tfr:
        for _ in range(num):
            tfr.add_image(rng.integers(0, 256, (3, res, res), dtype=np.uint8))
        tfr.add_labels(rng.integers(0, 2, (num, LOOP_LABELS)).astype(np.float32))
    return sorted(os.listdir(os.path.join(data_dir, LOOP_DATASET)))


def read_stats(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def loop_kwargs(data_dir, result_dir, extra_flags, flags=CLI_FLAGS):
    """The loop's keyword arguments as the command line builds them
    (``run_training.parse_args`` and ``run``), without submitting."""
    from inclusivegan_torch import run_training
    seen = {}
    argv = ["--data-dir", data_dir, "--dataset", LOOP_DATASET, "--result-dir",
            result_dir] + flags + extra_flags
    with mock.patch.object(run_training, "submit_run",
                           lambda sc, fn, **kw: seen.update(sc=sc, fn=fn, kw=kw)):
        run_training.run(**run_training.parse_args(argv))
    return seen["sc"], seen["fn"], seen["kw"]


def run_loop(torch, ck, sc, fn, kw):
    """One in-process run of the loop through ``submit_run``, its launch
    counts set to 0 just before and read just after. The loop times its
    ticks, rebuilds, snapshots and checkpoints itself (``Timing/*`` in
    stats.jsonl); two hooks add the time of each ``train_step`` call and,
    around each IMLE rebuild, the (cursor, staleness) it starts from, the
    card's peak allocation before and after, and the arguments of its kernel
    launches. Returns (state, run dir, launches, seconds from the start to
    the first and to the last step, the rebuilds' counters, their
    recorders)."""
    from inclusivegan_torch.ops.bench import Recorder
    from inclusivegan_torch.training import training_loop as tloop
    from inclusivegan_torch.utils.run_harness import submit_run
    step_times = []
    rebuild_from, rebuild_peaks, rebuild_recs = [], [], []
    make_step = tloop.make_train_step

    def make_timed_step(*a, **k):
        step = make_step(*a, **k)

        def call(*sa, **sk):
            step_times.append(time.perf_counter())
            return step(*sa, **sk)
        return call

    class Recording(tloop.IMLEOrchestrator):
        def rebuild(self, *a, **k):
            rebuild_from.append((self.cursor, self.staleness))
            torch.cuda.synchronize()
            peak_before = torch.cuda.max_memory_allocated()
            with Recorder(ck) as rec:
                super().rebuild(*a, **k)
            torch.cuda.synchronize()
            rebuild_recs.append(rec)
            rebuild_peaks.append((peak_before, torch.cuda.max_memory_allocated()))

    with mock.patch.object(tloop, "IMLEOrchestrator", Recording), \
            mock.patch.object(tloop, "make_train_step", make_timed_step):
        torch.cuda.synchronize()
        ck.reset_launches()
        t_start = time.perf_counter()
        # the run's own output goes to its log.txt; its tick lines are shown
        with contextlib.redirect_stdout(io.StringIO()):
            state = submit_run(sc, fn, **kw)
        torch.cuda.synchronize()
        launches = dict(ck.launches)
    (run_dir,) = [os.path.join(sc.run_dir_root, d) for d in os.listdir(sc.run_dir_root)]
    with open(os.path.join(run_dir, "log.txt")) as f:
        for line in f:
            if line.startswith("tick "):
                log(line.rstrip())
    log("peak allocated before and after each rebuild: " + ", ".join(
        f"{a / 2 ** 30:.3f} -> {b / 2 ** 30:.3f} GB" for a, b in rebuild_peaks)
        + f"; at the end of the run {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GB")
    steps = (step_times[0] - t_start, step_times[-1] - t_start)
    return state, run_dir, launches, steps, rebuild_from, rebuild_recs


# The plain versions of the rebuild's kernel launches run this many images
# at a time (below).
REBUILD_CHECK_CHUNK = 128


def check_rebuild_kernels(np, torch, ck, recs):
    """Every configuration that the loop's IMLE rebuilds launched the forward
    kernels with, in the dtype they gave it: the candidates padded to the
    candidate batch of 1024, as the loop pads them, so that at 128 px a
    tensor holds more than 2**31 elements. Kernel against plain version on
    the same card inputs, exactly. The kernel takes the whole batch; the
    plain version, which computes each image on its own, takes
    REBUILD_CHECK_CHUNK images at a time, since its intermediates for the
    whole batch would not fit beside the kernel's. Returns the largest
    float32 error of each kernel."""
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    gen = torch.Generator("cuda").manual_seed(21)
    bs = IMLE_CONFIG["candidate_batch_size"]
    errs = {"bias_lrelu": 0.0, "upfirdn2d": 0.0}
    n_configs = n_large = 0
    for name in errs:
        configs = list(dict.fromkeys(c for r in recs for c in r.calls[name]))
        dtypes = sorted({d for r in recs for d in r.dtypes[name]}, key=str)
        for (shape, key), dtype in ((c, d) for c in configs for d in dtypes):
            if shape[0] != bs:
                raise RuntimeError(f"the rebuild launched {name} at {shape}, not at "
                                   f"its candidate batch of {bs}")
            x = torch.randn(shape, device="cuda", generator=gen, dtype=dtype)
            with torch.no_grad():
                if name == "bias_lrelu":
                    axis, alpha, gain = key
                    if axis == 0:
                        raise RuntimeError("a bias along the batch cannot be chunked")
                    b = torch.randn(shape[axis], device="cuda", generator=gen,
                                    dtype=dtype)
                    what = f"bias_lrelu axis {axis}"
                    yk = ck.bias_lrelu(x, b, axis, alpha, gain)
                else:
                    f, up, down, pad, gain = key[:5]
                    f = np.asarray(f, np.float32)
                    what = f"upfirdn2d up {up} down {down} pad {pad}"
                    yk = ck.upfirdn2d(x, f, up, down, pad, gain)
                err = 0.0
                for i in range(0, bs, REBUILD_CHECK_CHUNK):
                    xs = x[i:i + REBUILD_CHECK_CHUNK]
                    if name == "bias_lrelu":
                        yp = fused_bias_act(xs, b, axis=axis, act="lrelu", alpha=alpha,
                                            gain=gain, impl="plain")
                    else:
                        yp = upfirdn2d(xs, f, up=up, down=down, pad=pad, gain=gain,
                                       impl="plain")
                    yc = yk[i:i + REBUILD_CHECK_CHUNK]
                    if yp.shape != yc.shape or yp.dtype != yc.dtype:
                        raise RuntimeError(f"{what} at {shape}: kernel {yc.shape} "
                                           f"{yc.dtype}, plain {yp.shape} {yp.dtype}")
                    if not torch.equal(yc, yp):
                        err = max(err, (yc.float() - yp.float()).abs().max().item())
                    del yp, yc
            n = math.prod(shape)
            n_configs += 1
            n_large += n >= 2 ** 31
            log(f"rebuild {what} {str(dtype)[6:]} {shape} ({n} elements): max abs err "
                f"{err:.3e} (exact) {'ok' if err == 0 else 'FAIL'}")
            if err != 0:
                raise RuntimeError(f"{what} disagrees with its plain version at {shape}")
            if dtype == torch.float32:
                errs[name] = max(errs[name], err)
            del x, yk
    log(f"the rebuild's {n_configs} kernel configurations agree exactly with the plain "
        f"versions, {n_large} of them over 2**31 elements")
    if n_large == 0:
        raise RuntimeError("the rebuild launched no kernel over 2**31 elements")
    torch.cuda.empty_cache()
    return errs


def training_loop_phase(np, torch, ck):
    """Phase 12. Returns the kernels' launch counts of the loop's main path
    (the first resumed run through submit_run) and the largest float32
    error of each forward kernel at its rebuild's configurations."""
    from inclusivegan_torch.snapshot import read_snapshot
    from inclusivegan_torch.training.checkpoint import STATE_FILE, latest_checkpoint

    phase("12 the training loop: the CLI from scratch, resume from the CelebA "
          "snapshot (twice), resume from a checkpoint")
    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = 128
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        data_dir = os.path.join(tmp, "data")
        t = time.time()
        files = write_loop_dataset(np, data_dir, res)
        log(f"wrote {DATA_SIZE} images at {res} px with {LOOP_LABELS} labels in "
            f"{time.time() - t:.1f} s: {files}")

        # 12.1 the command line, from scratch (fresh init at full width)
        cli_root = os.path.join(tmp, "cli")
        argv = [sys.executable, "-m", "inclusivegan_torch.run_training",
                "--data-dir", data_dir, "--dataset", LOOP_DATASET, "--result-dir",
                cli_root] + CLI_FLAGS + ["--smoke-test-max-iters", str(CLI_ITERS)]
        log("$ " + " ".join(os.path.relpath(a, HERE) if a.startswith(HERE) else a
                            for a in argv[1:]))
        t = time.time()
        proc = subprocess.run(argv, cwd=HERE, capture_output=True, text=True,
                              timeout=LOOP_BUDGET_S)
        cli_s = time.time() - t
        tail = (proc.stdout + proc.stderr)[-3000:]
        if proc.returncode != 0:
            print(tail, flush=True)
            raise RuntimeError(f"run_training exited {proc.returncode}")
        (cli_run,) = [os.path.join(cli_root, d) for d in os.listdir(cli_root)]
        stats = read_stats(os.path.join(cli_run, "stats.jsonl"))
        losses = {k: v for rec in stats for k, v in rec.items() if k.startswith("Loss/")}
        log(f"CLI from scratch, {CLI_ITERS} iterations: exit 0 in {cli_s:.1f} s; "
            + ", ".join(f"{k[5:]} {v:.5g}" for k, v in sorted(losses.items())))
        if len(losses) != 11 or not all(math.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"the CLI run's loss scalars: {losses}")
        for name in ("network-final.pkl", "arb-reals.png", "log.txt", "_finished.txt"):
            if not os.path.isfile(os.path.join(cli_run, name)):
                raise RuntimeError(f"the CLI run wrote no {name}")
        g = read_snapshot(os.path.join(cli_run, "network-final.pkl"))["G"]
        log(f"CLI run dir {os.path.basename(cli_run)}: G "
            f"{g['config']['synthesis']['resolution']} px, "
            f"{sum(v.size for v in _leaves(g['params']))} G values "
            f"({next(iter(_leaves(g['params']))).dtype})")
        del g

        # 12.2 resume from the CelebA snapshot at its stored float16, through
        # submit_run with the loop arguments the command line builds; twice
        runs = []
        for rep in range(2):
            sc, fn, kw = loop_kwargs(
                data_dir, os.path.join(tmp, f"resume{rep}"),
                ["--resume-pkl", NETWORK, "--init-staleness", str(LOOP_INIT_STALENESS),
                 "--image-snapshot-ticks", "1", "--network-snapshot-ticks", "2"])
            kw = dict(kw, total_kimg=LOOP_TOTAL_KIMG,
                      sched_args=dict(kw["sched_args"], tick_kimg_base=LOOP_TICK_KIMG))
            t = time.time()
            state, run_dir, launches, steps, rebuild_from, recs = run_loop(torch, ck,
                                                                           sc, fn, kw)
            wall = time.time() - t
            runs.append(run_dir)
            check_resumed_run(torch, state, run_dir, launches, rebuild_from)
            report_run(f"resume run {rep + 1}", run_dir, wall, steps, launches,
                       len(rebuild_from))
            del state
            gc.collect()
            torch.cuda.empty_cache()
            if rep == 0:
                loop_launches = launches
                loop_errs = check_rebuild_kernels(np, torch, ck, recs)
            del recs

        # 12.3 resume from run 2's last checkpoint for LOOP_RESUME_ITERS iterations
        ck_dir = latest_checkpoint(os.path.join(runs[-1], "checkpoints"))
        saved = torch.load(os.path.join(ck_dir, STATE_FILE), weights_only=True)
        sc, fn, kw = loop_kwargs(data_dir, os.path.join(tmp, "ckpt"),
                                 ["--resume-checkpoint", runs[-1],
                                  "--image-snapshot-ticks", "1",
                                  "--network-snapshot-ticks", "2"])
        kw = dict(kw, total_kimg=LOOP_TOTAL_KIMG + LOOP_RESUME_ITERS * TRAIN_MB / 1000,
                  sched_args=dict(kw["sched_args"], tick_kimg_base=LOOP_TICK_KIMG))
        t = time.time()
        state, run_dir, launches, steps, rebuild_from, _recs = run_loop(torch, ck, sc,
                                                                        fn, kw)
        wall = time.time() - t
        ck_step, ck_count = int(saved["state"]["step"]), int(saved["state"]["g_opt"]["count"])
        g_regs = len(range(0, LOOP_RESUME_ITERS, TRAIN_CONFIG["G_reg_interval"]))
        got = (int(state.step), int(state.g_opt.count), rebuild_from[0])
        want = (ck_step + LOOP_RESUME_ITERS, ck_count + LOOP_RESUME_ITERS + g_regs,
                (saved["imle"]["cursor"], saved["imle"]["staleness"]))
        log(f"resume from {os.path.relpath(ck_dir, tmp)}: step, g_opt.count and the "
            f"IMLE (cursor, staleness) at the first rebuild {got}, expected {want}")
        if got != want:
            raise RuntimeError("the checkpoint resume did not go on from the checkpoint")
        report_run("checkpoint resume", run_dir, wall, steps, launches,
                   len(rebuild_from))
        del state
        log(f"device memory: peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GB, peak reserved "
            f"{torch.cuda.max_memory_reserved() / 2 ** 30:.3f} GB (phase 12, this process)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loop_s = time.time() - t_phase
    log(f"phase 12 took {loop_s:.1f} s (budget {LOOP_BUDGET_S} s)")
    if loop_s >= LOOP_BUDGET_S:
        raise RuntimeError(f"phase 12 took {loop_s:.1f} s, over its {LOOP_BUDGET_S} s "
                           "budget")
    return loop_launches, loop_errs


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_resumed_run(torch, state, run_dir, launches, rebuild_from):
    """The resumed run's kernels, files, staleness, dtypes and snapshot."""
    from inclusivegan_torch.snapshot import load_snapshot, read_snapshot
    from inclusivegan_torch.training.train_state import g_trainables, params_of
    log(f"launches during the loop {launches}")
    if not all(launches[k] > 0 for k in KERNELS):
        raise RuntimeError(f"a kernel was not launched in the loop: {launches}")
    n_iters = round(LOOP_TOTAL_KIMG * 1000 / TRAIN_MB)
    expected = {"log.txt", "run.txt", "submit_config.pkl", "submit_config.txt",
                "_finished.txt", "stats.jsonl", "arb-reals.png", "rec-reals.png",
                "arb-fakes-000000.png", "rec-fakes-000000.png",
                "network-snapshot-000000.pkl", "network-final.pkl", "checkpoints",
                f"random_projector_mat_{3 * 128 * 128}to512.npy"}
    names = set(os.listdir(run_dir))
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    n_ticks = round(LOOP_TOTAL_KIMG / LOOP_TICK_KIMG)
    want_ckpts = [f"step_{int(round(t * LOOP_TICK_KIMG * 1000)):08d}"
                  for t in range(1, n_ticks + 1) if (t - 1) % 2 == 0 or t == n_ticks]
    if not expected <= names or not any(n.startswith("events.out") for n in names) \
            or ckpts != want_ckpts:
        raise RuntimeError(f"run dir: missing {sorted(expected - names)}, checkpoints "
                           f"{ckpts} (expected {want_ckpts})")
    if int(state.step) != n_iters:
        raise RuntimeError(f"{int(state.step)} steps, expected {n_iters}")
    if [s for _, s in rebuild_from] != [LOOP_INIT_STALENESS, LOOP_INIT_STALENESS]:
        raise RuntimeError(f"rebuilds started from (cursor, staleness) {rebuild_from}")
    # G and D keep the snapshot's float16; the Gs EMA is float32, as in JAX
    dtypes = {str(v.dtype) for v in g_trainables(params_of(state.G)).values()} | {
        str(p.dtype) for p in state.D.parameters()}
    final = os.path.join(run_dir, "network-final.pkl")
    snap = read_snapshot(final)
    trainable = {k: v for k, v in snap["G"]["params"].items()
                 if k not in ("noise", "dlatent_avg")}
    stored = {str(v.dtype) for tree in (trainable, snap["D"]["params"])
              for v in _leaves(tree)}
    log(f"after {n_iters} iterations: G and D trainables {dtypes}, in network-final.pkl "
        f"{stored}; rebuilds from (cursor, staleness) {rebuild_from}")
    if dtypes != {"torch.float16"} or stored != {"float16"}:
        raise RuntimeError("G or D left float16")
    # network-final.pkl's Gs, read back by the port, draws the in-memory Gs's
    # images exactly, under deterministic algorithms (cuDNN's transposed
    # convolution may otherwise sum in another order from call to call)
    Gs = load_snapshot(final, device="cuda")
    z = torch.randn(4, Gs.mapping.latent_size, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    with deterministic(torch), torch.no_grad():
        a = state.Gs(z, randomize_noise=False)
        b = Gs(z, randomize_noise=False)
    diff = (a - b).abs().max().item()
    log(f"network-final.pkl's Gs against the in-memory Gs, 4 images: max |diff| {diff}")
    if not torch.equal(a, b):
        raise RuntimeError("network-final.pkl does not hold the trained Gs")


def report_run(label, run_dir, wall, steps, launches, n_rebuilds, n_metric_runs=0):
    """sec/kimg and kimg/h per tick, as the loop reads them; then the
    iterations alone: the ticks' seconds (the card synchronized at the end of
    each) less the rebuilds, image and network snapshots and checkpoints that
    ran inside them, over the ticks' images."""
    stats = read_stats(os.path.join(run_dir, "stats.jsonl"))
    ticks = [r for r in stats if "Timing/sec_per_tick" in r]
    n_ckpts = len(os.listdir(os.path.join(run_dir, "checkpoints")))
    # Each event reports its seconds into the first flush after it, which
    # falls in the tick it ran in; a flush keeps the mean of its events, so
    # the sums below hold only with one event of a kind per flush. Phase 12
    # snapshots images every tick and networks with each checkpoint.
    n_events = {"dci_rebuild": n_rebuilds, "image_snapshot": len(ticks),
                "snapshot": n_ckpts, "checkpoint": n_ckpts}
    if n_metric_runs:
        n_events["metrics"] = n_metric_runs
    for kind, n in n_events.items():
        got = sum(f"Timing/{kind}_sec" in r for r in stats)
        if got != n:
            raise RuntimeError(f"{label}: Timing/{kind}_sec in {got} flushes of "
                               f"stats.jsonl, for {n} events")
    net_s = images = 0
    for r in ticks:
        spt, spk = r["Timing/sec_per_tick"], r["Timing/sec_per_kimg"]
        n_img = round(1000 * spt / spk)
        inside = {kind: r[f"Timing/{kind}_sec"] for kind in n_events
                  if f"Timing/{kind}_sec" in r}
        net = spt - sum(inside.values())
        net_s += net
        images += n_img
        log(f"{label} tick at {r['_step']} images: {spk:.2f} sec/kimg = "
            f"{3600 / spk:.2f} kimg/h ({spt:.3f} s for {n_img} images; in it "
            + ", ".join(f"{k} {v:.3f} s" for k, v in inside.items())
            + f"; without them {1000 * net / n_img:.2f} sec/kimg); peak allocated "
            f"{r.get('Resources/peak_device_mem_gb', float('nan')):.3f} GB")
    iters = images / TRAIN_MB
    log(f"{label}: the iterations alone, {images} images in {iters:.0f} iterations "
        f"in {net_s:.3f} s of ticks: {net_s / iters:.4f} s per iteration, "
        f"{1000 * net_s / images:.2f} sec/kimg = {3.6 * images / net_s:.2f} kimg/h")
    for kind in n_events:
        key = f"Timing/{kind}_sec"
        log(f"{label}: {key} " + ", ".join(f"{r[key]:.3f}" for r in stats if key in r))
    log(f"{label}: {wall:.1f} s in all, {steps[0]:.1f} s of it before the first step "
        f"(networks, LPIPS, grids, the first rebuild) and {steps[1] - steps[0]:.1f} s "
        f"from the first step to the last, host clock; launches {launches}")


def check_recorded(np, torch, ck, rec, gen, label, dtypes=None):
    """Each kernel at every distinct (shape, arguments, dtype) that ``rec``
    saw, against its plain version on fresh random inputs of that dtype, or
    of each of ``dtypes`` where given, exactly. Returns the largest error of
    each counter and the number of configurations."""
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    errs = dict.fromkeys(KERNELS, 0.0)
    n = 0

    def each(name):
        if name not in rec.calls:
            return []
        if dtypes is None:
            return rec.unique_typed(name)
        return [(shape, key, d) for shape, key in rec.unique(name) for d in dtypes]
    with torch.no_grad():
        for shape, (axis, alpha, gain), dtype in each("bias_lrelu"):
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            b = torch.randn(shape[axis], device="cuda", generator=gen).to(dtype)
            e = check_kernel(f"{label} bias_lrelu", shape,
                             lambda: ck.bias_lrelu(x, b, axis, alpha, gain),
                             lambda: fused_bias_act(x, b, axis=axis, act="lrelu",
                                                    alpha=alpha, gain=gain, impl="plain"),
                             dtype, TOL[str(dtype)[6:]])
            errs["bias_lrelu"] = max(errs["bias_lrelu"], e)
            n += 1
        for shape, (alpha, gain), dtype in each("bias_lrelu_grad"):
            y = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            e = check_kernel(f"{label} bias_lrelu_grad", shape,
                             lambda: ck.bias_lrelu_grad(y, dy, alpha, gain),
                             lambda: bias_lrelu_grad_plain(y, dy, alpha, gain),
                             dtype, TOL[str(dtype)[6:]])
            errs["bias_lrelu_grad"] = max(errs["bias_lrelu_grad"], e)
            n += 1
        for shape, (f, up, down, pad, gain, counter), dtype in each("upfirdn2d"):
            f = np.asarray(f, np.float32)
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            e = check_kernel(f"{label} {counter} up {up} down {down} pad {pad}", shape,
                             lambda: ck.upfirdn2d(x, f, up, down, pad, gain),
                             lambda: upfirdn2d(x, f, up=up, down=down, pad=pad, gain=gain,
                                               impl="plain"),
                             dtype, TOL[str(dtype)[6:]])
            errs[counter] = max(errs[counter], e)
            n += 1
    return errs, n


def bf16_kernel_times(np, torch, ck, iter_rec, rebuild_recs, gen, launches):
    """Each kernel in bfloat16 at the largest shape the bf16 loop launched
    it with (iteration and rebuild), beside its plain version, its bound in
    bf16 bytes and a library call: one record per kernel."""
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.ops.bench import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                              depthwise_library_call, device_ms,
                                              fir_bound)
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    bf16 = torch.bfloat16

    def largest(name, counter=None):
        calls = [(shape, key) for r in [iter_rec] + list(rebuild_recs) if name in r.calls
                 for (shape, key, dtype) in r.unique_typed(name)
                 if dtype == bf16 and (counter is None or key[5] == counter)]
        return max(calls, key=lambda c: math.prod(c[0]))

    out = {}
    with torch.no_grad():
        shape, (axis, alpha, gain) = largest("bias_lrelu")
        x = torch.randn(shape, device="cuda", generator=gen, dtype=bf16)
        b = torch.randn(shape[axis], device="cuda", generator=gen, dtype=bf16)
        t_bytes = (2 * x.numel() + b.numel()) * 2 / HBM_BYTES_PER_S
        t_ops = 3 * x.numel() / F32_OPS_PER_S
        out["bias_lrelu"] = dict(
            shape=list(shape), ms=device_ms(lambda: ck.bias_lrelu(x, b, axis, alpha, gain)),
            plain_ms=device_ms(lambda: fused_bias_act(x, b, axis=axis, act="lrelu",
                                                      alpha=alpha, gain=gain,
                                                      impl="plain")),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
        del x, b
        shape, (alpha, gain) = largest("bias_lrelu_grad")
        y = torch.randn(shape, device="cuda", generator=gen, dtype=bf16)
        dy = torch.randn(shape, device="cuda", generator=gen, dtype=bf16)
        t_bytes = 3 * y.numel() * 2 / HBM_BYTES_PER_S
        t_ops = 2 * y.numel() / F32_OPS_PER_S
        out["bias_lrelu_grad"] = dict(
            shape=list(shape), ms=device_ms(lambda: ck.bias_lrelu_grad(y, dy, alpha, gain)),
            plain_ms=device_ms(lambda: bias_lrelu_grad_plain(y, dy, alpha, gain)),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
        del y, dy
        for counter in ("upfirdn2d", "upfirdn2d_transposed"):
            shape, (f, up, down, pad, gain, _c) = largest("upfirdn2d", counter)
            f = np.asarray(f, np.float32)
            x = torch.randn(shape, device="cuda", generator=gen, dtype=bf16)
            bound_ms, bound_by = fir_bound(shape, f, up, down, pad, 2)
            lib = depthwise_library_call(x, f, up, down, pad, gain)
            out[counter] = dict(
                shape=list(shape), config=dict(up=up, down=down, pad=list(pad), gain=gain),
                ms=device_ms(lambda: ck.upfirdn2d(x, f, up, down, pad, gain,
                                                  counter=counter)),
                plain_ms=device_ms(lambda: upfirdn2d(x, f, up=up, down=down, pad=pad,
                                                     gain=gain, impl="plain")),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=device_ms(lib) if lib is not None else None)
            del x
    for name, r in out.items():
        r["launches"] = launches[name]
        log(f"bf16 {name} at {tuple(r['shape'])}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it), library {r['library_ms']}; "
            f"{r['launches']} launches in the bf16 loop")
    torch.cuda.empty_cache()
    return out


def fresh_nets(torch, dtype, seed=3):
    """config-e-Gskip-Dresnet at 128 px, fresh from ``seed``, computing in
    ``dtype``: the networks of a fresh run_training.py at that --dtype."""
    from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
    G = GMain.create(resolution=128, num_channels=3, fmap_base=8 << 10,
                     architecture="skip", dtype=dtype)
    D = Discriminator(resolution=128, num_channels=3, fmap_base=8 << 10,
                      architecture="resnet", dtype=dtype)
    gen = torch.Generator("cuda").manual_seed(seed)
    return G.to("cuda"), D.to("cuda"), gen


def bf16_golden_checks(np, torch, ck, gen):
    """Phase 13.1-13.2: the bf16 iteration against the JAX bf16 golden and
    the kernel path against the plain path, with every kernel configuration
    of it held exactly. Returns the largest error of each kernel."""
    import ast
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.models.stylegan2 import set_compute_dtype
    from inclusivegan_torch.ops.bench import Recorder
    from inclusivegan_torch.snapshot import load_networks
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.train_step import (
        TrainConfig, make_train_step, unflatten_draws)

    lpips = load_lpips_params(LPIPS_WEIGHTS, device="cuda")
    golden = np.load(BF16_GOLDEN)
    if str(golden["dtype"]) != "bfloat16":
        raise RuntimeError(f"{BF16_GOLDEN} holds a {golden['dtype']} iteration")
    G, D, Gs = load_networks(NETWORK, device="cuda")
    for net in (G, D, Gs):
        net.float()  # float32 weights, as the golden's writer casts them
        set_compute_dtype(net, "bfloat16")
    state0 = create_train_state(G, D, Gs)
    cfg = TrainConfig(**ast.literal_eval(str(golden["config"])))
    steps = {impl: make_train_step(G, D, lpips, cfg, device="cuda", impl=impl)
             for impl in ("cuda", "plain")}
    batch = steps["cuda"].phases["to_device"](
        {k[len("batch/"):]: golden[k] for k in golden.files if k.startswith("batch/")})
    draws = unflatten_draws({k[len("draws/"):]: golden[k] for k in golden.files
                             if k.startswith("draws/")}, device="cuda")
    runs = {impl: phase_runners(steps[impl], batch, draws, float(golden["g_lrate"]),
                                float(golden["d_lrate"]), float(golden["gs_beta"]),
                                cfg.NN_rec_lpips_weight) for impl in steps}
    log(f"bf16: G {G.synthesis.dtype}, D {D.dtype}, {cfg}")
    states = {impl: copy.deepcopy(state0) for impl in steps}
    # the recorder sees the kernel path's launches: the plain path makes none
    with Recorder(ck, ("bias_lrelu", "bias_lrelu_grad", "upfirdn2d")) as rec:
        for name, opt in PHASES:
            states["cuda"], sk = runs["cuda"][name](states["cuda"])
            states["plain"], sp = runs["plain"][name](states["plain"])
            for k, v in sk.items():
                ref = float(golden[f"scalar/{name}/{k}"])
                for label, got in (("card, kernels", v.item()), ("card, plain", sp[k].item())):
                    d = abs(got - ref) / abs(ref)
                    log(f"bf16 {name} {k}: {label} {got:.6g}, JAX golden {ref:.6g}, "
                        f"relative difference {d:.3e} (limit {BF16_SCALAR_RTOL:g})")
                    if not d <= BF16_SCALAR_RTOL:
                        raise RuntimeError(f"bf16 {name} {k} disagrees with the JAX golden")
            prefix = f"grad_norm/{name}/"
            ref = {k[len(prefix):]: float(golden[k]) for k in golden.files
                   if k.startswith(prefix)}
            mk, mp = getattr(states["cuda"], opt).m, getattr(states["plain"], opt).m
            if set(ref) != set(mk):
                raise RuntimeError(f"{name}: parameters differ from the bf16 golden's")
            names = sorted(ref)
            jax16 = np.array([ref[k] for k in names])
            f32 = np.array([float(golden[f"f32/{prefix}{k}"]) for k in names])
            card = np.array([mk[k].double().norm().item() for k in names])

            def rel(a, b):
                return float(np.linalg.norm(a - b) / np.linalg.norm(b))

            worst = max(range(len(names)),
                        key=lambda i: abs(card[i] - f32[i]) / max(f32[i], 1e-30))
            d = rel(card, f32)
            log(f"bf16 {name}: {len(names)} gradient norms, relative L2 from the "
                f"golden's float32 iteration of the same draws: the card {d:.3e} "
                f"(limit {BF16_NORM_REL_L2[name]:g}), JAX bf16 {rel(jax16, f32):.3e} "
                f"({rel(jax16, f32) / max(d, 1e-30):.1f}x the card's); farthest alone "
                f"{names[worst]}: card {card[worst]:.6g}, float32 {f32[worst]:.6g}, "
                f"JAX bf16 {jax16[worst]:.6g}")
            if not d <= BF16_NORM_REL_L2[name]:
                raise RuntimeError(f"bf16 {name} gradient norms lie too far from the "
                                   "golden's float32 iteration")
            whole = lambda m: torch.cat([m[k].double().flatten() for k in names])  # noqa: E731
            e = rel_l2(torch, whole(mk), whole(mp))
            log(f"bf16 {name}: kernel path against plain path, whole gradient relative "
                f"L2 {e:.3e} (limit {BF16_PATHS_REL_L2:g})")
            if not e <= BF16_PATHS_REL_L2:
                raise RuntimeError(f"bf16 {name}: kernel path and plain path disagree")
    torch.cuda.synchronize()
    del states, state0
    n_calls = {k: len(v) for k, v in rec.calls.items()}
    errs, n = check_recorded(np, torch, ck, rec, gen, "bf16 iteration")
    log(f"bf16 iteration: {n_calls} kernel calls, {n} distinct configurations, "
        f"dtypes {sorted(str(d)[6:] for ds in rec.dtypes.values() for d in ds)}; "
        "all exact")
    if torch.bfloat16 not in rec.dtypes["upfirdn2d"] | rec.dtypes["bias_lrelu"]:
        raise RuntimeError("the bf16 iteration launched no bf16 kernel")
    return errs


def bf16_against_f32(np, torch, ck, gen):
    """Phase 13.3: one bf16 iteration against float32 in turns, from one
    fresh state, with and without the regularizers; every kernel
    configuration of the bf16 iteration at the loop's minibatch is held
    exactly. Returns the recorder of that iteration and the largest error
    of each kernel."""
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.ops.bench import Recorder
    from inclusivegan_torch.profile_train import synthetic_batch
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.train_step import (
        TrainConfig, draw_train_step, make_train_step)

    lpips = load_lpips_params(LPIPS_WEIGHTS, device="cuda")
    # bf16 against float32 from one fresh state (the same values), in turns,
    # with and without the regularizers
    secs = {}
    tstates, truns = {}, {}
    for dt in ("float32", "bfloat16"):
        G, D, g = fresh_nets(torch, dt)
        tstates[dt] = create_train_state(G, D, generator=g)
        tcfg = TrainConfig(**TRAIN_CONFIG, lpips_dtype=None if dt == "float32" else dt)
        step = make_train_step(G, D, lpips, tcfg, device="cuda")
        truns[dt] = phase_runners(
            step, step.phases["to_device"](synthetic_batch(TRAIN_MB, 128, 512, 0)),
            draw_train_step(G, TRAIN_MB, torch.Generator("cuda").manual_seed(5), tcfg),
            LRATE, LRATE, GS_BETA, tcfg.NN_rec_lpips_weight)
        for regs in (True, False):
            secs[(dt, regs)] = {n: [] for n, _ in PHASES}

    def iteration(dt, regs, keep=True):
        for name, _ in PHASES:
            if not regs and name in ("g_reg", "d_reg"):
                continue
            torch.cuda.synchronize()
            t = time.perf_counter()
            tstates[dt], _s = truns[dt][name](tstates[dt])
            torch.cuda.synchronize()
            if keep:
                secs[(dt, regs)][name].append(time.perf_counter() - t)

    iteration("float32", True, keep=False)  # warm-up
    # the bf16 warm-up records the kernels' configurations at the loop's
    # minibatch (the golden's is 3), held exactly like the golden's
    with Recorder(ck, ("bias_lrelu", "bias_lrelu_grad", "upfirdn2d")) as loop_rec:
        iteration("bfloat16", True, keep=False)
    torch.cuda.synchronize()
    loop_errs, n = check_recorded(np, torch, ck, loop_rec, gen, "bf16 iteration, minibatch 6")
    log(f"bf16 iteration at minibatch {TRAIN_MB}: "
        f"{ {k: len(v) for k, v in loop_rec.calls.items()} } kernel calls, {n} distinct "
        "configurations; all exact")
    for regs, reps in ((True, 4), (False, 4)):
        for i in range(reps):
            for dt in (("float32", "bfloat16") if i % 2 == 0 else ("bfloat16", "float32")):
                iteration(dt, regs)
    totals = {}
    for (dt, regs), by_phase in secs.items():
        med = {n: statistics.median(v) for n, v in by_phase.items() if v}
        totals[(dt, regs)] = sum(med.values())
        log(f"fresh iteration {'with' if regs else 'without'} the regularizers, "
            f"minibatch {TRAIN_MB}, {dt}: {totals[(dt, regs)]:.4f} s = "
            + " + ".join(f"{n} {v:.4f}" for n, v in med.items()) + " (medians of 4)")
    for regs in (True, False):
        log(f"bf16 against float32 {'with' if regs else 'without'} the regularizers: "
            f"{100 * (1 - totals[('bfloat16', regs)] / totals[('float32', regs)]):.1f}% "
            "less time")
    del tstates, truns
    gc.collect()
    torch.cuda.empty_cache()
    return loop_rec, loop_errs


def inception_checks(np, torch):
    """Phase 13.4: InceptionV3 on the card, float32 with TF32 off, against
    the same net in float64; FID of a feature set with itself."""
    from inclusivegan_torch.metrics.frechet_inception_distance import frechet_distance
    from inclusivegan_torch.metrics.metric_base import GsSampler
    from inclusivegan_torch.models.inception import InceptionV3
    sampler = GsSampler(NETWORK, minibatch_size=16, device="cuda")
    imgs = next(sampler.random_images(16))
    net = InceptionV3(device="cuda")
    f32 = torch.from_numpy(net(imgs)).double()
    net.params = {k: v.double() for k, v in net.params.items()}
    with torch.no_grad():
        f64 = net.features(torch.from_numpy(imgs).cuda()).cpu()
    e = rel_l2(torch, f32, f64)
    log(f"InceptionV3 pool_3 of 16 Gs images, float32 against float64 on the card: "
        f"relative L2 {e:.3e} (limit {INCEPTION_REL_L2:g})")
    if not e <= INCEPTION_REL_L2:
        raise RuntimeError("InceptionV3 float32 features disagree with float64")
    net = InceptionV3(device="cuda")
    feats = np.concatenate([net(imgs[i:i + 8]) for imgs in sampler.random_images(512)
                            for i in range(0, imgs.shape[0], 8)]).astype(np.float64)
    mu, sigma = feats.mean(0), np.cov(feats, rowvar=False)
    fid = frechet_distance(mu, sigma, mu, sigma)
    scale = float(np.mean(np.sum(np.square(feats), axis=1)))
    log(f"FID of 512 Gs images' features with themselves: {fid:.3e}; "
        f"{abs(fid) / scale:.3e} of the mean squared feature norm {scale:.4g} "
        f"(limit {FID_SELF_REL:g})")
    if not abs(fid) <= FID_SELF_REL * scale:
        raise RuntimeError("FID of a feature set with itself is not 0")
    del sampler, net
    torch.cuda.empty_cache()


def production_bf16_phase(np, torch, ck):
    """Phase 13. Returns the kernels' launch counts of the bf16 loop, the
    largest error of each kernel at its bf16 configurations, and the bf16
    kernel records."""
    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    from inclusivegan_torch.utils.easydict import EasyDict

    phase("13 the production command at bf16: fresh init, FID and IS at every "
          "network snapshot; the bf16 iteration against its JAX golden; "
          "InceptionV3 on the card; run_metrics")
    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.cuda.empty_cache()
    iter_errs = bf16_golden_checks(np, torch, ck, gen)
    iter_rec, loop_errs = bf16_against_f32(np, torch, ck, gen)
    iter_errs = {k: max(v, loop_errs[k]) for k, v in iter_errs.items()}
    inception_checks(np, torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    old_cache = os.environ.get("INCLUSIVEGAN_CACHE")
    os.environ["INCLUSIVEGAN_CACHE"] = os.path.join(tmp, "metric_cache")
    try:
        data_dir = os.path.join(tmp, "data")
        write_loop_dataset(np, data_dir, 128)
        cut = {name: EasyDict(metric_defaults[name], num_images=BF16_METRIC_IMAGES)
               for name in BF16_METRICS}
        flags = [f for f in CLI_FLAGS if f not in ("--metrics", "none")]
        flags += ["--dtype", "bfloat16", "--metrics", ",".join(BF16_METRICS),
                  "--image-snapshot-ticks", "1", "--network-snapshot-ticks", "1"]
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.dict(metric_defaults, cut):
            sc, fn, kw = loop_kwargs(data_dir, os.path.join(tmp, "run"), [], flags=flags)
        kw = dict(kw, total_kimg=BF16_TOTAL_KIMG,
                  sched_args=dict(kw["sched_args"], tick_kimg_base=LOOP_TICK_KIMG))
        if kw["G_args"].get("dtype") != "bfloat16" or kw["D_args"].get("dtype") != "bfloat16":
            raise RuntimeError(f"the command line did not ask for bf16: {kw['G_args']}")
        log(f"$ run_training {' '.join(os.path.relpath(a, HERE) if a.startswith(HERE) else a for a in flags)}"
            f" (total_kimg {BF16_TOTAL_KIMG}, tick {LOOP_TICK_KIMG} kimg; "
            f"{', '.join(f'{n} at {BF16_METRIC_IMAGES} images' for n in BF16_METRICS)})")
        t = time.time()
        state, run_dir, launches, steps, rebuild_from, recs = run_loop(torch, ck, sc, fn, kw)
        wall = time.time() - t
        dtypes = (state.G.synthesis.dtype, state.D.dtype, state.Gs.synthesis.dtype)
        log(f"bf16 loop: G, D, Gs compute in {[str(d)[6:] for d in dtypes]}; launches "
            f"{launches}")
        if dtypes != (torch.bfloat16,) * 3 or not all(launches[k] > 0 for k in KERNELS):
            raise RuntimeError("the bf16 loop did not run bf16 networks through every kernel")
        stats = read_stats(os.path.join(run_dir, "stats.jsonl"))
        losses = {k: v for rec in stats for k, v in rec.items() if k.startswith("Loss/")}
        if len(losses) != 11 or not all(math.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"the bf16 loop's loss scalars: {losses}")
        log("bf16 loop losses " + ", ".join(f"{k[5:]} {v:.5g}" for k, v in sorted(losses.items())))
        with open(os.path.join(run_dir, "log.txt")) as f:
            run_log = f.read()
        failed = [ln for ln in run_log.splitlines() if " failed: " in ln and "metric" in ln]
        if failed:
            raise RuntimeError(f"a metric failed in the loop: {failed}")
        for ln in run_log.splitlines():
            if ": Gs " in ln or ": InceptionV3" in ln:
                log(ln)
        n_snaps = sum("Timing/snapshot_sec" in r for r in stats)
        per_kimg = {}
        for name in BF16_METRICS:
            lines = open(os.path.join(run_dir, f"metric-{name}.txt")).read().splitlines()
            log(f"metric-{name}.txt: " + " | ".join(lines))
            tag = "_random_features" if name.startswith("fid") else "_random_classifier"
            values = [float(ln.split(f" {name} ")[1].split()[0]) if name.startswith("fid")
                      else float(ln.split(f" {name}_mean ")[1].split()[0]) for ln in lines]
            if len(lines) != n_snaps or n_snaps != 2 \
                    or not all(math.isfinite(v) for v in values) \
                    or not all(f"{tag} 1" in ln for ln in lines):
                raise RuntimeError(f"metric-{name}.txt: {lines} for {n_snaps} snapshots")
            secs = [float(ln.split(" time ")[1].split()[0]) for ln in lines]
            per_kimg[name] = [1000 * s / BF16_METRIC_IMAGES for s in secs]
            log(f"{name}: {', '.join(f'{v:.3f} s' for v in per_kimg[name])} per 1000 "
                f"generated images (the metric's whole time over its {BF16_METRIC_IMAGES})")
        report_run("bf16 production run", run_dir, wall, steps, launches,
                   len(rebuild_from), n_metric_runs=n_snaps)
        log(f"device memory: peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
            f" GB, peak reserved {torch.cuda.max_memory_reserved() / 2 ** 30:.3f} GB "
            "(the bf16 run)")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        rebuild_errs = check_rebuild_kernels(np, torch, ck, recs)
        if any(torch.bfloat16 not in r.dtypes["upfirdn2d"] for r in recs):
            raise RuntimeError("the bf16 rebuild launched no bf16 FIR")
        bf16_records = bf16_kernel_times(np, torch, ck, iter_rec, recs, gen, launches)
        del recs

        # 13.5 run_metrics on the CelebA snapshot at the registry's 10000 fakes
        cli_root = os.path.join(tmp, "metrics")
        argv = [sys.executable, "-m", "inclusivegan_torch.run_metrics", "--network",
                NETWORK, "--metrics", CLI_METRIC, "--data-dir", data_dir, "--dataset",
                LOOP_DATASET, "--mirror-augment", "true", "--result-dir", cli_root]
        log("$ " + " ".join(os.path.relpath(a, HERE) if a.startswith(HERE) else a
                            for a in argv[1:]))
        t = time.time()
        proc = subprocess.run(argv, cwd=HERE, capture_output=True, text=True,
                              timeout=BF16_BUDGET_S)
        cli_s = time.time() - t
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            print(out[-3000:], flush=True)
            raise RuntimeError(f"run_metrics exited {proc.returncode}")
        for ln in out.splitlines():
            if ln.startswith(f"{CLI_METRIC}: ") or ln.startswith("network-snapshot") \
                    or ln.startswith("celeba_best"):
                log(f"run_metrics: {ln}")
        (res_dir,) = os.listdir(cli_root)
        (line,) = open(os.path.join(cli_root, res_dir, f"metric-{CLI_METRIC}.txt")
                       ).read().splitlines()
        value = float(line.split(f" {CLI_METRIC} ")[1].split()[0])
        n_fakes = metric_defaults[CLI_METRIC].num_images
        log(f"run_metrics --metrics {CLI_METRIC}: exit 0 in {cli_s:.1f} s, {n_fakes} fakes, "
            f"{CLI_METRIC} {value:.4f}")
        if not math.isfinite(value) or f": Gs {n_fakes} images" not in out \
                or f": InceptionV3 {n_fakes} images" not in out:
            raise RuntimeError(f"run_metrics gave {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("INCLUSIVEGAN_CACHE", None)
        else:
            os.environ["INCLUSIVEGAN_CACHE"] = old_cache
    errs = {k: max(v, rebuild_errs.get(k, 0.0)) for k, v in iter_errs.items()}
    bf16_s = time.time() - t_phase
    log(f"phase 13 took {bf16_s:.1f} s (budget {BF16_BUDGET_S} s)")
    if bf16_s >= BF16_BUDGET_S:
        raise RuntimeError(f"phase 13 took {bf16_s:.1f} s, over its {BF16_BUDGET_S} s budget")
    return launches, errs, bf16_records


class EvalData:
    """Phase 14's reals: EVAL_IMAGES images written by a background process
    started before phase 12; ``close`` (registered at exit) stops it and
    deletes its directory."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
        self.data_dir = os.path.join(self.tmp, "data")
        code = (f"import sys, time; sys.path.insert(0, {HERE!r}); import numpy as np; "
                f"import chip_smoke as s; t = time.time(); "
                f"s.write_loop_dataset(np, {self.data_dir!r}, 128, {EVAL_IMAGES}); "
                f"print(f'{{time.time() - t:.1f}}')")
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)

    def wait(self) -> str:
        out, _ = self.proc.communicate(timeout=EVAL_BUDGET_S)
        if self.proc.returncode != 0:
            raise RuntimeError(f"the reals' writer exited {self.proc.returncode}: {out[-2000:]}")
        log(f"the {EVAL_IMAGES} reals were written by another process in "
            f"{out.strip().splitlines()[-1]} s")
        return self.data_dir

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def forward_launches(G, forwards, mapping_only=0):
    """bias_lrelu and upfirdn2d launches of ``forwards`` Gs forwards (and
    ``mapping_only`` calls of the mapping alone)."""
    syn = G.synthesis
    n_bias = G.mapping.mapping_layers + syn.num_layers - 1
    return {"bias_lrelu": forwards * n_bias + mapping_only * G.mapping.mapping_layers,
            "upfirdn2d": forwards * 2 * (syn.resolution_log2 - 2)}


def check_activation_bits(np, torch):
    """sigmoid and swish in bfloat16 and float16 on the card against the bits
    the JAX package computes on the CPU (``activation_bits.npz``): the share
    of values that differ, by activation and dtype."""
    from inclusivegan_torch.ops import fused_bias_act
    bits = np.load(ACT_BITS)
    shares = {}
    x, b = torch.from_numpy(bits["x"]).cuda(), torch.from_numpy(bits["b"]).cuda()
    for act in ("sigmoid", "swish"):
        for dtype in ("bfloat16", "float16"):
            dt = getattr(torch, dtype)
            y = fused_bias_act(x.to(dt), b.to(dt), act=act)
            got = y.view(torch.int16).cpu().numpy().view(np.uint16)
            share = float(np.mean(got != bits[f"{act}/{dtype}"]))
            log(f"{act} {dtype} on the card against the CPU's bits: {share:.4%} of "
                f"{got.size} values differ")
            shares[f"{act} {dtype}"] = share
    return shares


def read_run_log(root):
    """The one run dir under ``root`` and the lines of its log."""
    (run_dir,) = [os.path.join(root, d) for d in os.listdir(root)]
    with open(os.path.join(run_dir, "log.txt")) as f:
        return run_dir, f.read().splitlines()


def metric_line(run_dir, name):
    """The value line of ``metric-<name>.txt``."""
    (line,) = open(os.path.join(run_dir, f"metric-{name}.txt")).read().splitlines()
    return line


def run_in_process(torch, ck, module, argv, cuts=None):
    """``python -m <module> argv`` in this process (its output to its run
    dir's log), with the launch counts set to 0 just before and read just
    after; ``cuts`` patches the metric registry. Returns (result, launches,
    seconds, seconds of each metric's ``MetricBase.run``): host clock, the
    card synchronized at both ends."""
    import importlib
    from inclusivegan_torch.metrics.metric_base import MetricBase
    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    main = importlib.import_module(module).main
    log("$ python -m " + module + " " + " ".join(
        os.path.relpath(a, HERE) if a.startswith(HERE) else a for a in argv))
    metric_s = {}
    run = MetricBase.run

    def timed_run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args, **kwargs)
        torch.cuda.synchronize()
        metric_s[self.name] = time.perf_counter() - t0
        return out
    with mock.patch.dict(metric_defaults, cuts or {}), \
            mock.patch.object(MetricBase, "run", timed_run):
        torch.cuda.synchronize()
        ck.reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(ck.launches)
    return result, launches, secs, metric_s


def check_knn_precision_recall(np, torch, ref, fake, nhood, what, failures):
    """pr50k3's k-NN precision and recall on the card against the same call
    on the CPU; returns the card's."""
    from inclusivegan_torch.metrics.precision_recall import knn_precision_recall_features
    card = knn_precision_recall_features(ref, fake, nhood, device="cuda")
    cpu = knn_precision_recall_features(ref, fake, nhood, device="cpu")
    n = min(len(ref), len(fake))
    err = max(abs(card[k] - cpu[k]) for k in ("precision", "recall"))
    log(f"k-NN precision and recall of {what}, {len(ref)} + {len(fake)} features of "
        f"{ref.shape[1]}: card {card}, CPU {cpu}, largest difference {err:.3e} "
        f"(limit 1/n = {1 / n:.3e})")
    if not err <= 1 / n:
        failures.append(f"k-NN precision and recall of {what} on the card differ from the CPU's")
    return card


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms, cuDNN's included, for a comparison
    of two paths: cuDNN's defaults may sum with atomics."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def check_launches(what, launches, expected, failures):
    log(f"{what}: launches {launches} (derived {expected})")
    if launches != expected:
        failures.append(f"{what}: launch counts {launches} != {expected}")


def evaluation_phase(np, torch, ck, eval_data):
    """Phase 14. Returns the launch counts of each evaluation path, the
    largest float32 error of each kernel at the new configurations, and the
    kernel rows at the projector's shapes."""
    from inclusivegan_torch.data.dataset import load_dataset
    from inclusivegan_torch.metrics import linear_separability, precision_recall
    from inclusivegan_torch.metrics.linear_svm import fit_linear_svc, predict
    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    from inclusivegan_torch.metrics.perceptual_path_length import pair_distances
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.ops.bench import (
        F32_OPS_PER_S, HBM_BYTES_PER_S, Recorder, device_ms, print_rows, time_configs)
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    from inclusivegan_torch.projector import Projector
    from inclusivegan_torch.snapshot import SNAPSHOT_FORMAT, load_snapshot, state_dict_to_params
    from inclusivegan_torch.training.optimizer import adam_apply, init_adam
    from inclusivegan_torch.utils.easydict import EasyDict
    from inclusivegan_torch.utils.misc import adjust_dynamic_range

    phase("14 the evaluation stage: pr50k3 and ppl_wend, the IvOM projector, ls, "
          "mode_counts and KL")
    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(14)
    torch.cuda.empty_cache()
    log("cut in depth only: " + "; ".join([
        f"pr50k3 and ppl_wend at {EVAL_IMAGES} samples (50000)",
        f"run_projector {PROJ_IMAGES} images of {PROJ_STEPS} steps (300 of 400), "
        f"minibatch {PROJ_MB} (the default)",
        f"ls at {LS_CUT['num_samples']} samples, {LS_CUT['num_keep']} kept (200000, 100000)",
        f"mode_counts_24k and KL24k at {MNIST_IMAGES} images (24576) of a fresh 32 px "
        f"G"]))
    failures = []  # held at the end of the phase, after every reading
    act_shares = check_activation_bits(np, torch)
    G = load_snapshot(NETWORK, device="cuda")
    lpips = load_lpips_params(LPIPS_WEIGHTS, device="cuda")
    data_dir = eval_data.wait()
    reals = load_dataset(data_dir=data_dir, tfrecord_dir=LOOP_DATASET, shuffle=False)
    targets = adjust_dynamic_range(reals.get_minibatch_np(PROJ_MB)[0].astype(np.float32),
                                   reals.dynamic_range, [-1, 1])
    del reals
    errs = dict.fromkeys(KERNELS, 0.0)

    def check_all_dtypes(rec, label):
        dtypes = [getattr(torch, d) for d in DTYPES]
        e, n = check_recorded(np, torch, ck, rec, gen, label, dtypes=dtypes)
        log(f"{label}: {n} configurations and dtypes, kernel against plain version exact")
        for k, v in e.items():
            errs[k] = max(errs[k], v)

    # 14.1 one projector step at minibatch 50, kernel path against plain path
    projs = {}
    for impl in ("cuda", "plain"):
        projs[impl] = Projector(lpips_weights=LPIPS_WEIGHTS, impl=impl)
        with contextlib.redirect_stdout(io.StringIO()):
            projs[impl].set_network(G, minibatch_size=PROJ_MB, num_steps=PROJ_STEPS)
        projs[impl].start(targets)
    lat = torch.randn((PROJ_MB, G.mapping.latent_size), device="cuda", generator=gen)
    noise = torch.randn((PROJ_MB, G.mapping.latent_size), device="cuda", generator=gen)
    strength, lr = projs["cuda"].ramps(PROJ_STEPS // 4)
    names = ("bias_lrelu", "bias_lrelu_grad", "upfirdn2d")
    # cuDNN's default backward algorithms may sum with atomics, which moves
    # the latents' gradient from run to run (shown by the plain path twice);
    # the comparison runs PyTorch's deterministic algorithms on both paths
    twice = [projs["plain"].loss_and_grad(lat, noise, strength)[2] for _ in range(2)]
    log(f"projector step, plain path twice with the default algorithms: latents' "
        f"gradient relative L2 difference {rel_l2(torch, twice[0], twice[1]):.3e}")
    del twice
    out = {}
    with deterministic(torch):
        for impl, proj in projs.items():
            with Recorder(ck, names) as rec:
                dist, loss, grad = proj.loss_and_grad(lat, noise, strength)
            torch.cuda.synchronize()
            new, _, _ = adam_apply({"z": lat}, {"z": grad}, init_adam({"z": lat}),
                                   learning_rate=lr, beta1=0.9, beta2=0.999, epsilon=1e-8)
            out[impl] = (dist, grad, new["z"])
            if impl == "cuda":
                proj_rec = rec
    (dk, gk, zk), (dp, gp, zp) = out["cuda"], out["plain"]
    d_err = ((dk - dp).abs() / dp.abs()).max().item()
    g_err = rel_l2(torch, gk, gp)
    z_err = (zk - zp).abs().max().item()
    log(f"projector step {PROJ_STEPS // 4} at minibatch {PROJ_MB} (noise strength "
        f"{strength:.4g}, lr {lr:.4g}), deterministic algorithms, kernel path against "
        f"plain path: LPIPS distances "
        f"max relative err {d_err:.3e} (limit {PROJ_DIST_RTOL:g}), latents' gradient "
        f"relative L2 {g_err:.3e} (limit {PROJ_GRAD_REL_L2:g}), latents after Adam max "
        f"abs err {z_err:.3e} (limit {PROJ_LATENT_ATOL:g}); distances {dk.mean().item():.5f} "
        f"mean, gradient norm {gk.norm().item():.4e}")
    if not (d_err <= PROJ_DIST_RTOL and g_err <= PROJ_GRAD_REL_L2
            and z_err <= PROJ_LATENT_ATOL and torch.isfinite(gk).all()):
        failures.append("the projector's kernel path disagrees with its plain path")
    per_step = {n: len(proj_rec.calls[n]) for n in names}
    per_step["upfirdn2d_transposed"] = sum(
        k[5] == "upfirdn2d_transposed" for _, k in proj_rec.calls["upfirdn2d"])
    per_step["upfirdn2d"] -= per_step["upfirdn2d_transposed"]
    log(f"one projector step launches {per_step}")
    check_all_dtypes(proj_rec, "projector step")

    # 14.2 PPL's 32-image synthesis (16 pairs), kernel path against plain path
    ppl_args = metric_defaults["ppl_wend"]
    z01 = torch.randn((2 * ppl_args.minibatch_per_gpu, G.mapping.latent_size), device="cuda",
                      generator=gen)
    t0 = torch.zeros(ppl_args.minibatch_per_gpu, device="cuda")
    ppl_noise = G.synthesis.init_noise(gen)
    def lengths_of(impl):
        return pair_distances(G, lpips, z01, t0, ppl_noise, "w", ppl_args.epsilon,
                              ppl_args.crop, impl=impl)

    def rel_max(a, b):
        return ((a - b).abs() / b.abs()).max().item()
    lengths = {}
    with torch.no_grad():
        twice = [lengths_of("plain") for _ in range(2)]
        log(f"ppl_wend's 16 pair lengths, plain path twice with the default algorithms: "
            f"max relative difference {rel_max(*twice):.3e}")
        with deterministic(torch):
            for impl in ("cuda", "plain"):
                with Recorder(ck) as rec:
                    lengths[impl] = lengths_of(impl)
                if impl == "cuda":
                    ppl_rec = rec
    pe = rel_max(lengths["cuda"], lengths["plain"])
    log(f"ppl_wend's 16 pair lengths, deterministic algorithms, kernel path against "
        f"plain path: max relative err "
        f"{pe:.3e} (limit {PPL_PAIR_RTOL:g}); lengths {lengths['cuda'].min().item():.4g} to "
        f"{lengths['cuda'].max().item():.4g}")
    if not pe <= PPL_PAIR_RTOL:
        failures.append("PPL's pair lengths differ between the kernel and plain paths")
    check_all_dtypes(ppl_rec, "ppl_wend synthesis")

    # 14.3 the stacked-MNIST run's 32 px G, fresh, as a snapshot
    g_init = torch.Generator(device="cuda").manual_seed(32)
    G32 = GMain.create(**MNIST_G_CONFIG).to("cuda").init(g_init)
    D32 = Discriminator(**MNIST_D_CONFIG).to("cuda").init(g_init)
    with torch.no_grad(), Recorder(ck) as rec:
        G32(torch.randn((32, 512), device="cuda", generator=gen),
            truncation_psi=1.0, randomize_noise=False)
    check_all_dtypes(rec, "32 px G")
    mnist_pkl = os.path.join(eval_data.tmp, "stacked_mnist_fresh.pkl")

    def net(model):
        return {"config": model.config, "params": state_dict_to_params(model.state_dict())}
    with open(mnist_pkl, "wb") as f:
        pickle.dump({"format": SNAPSHOT_FORMAT + ".v1", "G": net(G32), "D": net(D32),
                     "Gs": net(G32)}, f)
    del D32
    torch.cuda.empty_cache()

    # 14.4 the main paths, each with its launch counts set to 0 before it
    launches = {}
    common = ["--data-dir", data_dir, "--dataset", LOOP_DATASET, "--mirror-augment", "true"]
    cuts = {"pr50k3": EasyDict(metric_defaults["pr50k3"], num_images=EVAL_IMAGES),
            "ppl_wend": EasyDict(metric_defaults["ppl_wend"], num_samples=EVAL_IMAGES)}
    root = os.path.join(eval_data.tmp, "metrics_pr_ppl")
    knn_inputs = []
    knn = precision_recall.knn_precision_recall_features

    def recording_knn(ref, fake, nhood_size=3, **kw):
        knn_inputs.append((ref, fake, nhood_size))
        return knn(ref, fake, nhood_size, **kw)
    with mock.patch.object(precision_recall, "knn_precision_recall_features", recording_knn):
        res, launches["pr50k3,ppl_wend"], secs, metric_s = run_in_process(
            torch, ck, "inclusivegan_torch.run_metrics",
            ["--network", NETWORK, "--metrics", "pr50k3,ppl_wend", "--lpips-weights",
             LPIPS_WEIGHTS, "--result-dir", root] + common, cuts)
    expected = forward_launches(G, EVAL_IMAGES // 32 + EVAL_IMAGES // 16)
    check_launches("run_metrics pr50k3,ppl_wend", launches["pr50k3,ppl_wend"],
                   dict(expected, bias_lrelu_grad=0, upfirdn2d_transposed=0), failures)
    run_dir, lines = read_run_log(root)
    for ln in lines:
        if ln.startswith(("pr50k3:", "ppl_wend:", "celeba_best")):
            log(f"run_metrics: {ln}")
    per_1000 = {name: 1000 * metric_s[name] / EVAL_IMAGES for name in ("pr50k3", "ppl_wend")}
    log(f"run_metrics pr50k3,ppl_wend: {secs:.3f} s; {res}")
    if not all(math.isfinite(v) for v in res.values()) or res.get(
            "pr50k3_random_features") != 1.0 or not res["ppl_wend"] > 0:
        raise RuntimeError(f"run_metrics pr50k3,ppl_wend gave {res}")
    (ref_f, fake_f, nhood), = knn_inputs
    card = check_knn_precision_recall(np, torch, ref_f, fake_f, nhood, "the pr50k3 run",
                                      failures)
    if not all(abs(card[k] - res[f"pr50k3_{k}"]) <= 1 / len(ref_f)
               for k in ("precision", "recall")):
        failures.append("the pr50k3 run's result is not that of its features")
    rng = np.random.RandomState(14)
    proj = rng.randn(PR_SYNTH_RANK, ref_f.shape[1]).astype(np.float32) / PR_SYNTH_RANK ** 0.5
    ref_s = rng.randn(PR_SYNTH_N, PR_SYNTH_RANK).astype(np.float32) @ proj
    fake_s = (rng.randn(PR_SYNTH_N, PR_SYNTH_RANK) + PR_SYNTH_SHIFT).astype(np.float32) @ proj
    card = check_knn_precision_recall(np, torch, ref_s, fake_s, nhood, "two seeded sets",
                                      failures)
    if not all(0.05 < v < 0.95 for v in card.values()):
        failures.append(f"the seeded sets' k-NN precision and recall {card} are near 0 or 1")
    del knn_inputs, ref_s, fake_s

    root = os.path.join(eval_data.tmp, "projection")
    (mean, std), launches["run_projector"], proj_s, _ = run_in_process(
        torch, ck, "inclusivegan_torch.run_projector",
        ["project-real-images", "--network", NETWORK, "--data-dir", data_dir,
         "--dataset", LOOP_DATASET, "--num-images", str(PROJ_IMAGES), "--minibatch-size",
         str(PROJ_MB), "--num-steps", str(PROJ_STEPS), "--num-snapshots",
         str(PROJ_SNAPSHOTS), "--lpips-weights", LPIPS_WEIGHTS, "--result-dir", root])
    n_batches = -(-PROJ_IMAGES // PROJ_MB)
    forwards = n_batches * (PROJ_STEPS + PROJ_SNAPSHOTS + 2)  # snapshots, get_dist, final
    expected = forward_launches(G, forwards)
    expected.update(bias_lrelu_grad=n_batches * PROJ_STEPS * per_step["bias_lrelu_grad"],
                    upfirdn2d_transposed=n_batches * PROJ_STEPS
                    * per_step["upfirdn2d_transposed"])
    check_launches("run_projector", launches["run_projector"], expected, failures)
    run_dir, lines = read_run_log(root)
    ivom = open(os.path.join(run_dir, "ivom.txt")).read().split()
    files = os.listdir(run_dir)
    want = {f"image{i:04d}-{k}.png" for i in range(PROJ_IMAGES) for k in ("target", "final")}
    want |= {f"image{i:04d}-step{s:04d}.png" for i in range(PROJ_IMAGES)
             for s in range(0, PROJ_STEPS, PROJ_STEPS // PROJ_SNAPSHOTS)}
    for ln in lines:
        if ln.startswith(("IvOM", "projected")):
            log(f"run_projector: {ln}")
    log(f"run_projector: {proj_s:.3f} s in all; ivom.txt {ivom}; {len(files)} files")
    if not (want <= set(files) and len(ivom) == 3 and int(ivom[2]) == PROJ_IMAGES
            and math.isfinite(mean) and mean > 0):
        raise RuntimeError(f"run_projector: ivom {ivom}, missing {sorted(want - set(files))[:4]}")

    fits = []
    fit = linear_separability.fit_linear_svc

    def recording_fit(x, y):
        w, n = fit(x, y)
        if len(fits) < 6:
            fits.append((x, y, w))
        return w, n
    root = os.path.join(eval_data.tmp, "metrics_ls")
    with mock.patch.object(linear_separability, "fit_linear_svc", recording_fit):
        res_ls, launches["ls"], ls_s, _ = run_in_process(
            torch, ck, "inclusivegan_torch.run_metrics",
            ["--network", NETWORK, "--metrics", "ls", "--result-dir", root] + common,
            {"ls": EasyDict(metric_defaults["ls"], classifier_weights=ATTR_WEIGHTS, **LS_CUT)})
    takes = -(-LS_CUT["num_samples"] // (metric_defaults["ls"].minibatch_per_gpu * 32))
    check_launches("run_metrics ls", launches["ls"],
                   dict(forward_launches(G, LS_CUT["num_samples"] // 32, mapping_only=takes),
                        bias_lrelu_grad=0, upfirdn2d_transposed=0), failures)
    run_dir, lines = read_run_log(root)
    ls_line = [ln for ln in lines if ln.startswith("ls: ")]
    for ln in ls_line + [ln for ln in lines if ln.startswith("celeba_best")]:
        log(f"run_metrics: {ln}")
    log(f"run_metrics ls: {ls_s:.3f} s; {res_ls}")
    if set(res_ls) != {"ls_z", "ls_w"} or not all(v >= 1 and math.isfinite(v)
                                                  for v in res_ls.values()):
        raise RuntimeError(f"run_metrics ls gave {res_ls}")
    gen_s, fit_s = (float(ls_line[0].split(" in ")[i].split(" s")[0]) for i in (1, 2))
    per_1000["ls generation and scorer"] = 1000 * gen_s / LS_CUT["num_samples"]
    per_1000["ls SVM fits"] = 1000 * fit_s / LS_CUT["num_samples"]
    worst = 1.0
    for x, y, w in fits:
        w64, _ = fit_linear_svc(x.double(), y)
        agree = (predict(w, x) == predict(w64, x.double())).float().mean().item()
        worst = min(worst, agree)
    log(f"LS's SVM, float32 against float64 on the card, {len(fits)} fits of "
        f"{tuple(fits[0][0].shape)}: predictions agree on at least {worst:.4%} "
        f"(limit {SVM_AGREE:.1%})")
    if not (fits and worst >= SVM_AGREE):
        failures.append("the SVM in float32 disagrees with float64")
    del fits

    root = os.path.join(eval_data.tmp, "metrics_mnist")
    mcuts = {n: EasyDict(metric_defaults[n], num_images=MNIST_IMAGES)
             for n in ("mode_counts_24k", "KL24k")}
    res_m, launches["mode_counts_24k,KL24k"], m_s, metric_s = run_in_process(
        torch, ck, "inclusivegan_torch.run_metrics",
        ["--network", mnist_pkl, "--metrics", "mode_counts_24k,KL24k",
         "--classifier-weights", MNIST_WEIGHTS, "--result-dir", root] + common, mcuts)
    check_launches("run_metrics mode_counts_24k,KL24k", launches["mode_counts_24k,KL24k"],
                   dict(forward_launches(G32, 2 * MNIST_IMAGES // 32), bias_lrelu_grad=0,
                        upfirdn2d_transposed=0), failures)
    run_dir, _ = read_run_log(root)
    for name in ("mode_counts_24k", "KL24k"):
        per_1000[name] = 1000 * metric_s[name] / MNIST_IMAGES
        log(f"metric-{name}.txt: {metric_line(run_dir, name)}")
    log(f"run_metrics mode_counts_24k,KL24k: {m_s:.3f} s; {res_m}")
    if not (1 <= res_m["mode_counts_24k"] <= 1000 and math.isfinite(res_m["KL24k"])
            and math.isfinite(res_m["mode_counts_24k_KL"])
            and "mode_counts_24k_untrained_classifier" not in res_m):
        raise RuntimeError(f"run_metrics mode_counts_24k,KL24k gave {res_m}")
    del G32
    log("seconds per 1000 samples (each metric's MetricBase.run on the host clock, the "
        "snapshot's load included; ls from its own 0.01 s print): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_1000.items()))

    # 14.5 times: the projector's step, kernels and plain versions in turns
    step_s = {"cuda": [], "plain": []}
    for proj in projs.values():
        proj.num_steps = 400
        proj.start(targets)
        proj.step()  # warm-up
    for i in range(6):
        for impl in (("plain", "cuda") if i % 2 == 0 else ("cuda", "plain")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            projs[impl].step()
            torch.cuda.synchronize()
            step_s[impl].append(time.perf_counter() - t)
    med = {impl: statistics.median(v) for impl, v in step_s.items()}
    for impl, v in step_s.items():
        log(f"projector step at minibatch {PROJ_MB}, impl={impl}: {1e3 * med[impl]:.2f} ms "
            f"(median of {', '.join(f'{1e3 * x:.1f}' for x in v)})")
    ivom_400 = (proj_s + (400 - PROJ_STEPS) * n_batches * med["cuda"]) / PROJ_IMAGES
    log(f"IvOM at 400 steps, extrapolated: {ivom_400:.3f} s per image (the run's "
        f"{proj_s:.3f} s for "
        f"{PROJ_IMAGES} images at {PROJ_STEPS} steps, plus {400 - PROJ_STEPS} steps at "
        f"{1e3 * med['cuda']:.2f} ms per minibatch of {PROJ_MB})")
    del projs
    torch.cuda.empty_cache()

    # the kernels at the projector's largest shapes
    records = {}
    with torch.no_grad():
        shape, (alpha, gain) = max(proj_rec.unique("bias_lrelu_grad"),
                                   key=lambda k: math.prod(k[0]))
        y = torch.randn(shape, device="cuda", generator=gen)
        dy = torch.randn(shape, device="cuda", generator=gen)
        t_bytes = 3 * y.numel() * y.element_size() / HBM_BYTES_PER_S
        t_ops = 2 * y.numel() / F32_OPS_PER_S
        records["bias_lrelu_grad"] = dict(
            shape=list(shape), ms=device_ms(lambda: ck.bias_lrelu_grad(y, dy, alpha, gain)),
            plain_ms=device_ms(lambda: bias_lrelu_grad_plain(y, dy, alpha, gain)),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
            launches_per_step=per_step["bias_lrelu_grad"])
        del y, dy
        shape, (axis, alpha, gain) = max(proj_rec.unique("bias_lrelu"),
                                         key=lambda k: math.prod(k[0]))
        x = torch.randn(shape, device="cuda", generator=gen)
        b = torch.randn(shape[axis], device="cuda", generator=gen)
        t_bytes = (2 * x.numel() + b.numel()) * x.element_size() / HBM_BYTES_PER_S
        t_ops = 3 * x.numel() / F32_OPS_PER_S
        records["bias_lrelu"] = dict(
            shape=list(shape), ms=device_ms(lambda: ck.bias_lrelu(x, b, axis, alpha, gain)),
            plain_ms=device_ms(lambda: fused_bias_act(x, b, axis=axis, act="lrelu",
                                                      alpha=alpha, gain=gain, impl="plain")),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
            launches_per_step=per_step["bias_lrelu"])
        del x, b
    log(f"upfirdn2d at every configuration of one projector step (minibatch {PROJ_MB}, "
        f"{len(proj_rec.calls['upfirdn2d'])} launches):")
    rows = time_configs(ck, proj_rec.calls["upfirdn2d"], gen, log=log)
    print_rows(rows, log=log)
    for counter in ("upfirdn2d", "upfirdn2d_transposed"):
        shape, (f, up, down, pad, gain, _c) = max(
            (c for c in proj_rec.unique("upfirdn2d") if c[1][5] == counter),
            key=lambda c: math.prod(c[0]))
        r = next(r for r in rows if tuple(r["shape"]) == shape and r["counter"] == counter
                 and r["up"] == up and list(r["pad"]) == list(pad))
        with torch.no_grad():
            x = torch.randn(shape, device="cuda", generator=gen)
            f = np.asarray(f, np.float32)
            plain_ms = device_ms(lambda: upfirdn2d(x, f, up=up, down=down, pad=pad,
                                                   gain=gain, impl="plain"))
        records[counter] = dict(shape=r["shape"], ms=r["ms"], plain_ms=plain_ms,
                                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                                library_ms=r["library_ms"],
                                launches_per_step=per_step[counter])
        del x
    for name, r in records.items():
        log(f"{name} at the projector's {tuple(r['shape'])}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"library {r['library_ms']}, {r['launches_per_step']} launches per step")
    del G
    gc.collect()
    torch.cuda.empty_cache()
    if any(act_shares.values()):
        failures.append(f"sigmoid or swish on the card differs from the CPU's bits: "
                        f"{act_shares}")
    if failures:
        raise RuntimeError("phase 14: " + "; ".join(failures))
    eval_s = time.time() - t_phase
    log(f"phase 14 took {eval_s:.1f} s (budget {EVAL_BUDGET_S} s)")
    if eval_s >= EVAL_BUDGET_S:
        raise RuntimeError(f"phase 14 took {eval_s:.1f} s, over its {EVAL_BUDGET_S} s budget")
    return launches, errs, records


def main() -> int:
    import atexit
    import numpy as np
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "CUDA card", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"numpy {np.__version__}; cudnn.allow_tf32=False, "
        f"cuda.matmul.allow_tf32=False")

    # cuBLAS needs a fixed workspace for the deterministic algorithms that
    # phase 9 turns on; set before the first matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, HERE)
    from inclusivegan_torch.ops import build, cuda_kernels as ck
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.run_generator import generate_images
    from inclusivegan_torch.ops.bench import (
        F32_OPS_PER_S, HBM_BYTES_PER_S, Recorder, device_ms, fir_ops, plan_summary)
    from inclusivegan_torch.snapshot import load_snapshot

    phase(f"2 build (budget {BUILD_BUDGET_S} s)")
    t = time.time()
    lib = build.build(verbose=True)
    ck.load_library()
    build_s = time.time() - t
    log(f"built {os.path.relpath(lib, HERE)} in {build_s:.1f} s")
    if build_s >= BUILD_BUDGET_S:
        raise RuntimeError(f"the build took {build_s:.1f} s, over its "
                           f"{BUILD_BUDGET_S} s budget")
    t_after_build = time.time()

    phase("3 load CelebA-128 Gs and record the kernels' shapes")
    G = load_snapshot(NETWORK, device="cuda")
    syn = G.synthesis
    log(f"Gs: resolution {2 ** syn.resolution_log2}, {syn.architecture}, "
        f"{syn.num_layers} layers, mapping {G.mapping.mapping_layers}x"
        f"{G.mapping.dlatent_size}, psi {G.truncation_psi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(MINIBATCH, G.mapping.latent_size, device="cuda", generator=gen)
    with torch.no_grad(), Recorder(ck) as rec:
        imgs = G(z, randomize_noise=False)
    torch.cuda.synchronize()
    if not torch.isfinite(imgs).all():
        raise RuntimeError("non-finite generator output")
    per_forward = forward_launches(G, 1)
    n_bias, n_fir = per_forward["bias_lrelu"], per_forward["upfirdn2d"]
    got = (len(rec.calls["bias_lrelu"]), len(rec.calls["upfirdn2d"]))
    log(f"one forward: {got[0]} bias_lrelu and {got[1]} upfirdn2d calls "
        f"(expected {n_bias} and {n_fir})")
    if got != (n_bias, n_fir):
        raise RuntimeError(f"kernel calls per forward {got} != {(n_bias, n_fir)}")

    phase("4 kernels against their plain versions on the card")
    errs = {"bias_lrelu": 0.0, "upfirdn2d": 0.0}
    with torch.no_grad():
        for dtype in (getattr(torch, d) for d in DTYPES):
            tol = TOL[str(dtype)[6:]]
            for shape, (axis, alpha, gain) in rec.unique("bias_lrelu"):
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                b = torch.randn(shape[axis], device="cuda", generator=gen).to(dtype)
                e = check_kernel("bias_lrelu", shape,
                                 lambda: ck.bias_lrelu(x, b, axis, alpha, gain),
                                 lambda: fused_bias_act(x, b, axis=axis, act="lrelu",
                                                        alpha=alpha, gain=gain,
                                                        impl="plain"), dtype, tol)
                if dtype == torch.float32:
                    errs["bias_lrelu"] = max(errs["bias_lrelu"], e)
            for shape, (f, up, down, pad, gain, _counter) in rec.unique("upfirdn2d"):
                f = np.asarray(f, np.float32)
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                e = check_kernel(f"upfirdn2d up {up} down {down} pad {pad} gain {gain:g}",
                                 shape, lambda: ck.upfirdn2d(x, f, up, down, pad, gain),
                                 lambda: upfirdn2d(x, f, up=up, down=down, pad=pad,
                                                   gain=gain, impl="plain"), dtype, tol)
                if dtype == torch.float32:
                    errs["upfirdn2d"] = max(errs["upfirdn2d"], e)

    phase("5 main path: generate-images, 8 images in minibatches of 4")
    ck.reset_launches()
    images = generate_images(G, NUM_IMAGES, MINIBATCH, device="cuda")
    launches = dict(ck.launches)
    n_batches = math.ceil(NUM_IMAGES / MINIBATCH)
    expected = dict(forward_launches(G, n_batches), bias_lrelu_grad=0,
                    upfirdn2d_transposed=0)
    log(f"images {images.shape} {images.dtype}; launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != {expected}")
    if images.shape != (NUM_IMAGES, 128, 128, 3) or images.std() < 1.0:
        raise RuntimeError(f"bad images: shape {images.shape}, "
                           f"std {images.std():.3f}")
    plain = generate_images(G, NUM_IMAGES, MINIBATCH, device="cuda", impl="plain")
    golden = np.load(GOLDEN)["images"]
    for name, ref, got in (("plain path on the card", plain, images),
                           ("JAX golden", golden, images[:len(golden)])):
        levels, frac = compare_images(np, got, ref)
        ok = levels <= IMG_MAX_LEVELS and frac <= IMG_MAX_FRACTION
        log(f"images vs {name}: max |diff| {levels} levels, {frac:.4%} of "
            f"values differ (limits {IMG_MAX_LEVELS}, {IMG_MAX_FRACTION:.1%}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"images disagree with the {name}")

    phase("6 times")
    records = []
    with torch.no_grad():
        shape, (axis, alpha, gain) = max(rec.unique("bias_lrelu"),
                                         key=lambda k: math.prod(k[0]))
        x = torch.randn(shape, device="cuda", generator=gen)
        b = torch.randn(shape[axis], device="cuda", generator=gen)
        ms = device_ms(lambda: ck.bias_lrelu(x, b, axis, alpha, gain))
        plain_ms = device_ms(lambda: fused_bias_act(
            x, b, axis=axis, act="lrelu", alpha=alpha, gain=gain, impl="plain"))
        nbytes = 2 * x.numel() * x.element_size() + b.numel() * b.element_size()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * x.numel() / F32_OPS_PER_S
        records.append(dict(
            name="bias_lrelu", route="cuda",
            source="inclusivegan_torch/ops/csrc/bias_act.cu",
            replaces="inclusivegan_tpu/ops/pallas_kernels.py:68",
            launches=launches["bias_lrelu"], max_abs_err=errs["bias_lrelu"],
            ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, shape=list(shape)))

        shape, (f, up, down, pad, gain, _counter) = max(
            rec.unique("upfirdn2d"), key=lambda k: math.prod(k[0]))
        f = np.asarray(f, np.float32)
        x = torch.randn(shape, device="cuda", generator=gen)
        ms = device_ms(lambda: ck.upfirdn2d(x, f, up, down, pad, gain))
        plain_ms = device_ms(lambda: upfirdn2d(
            x, f, up=up, down=down, pad=pad, gain=gain, impl="plain"))
        y = ck.upfirdn2d(x, f, up, down, pad, gain)
        log(f"upfirdn2d launch at {shape}: "
            f"{plan_summary(shape, ck.upfirdn2d_plan(x, f, up, down, pad))}")
        library_ms = None
        if up == down == 1 and len(set(pad)) == 1:
            # the same FIR as one depthwise convolution (cuDNN), as yardstick
            c = shape[1]
            w = torch.from_numpy(np.ascontiguousarray((f * gain)[::-1, ::-1]))
            w = w.to("cuda")[None, None].repeat(c, 1, 1, 1)
            lib_y = torch.nn.functional.conv2d(x, w, padding=pad[0], groups=c)
            lib_err = (lib_y - y).abs().max().item()
            log(f"depthwise conv2d vs kernel: max abs err {lib_err:.3e}")
            if lib_err > 1e-4:
                raise RuntimeError("depthwise conv2d does not compute the FIR")
            library_ms = device_ms(lambda: torch.nn.functional.conv2d(
                x, w, padding=pad[0], groups=c))
        nbytes = (x.numel() + y.numel()) * x.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = fir_ops(shape, f, up, down, pad) / F32_OPS_PER_S
        records.append(dict(
            name="upfirdn2d", route="cuda",
            source="inclusivegan_torch/ops/csrc/upfirdn2d.cu",
            replaces="inclusivegan_tpu/ops/pallas_kernels.py:251",
            launches=launches["upfirdn2d"], max_abs_err=errs["upfirdn2d"],
            ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, shape=list(shape)))
    for r in records:
        log(f"{r['name']} at {tuple(r['shape'])}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")

    # images/s on the host clock, kernels and plain versions in turns
    # (plain, cuda, cuda, plain, ...) so that both see the same host
    runs = {"cuda": [], "plain": []}
    for impl in ("cuda", "plain"):
        generate_images(G, BENCH_BATCH, BENCH_BATCH, device="cuda", impl=impl)
    for i in range(6):
        for impl in (("plain", "cuda") if i % 2 == 0 else ("cuda", "plain")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            generate_images(G, 8 * BENCH_BATCH, BENCH_BATCH, device="cuda",
                            impl=impl)
            runs[impl].append(8 * BENCH_BATCH / (time.perf_counter() - t))
    for impl, r in runs.items():
        log(f"generate-images minibatch {BENCH_BATCH}, impl={impl}: "
            f"{statistics.median(r):.2f} images/s (median of "
            f"{', '.join(f'{v:.1f}' for v in r)})")
    run_s = time.time() - t_after_build
    log(f"phases 3-6 took {run_s:.1f} s (budget {RUN_BUDGET_S} s)")
    if run_s >= RUN_BUDGET_S:
        raise RuntimeError(f"phases 3-6 took {run_s:.1f} s, over their "
                           f"{RUN_BUDGET_S} s budget")
    del G
    torch.cuda.empty_cache()

    t_train = time.time()
    train_records, train_launches, train_errs = training_slice(np, torch, ck, gen)
    for r in records:
        r["launches_by_path"] = {"generate_images": r["launches"],
                                 "train_iteration": train_launches[r["name"]]}
        r["launches"] = train_launches[r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"], train_errs[r["name"]])
    records += train_records
    train_s = time.time() - t_train
    log(f"phases 7-11 took {train_s:.1f} s (budget {TRAIN_BUDGET_S} s)")
    if train_s >= TRAIN_BUDGET_S:
        raise RuntimeError(f"phases 7-11 took {train_s:.1f} s, over their "
                           f"{TRAIN_BUDGET_S} s budget")

    # phase 14's reals, written by another process while phases 12 and 13
    # run (after the timings of phases 6 and 11)
    eval_data = EvalData()
    atexit.register(eval_data.close)
    gc.collect()
    loop_launches, loop_errs = training_loop_phase(np, torch, ck)
    for r in records:
        r["launches_by_path"] = dict(r.get("launches_by_path", {}),
                                     training_loop=loop_launches[r["name"]])
        r["max_abs_err"] = max(r["max_abs_err"], loop_errs.get(r["name"], 0.0))

    gc.collect()
    bf16_launches, bf16_errs, bf16_records = production_bf16_phase(np, torch, ck)
    for r in records:
        r["launches_by_path"]["training_loop_bf16"] = bf16_launches[r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"], bf16_errs.get(r["name"], 0.0))
        r["bf16"] = bf16_records[r["name"]]

    gc.collect()
    eval_launches, eval_errs, eval_records = evaluation_phase(np, torch, ck, eval_data)
    for r in records:
        r["launches_by_path"].update({f"evaluation {path}": counts[r["name"]]
                                      for path, counts in eval_launches.items()})
        # this slice's main path, the IvOM projector, gives the launches and
        # the timings at the top level, both at its shapes; the earlier
        # timing goes under the path that gave its shape
        earlier = {k: r.pop(k) for k in TIMING_KEYS if k in r}
        earlier["path"] = ("generate_images" if r["name"] in ("bias_lrelu", "upfirdn2d")
                           else "train_iteration")
        r["earlier_timing"] = earlier
        r.update(eval_records[r["name"]])
        r["launches"] = eval_launches["run_projector"][r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"], eval_errs[r["name"]])
    log(f"the whole smoke took {time.time() - T0:.1f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
