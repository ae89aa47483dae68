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
     version on the same inputs, float32 (and bfloat16 for bias_lrelu);
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
     kernel at each of those shapes against its plain version, float32 and,
     for bias_lrelu and its gradient, bfloat16;
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
     through PyTorch's own float32 GEMMs;
 11. times: the gradient kernel and upfirdn2d at its largest transposed
     configuration beside their plain versions, bounds and library calls;
     seconds per phase of an iteration with and without the regularizers,
     kernels and plain versions in turns; the IMLE rebuild.
The build must take under 60 s, phases 3-6 under 180 s and phases 7-11
under 300 s; a run over any budget fails. Any failure raises and the script
exits non-zero. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
# rec weight 2.5, lazy intervals 4 and 16, lr 0.002, projector 512,
# 10 samples per real, perturbation 0.05, candidate batches of 1024), at
# the --minibatch-gpu default of run_training.py, 6; float32, as the JAX
# package resumes this snapshot.
LPIPS_WEIGHTS = os.path.join(HERE, "artifacts", "celeba_perceptual_vgg.npz")
TRAIN_GOLDEN = os.path.join(HERE, "inclusivegan_torch", "testdata",
                            "celeba128_train_golden.npz")
TRAIN_MB = 6
DATA_SIZE = 60  # divisible by 2 * minibatch; 600 candidates
TRAIN_CONFIG = dict(gamma=100.0, mirror_augment=True, NN_rec_lpips_weight=2.5,
                    G_reg_interval=4, D_reg_interval=16)
IMLE_CONFIG = dict(num_samples_factor=10, init_proj_dim=512,
                   knn_perturb_factor=0.05, candidate_batch_size=1024)
LRATE = 0.002
GS_BETA = 0.5 ** (TRAIN_MB / 10000.0)  # G_smoothing_kimg 10

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Kernel against plain version, elementwise |k - p| <= atol + rtol * |p|.
# float32: both sum in float32 in another order (FMA in the FIR), so they
# agree to a few float32 roundings. bfloat16: the plain version rounds after
# each of its 3 ops, the kernel once, so up to 4 roundings of 2^-8 each.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -6)}
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


def device_ms(torch, fn, iters: int = 20, repeats: int = 5) -> float:
    """Median device time of one ``fn()`` in ms. The card first spins on a
    sleep kernel so that the host enqueues all ``iters`` launches before the
    start event runs: the events then time the device, not the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


class Recorder:
    """Records the arguments of every kernel-wrapper call while it is open
    (the wrappers themselves are untouched and still count launches): the
    shape of the input and the arguments that are not tensors, keywords
    included, with taps as tuples so that calls can be told apart."""

    def __init__(self, ck, np, names=("bias_lrelu", "upfirdn2d")):
        self.ck, self.np = ck, np
        self.calls = {name: [] for name in names}

    def __enter__(self):
        self.orig = {name: getattr(self.ck, name) for name in self.calls}
        for name, fn in self.orig.items():
            setattr(self.ck, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(x, *args, **kwargs):
            key = tuple(tuple(map(tuple, a)) if isinstance(a, self.np.ndarray)
                        else a for a in args if not hasattr(a, "data_ptr"))
            self.calls[name].append((tuple(x.shape), key + tuple(kwargs.values())))
            return fn(x, *args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ck, name, fn)

    def unique(self, name):
        return list(dict.fromkeys(self.calls[name]))


def fir_ops(np, shape, f, up, down, pad) -> float:
    """Multiply-adds the FIR needs for these inputs: taps that fall on an
    inserted zero or outside the input are not counted."""
    n, c, h, w = shape
    kh, kw = f.shape
    padx0, padx1, pady0, pady1 = pad
    oh = (h * up + pady0 + pady1 - kh) // down + 1
    ow = (w * up + padx0 + padx1 - kw) // down + 1

    def hits(o, k, size, pad0):
        u = np.arange(o)[:, None] * down + np.arange(k)[None, :] - pad0
        return int(np.sum((u >= 0) & (u < size * up) & (u % up == 0)))

    return 2.0 * n * c * hits(oh, kh, h, pady0) * hits(ow, kw, w, padx0)


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


def training_slice(np, torch, ck, gen):
    """Phases 7-11. Returns the kernel records of the two new kernels, the
    main path's launch counts and the largest float32 error of each kernel."""
    import ast
    from inclusivegan_torch.data.dataset import SyntheticDataset
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.ops import fused_bias_act, upfirdn2d
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
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
    with Recorder(ck, np, names) as rec:
        runs = phase_runners(steps["cuda"], batch, draws, LRATE, LRATE, GS_BETA,
                             cfg.NN_rec_lpips_weight)
        for name, _ in PHASES:
            state, _s = runs[name](state)
    torch.cuda.synchronize()
    del state
    log("one iteration: " + ", ".join(
        f"{n} {len(rec.calls[n])} calls at {len(rec.unique(n))} shapes" for n in names))

    errs = dict.fromkeys(KERNELS, 0.0)
    with torch.no_grad():
        for shape, (axis, alpha, gain) in rec.unique("bias_lrelu"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                b = torch.randn(shape[axis], device="cuda", generator=gen).to(dtype)
                e = check_kernel("bias_lrelu", shape,
                                 lambda: ck.bias_lrelu(x, b, axis, alpha, gain),
                                 lambda: fused_bias_act(x, b, axis=axis, act="lrelu",
                                                        alpha=alpha, gain=gain,
                                                        impl="plain"),
                                 dtype, TOL[str(dtype)[6:]])
                if dtype == torch.float32:
                    errs["bias_lrelu"] = max(errs["bias_lrelu"], e)
        for shape, (alpha, gain) in rec.unique("bias_lrelu_grad"):
            for dtype in (torch.float32, torch.bfloat16):
                y = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                e = check_kernel("bias_lrelu_grad", shape,
                                 lambda: ck.bias_lrelu_grad(y, dy, alpha, gain),
                                 lambda: bias_lrelu_grad_plain(y, dy, alpha, gain),
                                 dtype, TOL[str(dtype)[6:]])
                if dtype == torch.float32:
                    errs["bias_lrelu_grad"] = max(errs["bias_lrelu_grad"], e)
        for shape, (f, up, down, pad, gain, counter) in rec.unique("upfirdn2d"):
            f = np.asarray(f, np.float32)
            x = torch.randn(shape, device="cuda", generator=gen)
            e = check_kernel(
                f"{counter} up {up} down {down} pad {pad}", shape,
                lambda: ck.upfirdn2d(x, f, up, down, pad, gain),
                lambda: upfirdn2d(x, f, up=up, down=down, pad=pad, gain=gain,
                                  impl="plain"),
                torch.float32, TOL["float32"])
            errs[counter] = max(errs[counter], e)

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
        difference, limit) for each loss scalar, gradient norm and pl_mean."""
        out = []
        cur = copy.deepcopy(state0)
        for name, opt in PHASES:
            cur, sk = gruns[name](cur)
            for k, v in sk.items():
                ref = float(golden[f"scalar/{name}/{k}"])
                out.append((f"{name} {k}", abs(v.item() - ref) / abs(ref),
                            GOLDEN_SCALAR_RTOL))
            prefix = f"grad_norm/{name}/"
            ref = {k[len(prefix):]: float(golden[k]) for k in golden.files
                   if k.startswith(prefix)}
            m = getattr(cur, opt).m
            if set(ref) != set(m):
                raise RuntimeError(f"{name}: parameters differ from the golden's")
            out += [(f"{name} gradient norm of {k}",
                     abs(m[k].double().norm().item() - ref[k]) / max(ref[k], 1e-30),
                     GOLDEN_NORM_RTOL) for k in ref]
        ref = float(golden["pl_mean"])
        out.append(("pl_mean", abs(cur.pl_mean.item() - ref) / abs(ref),
                    GOLDEN_SCALAR_RTOL))
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
    summary(against_golden())
    # Held: the same iteration with convolutions through PyTorch's own
    # im2col and float32 GEMMs (cuDNN off) and deterministic algorithms.
    torch.backends.cudnn.enabled = False
    torch.use_deterministic_algorithms(True)
    rows = against_golden()
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.enabled = True
    log("convolutions without cuDNN, deterministic algorithms (held):")
    summary(rows)
    for what, diff, limit in rows:
        if not diff <= limit:
            raise RuntimeError(f"{what} disagrees with the JAX golden: relative "
                               f"difference {diff:.3e} over {limit:g}")

    phase("11 times")
    records = []
    with torch.no_grad():
        shape, (alpha, gain) = max(rec.unique("bias_lrelu_grad"),
                                   key=lambda k: math.prod(k[0]))
        y = torch.randn(shape, device="cuda", generator=gen)
        dy = torch.randn(shape, device="cuda", generator=gen)
        ms = device_ms(torch, lambda: ck.bias_lrelu_grad(y, dy, alpha, gain))
        plain_ms = device_ms(torch, lambda: bias_lrelu_grad_plain(y, dy, alpha, gain))
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
        ms = device_ms(torch, kern)
        plain_ms = device_ms(torch, lambda: upfirdn2d(x, f, up=up, down=down, pad=pad,
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
            library_ms = device_ms(torch, lib)
        t_bytes = (x.numel() + y.numel()) * x.element_size() / HBM_BYTES_PER_S
        t_ops = fir_ops(np, shape, f, up, down, pad) / F32_OPS_PER_S
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


def main() -> int:
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
    with torch.no_grad(), Recorder(ck, np) as rec:
        imgs = G(z, randomize_noise=False)
    torch.cuda.synchronize()
    if not torch.isfinite(imgs).all():
        raise RuntimeError("non-finite generator output")
    n_bias = G.mapping.mapping_layers + syn.num_layers - 1
    n_fir = 2 * (syn.resolution_log2 - 2)
    got = (len(rec.calls["bias_lrelu"]), len(rec.calls["upfirdn2d"]))
    log(f"one forward: {got[0]} bias_lrelu and {got[1]} upfirdn2d calls "
        f"(expected {n_bias} and {n_fir})")
    if got != (n_bias, n_fir):
        raise RuntimeError(f"kernel calls per forward {got} != {(n_bias, n_fir)}")

    phase("4 kernels against their plain versions on the card")
    errs = {"bias_lrelu": 0.0, "upfirdn2d": 0.0}
    with torch.no_grad():
        for shape, (axis, alpha, gain) in rec.unique("bias_lrelu"):
            for dtype in (torch.float32, torch.bfloat16):
                atol, rtol = TOL[str(dtype).split(".")[1]]
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                b = torch.randn(shape[axis], device="cuda", generator=gen).to(dtype)
                yk = ck.bias_lrelu(x, b, axis, alpha, gain).float()
                yp = fused_bias_act(x, b, axis=axis, act="lrelu", alpha=alpha,
                                    gain=gain, impl="plain").float()
                err = (yk - yp).abs()
                ok = bool((err <= atol + rtol * yp.abs()).all())
                log(f"bias_lrelu {str(dtype)[6:]:8s} {shape}: max abs err "
                    f"{err.max().item():.3e} (atol {atol:g}, rtol {rtol:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"bias_lrelu disagrees at {shape} {dtype}")
                if dtype == torch.float32:
                    errs["bias_lrelu"] = max(errs["bias_lrelu"], err.max().item())
        atol, rtol = TOL["float32"]
        for shape, (f, up, down, pad, gain, _counter) in rec.unique("upfirdn2d"):
            f = np.asarray(f, np.float32)
            x = torch.randn(shape, device="cuda", generator=gen)
            yk = ck.upfirdn2d(x, f, up, down, pad, gain)
            yp = upfirdn2d(x, f, up=up, down=down, pad=pad, gain=gain, impl="plain")
            err = (yk - yp).abs()
            ok = yk.shape == yp.shape and bool((err <= atol + rtol * yp.abs()).all())
            log(f"upfirdn2d float32 {shape} up {up} down {down} pad {pad} "
                f"gain {gain:g} -> {tuple(yk.shape)}: max abs err "
                f"{err.max().item():.3e} (atol {atol:g}, rtol {rtol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"upfirdn2d disagrees at {shape}")
            errs["upfirdn2d"] = max(errs["upfirdn2d"], err.max().item())

    phase("5 main path: generate-images, 8 images in minibatches of 4")
    ck.reset_launches()
    images = generate_images(G, NUM_IMAGES, MINIBATCH, device="cuda")
    launches = dict(ck.launches)
    n_batches = math.ceil(NUM_IMAGES / MINIBATCH)
    expected = {"bias_lrelu": n_batches * n_bias, "bias_lrelu_grad": 0,
                "upfirdn2d": n_batches * n_fir, "upfirdn2d_transposed": 0}
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
        ms = device_ms(torch, lambda: ck.bias_lrelu(x, b, axis, alpha, gain))
        plain_ms = device_ms(torch, lambda: fused_bias_act(
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
        ms = device_ms(torch, lambda: ck.upfirdn2d(x, f, up, down, pad, gain))
        plain_ms = device_ms(torch, lambda: upfirdn2d(
            x, f, up=up, down=down, pad=pad, gain=gain, impl="plain"))
        y = ck.upfirdn2d(x, f, up, down, pad, gain)
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
            library_ms = device_ms(torch, lambda: torch.nn.functional.conv2d(
                x, w, padding=pad[0], groups=c))
        nbytes = (x.numel() + y.numel()) * x.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = fir_ops(np, shape, f, up, down, pad) / F32_OPS_PER_S
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

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
