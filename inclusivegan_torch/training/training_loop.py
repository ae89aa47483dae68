"""The training loop, ported from
``inclusivegan_tpu/training/training_loop.py``, with the same arguments and
defaults, on one card or as one rank of a data-parallel process group.

The run dir gets what the JAX loop writes: ``log.txt`` (through the run
harness), ``stats.jsonl`` and TensorBoard events, the ``arb-reals.png`` /
``arb-fakes-%06d.png`` / ``rec-reals.png`` / ``rec-fakes-%06d.png`` grids,
``network-snapshot-%06d.pkl`` with a full-state checkpoint beside it
(``checkpoints/step_%08d``) and ``network-final.pkl``, and, after each
network snapshot, the line of each metric of ``metric_arg_list`` in
``metric-<name>.txt`` (a metric that fails is printed and training goes on);
an ``abort.txt`` stops the run at the next outer iteration (with several
ranks, at the first one after the next tick).

The control flow is the JAX loop's: the schedule per outer iteration of
``minibatch_repeats`` steps, the lazy-regularizer cadence from the running
minibatch counter, the IMLE rebuild at each staleness boundary (the
prefetcher stopped first), the Gs EMA beta with the resume ramp
(``beta ** ramp``), the ``rec_weight_final`` ramp, ticks, snapshots and
resume from a snapshot or a checkpoint. Host randomness is numpy's, seeded
as there (``np.random.seed(seed)``); the card's comes from explicit
``torch.Generator``s derived from ``seed`` in place of the JAX keys: network
init ``seed``, the steps ``seed + 11``, candidate generation ``seed + 7``,
the snapshot grids ``seed + 13`` and the grid latents ``seed + 17``.

``G_args.dtype`` and ``D_args.dtype`` ("bfloat16") set the networks'
compute dtype on a fresh init, and ``G_args.dtype`` the LPIPS trunk's. A
resume from a snapshot, as in the JAX package, builds G and D from the
snapshot's configs without their dtype: they compute in float32 while
LPIPS keeps ``G_args.dtype``.

The loss scalars stay on the card and are read to the host only where the
JAX loop reads them (iterations 1, 2 and every 8th). Batches are assembled
as numpy arrays, inline or on the prefetcher's thread, and copied to the
card by the train step on this thread. The card's peak memory
(``torch.cuda.max_memory_allocated``) is reported at each tick.

A minibatch over ``minibatch_gpu`` per device trains by gradient
accumulation (``grad_accum_rounds``, printed as in the JAX loop);
``invariant_rng`` keys every draw by the global example index, its step
generator then on the host; ``knn_backend`` picks the IMLE retrieval
(``exact``, ``dci`` or ``auto``, routed as in the JAX package).

Data parallelism: inside a ``torch.distributed`` process group (started by
``utils.run_harness.submit_run``) ``num_devices`` is the group's world size,
and the minibatch is global. Every rank runs the same seeded host streams
and assembles the whole global batch, keeping its own slice, as the JAX
loop shards it; each rank draws from its own step generator (the same one
under ``invariant_rng``); the train step averages over the ranks. Rank 0
alone runs the IMLE rebuild and broadcasts the selection, and alone writes
the run dir (stats, events, image grids, snapshots, checkpoints); the other
ranks serve its metrics' Gs samplers. At the end the ranks check that their
replicas hold the same bytes. Each metric of ``metric_arg_list`` is built
once before the networks, so that a bad argument raises first.
"""

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel
from ..data.dataset import Prefetcher, load_dataset
from ..data.dataset_tool import load_celeba_attributes
from ..metrics.metric_defaults import check_metric_args
from ..models.lpips import get_lpips_params
from ..models.stylegan2 import Discriminator, GMain
from ..snapshot import load_networks, snapshot_dict
from ..utils import misc
from ..utils.network_util import print_layers
from ..utils.run_harness import RunContext
from ..utils.stats import StatsCollector
from ..utils.tfevents import EventWriter
from .imle import IMLEOrchestrator
from .schedule import resume_rampup_scale, training_schedule
from .train_state import create_train_state, params_of
from .train_step import TrainConfig, make_train_step

__all__ = ["training_loop", "load_snapshot", "snapshot_dict",
           "setup_snapshot_image_grid"]


def setup_snapshot_image_grid(dataset, size="1080p"):
    """The grid of the image snapshots: (gw, gh) and the first gw * gh
    images of the dataset's stream."""
    gw, gh = 8, 4
    if size == "1080p":
        gw = np.clip(1920 // dataset.shape[2], 3, 32)
        gh = np.clip(1080 // dataset.shape[1], 2, 32)
    if size == "4k":
        gw = np.clip(3840 // dataset.shape[2], 7, 32)
        gh = np.clip(2160 // dataset.shape[1], 4, 32)
    if size == "8k":
        gw = np.clip(7680 // dataset.shape[2], 7, 32)
        gh = np.clip(4320 // dataset.shape[1], 4, 32)
    reals, labels = dataset.get_minibatch_np(gw * gh)
    return (gw, gh), reals, labels


def load_snapshot(path: str, device="cuda"):
    """-> (G, D, {"g_params", "d_params", "gs_params"}): the snapshot's
    networks on ``device`` and the state's parameters as name -> tensor
    dicts, all in their stored dtype (the CelebA snapshot's float16)."""
    G, D, Gs = load_networks(path, device)
    return G, D, {name: {k: v.detach() for k, v in params_of(m).items()}
                  for name, m in (("g_params", G), ("d_params", D), ("gs_params", Gs))}


def _check_run(num_devices, metric_arg_list):
    """Before anything loads: ``num_devices`` must be the process group's
    world size (1 outside a group), and every metric must build."""
    world = parallel.world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but this process is one of "
                         f"{world} ranks: start the ranks with "
                         "utils.run_harness.submit_run (SubmitConfig.num_devices)")
    check_metric_args(metric_arg_list)


class _Discard:
    """Stats and events of a rank that does not write: every call does
    nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: {}


def _shard(batch, rank, world):
    """This rank's contiguous slice of each array of the global batch."""
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // world
        out[k] = np.ascontiguousarray(v[rank * n:(rank + 1) * n])
    return out


def _broadcast_state(state):
    """Rank 0's networks on every rank, so that the replicas start alike."""
    parallel.broadcast_(t for m in (state.G, state.D, state.Gs)
                        for t in m.state_dict().values())


def step_seed(seed: int, rank: int) -> int:
    """The seed of a rank's step generator: ``seed + 11`` on rank 0, as on
    one card; a stream of its own, derived from both, on each other rank."""
    if rank == 0:
        return seed + 11
    return int(np.random.SeedSequence(seed + 11, spawn_key=(rank,)).generate_state(
        1, np.uint64)[0] >> 1)


def training_loop(
    submit_config=None,
    G_args: dict = {},
    D_args: dict = {},
    G_opt_args: dict = {},
    D_opt_args: dict = {},
    G_loss_args: dict = {},
    D_loss_args: dict = {},
    dataset_args: dict = {},
    sched_args: dict = {},
    grid_args: dict = {},
    metric_arg_list: list = [],
    data_dir: Optional[str] = None,
    G_smoothing_kimg: float = 10.0,
    minibatch_repeats: int = 4,
    lazy_regularization: bool = True,
    G_reg_interval: int = 4,
    D_reg_interval: int = 16,
    total_kimg: int = 25000,
    mirror_augment: bool = False,
    drange_net=(-1, 1),
    resume_pkl: Optional[str] = None,
    resume_checkpoint: Optional[str] = None,  # a step_* dir, a checkpoints/
    # dir or a run dir that holds checkpoints/
    resume_staleness: Optional[int] = None,  # override the restored IMLE
    # staleness on resume from a checkpoint
    resume_lrate_rampup_kimg: float = 0.0,  # after --resume-pkl (fresh Adam
    # moments): learning rates ramp linearly from 0 over this many kimg past
    # the resume point, and the Gs EMA slows by the same ramp (beta**ramp)
    resume_g_from_gs: bool = False,  # start training G from the snapshot's Gs
    data_size: int = 3000,
    num_epochs: int = 10000,
    init_proj_dim: Optional[int] = None,
    init_staleness: int = 10,
    num_samples_factor: int = 25,
    knn_perturb_factor: float = 0.1,
    knn_backend: str = "auto",
    candidate_batch_size: int = 256,
    exclusive_retrieved_code: int = 0,
    rec_weight_final: Optional[float] = None,  # ramp NN_rec_lpips_weight from
    # its base (G_loss_args) to this value, linearly over
    # [rec_weight_ramp_start_kimg, rec_weight_ramp_end_kimg]
    rec_weight_ramp_start_kimg: float = 0.0,
    rec_weight_ramp_end_kimg: float = 0.0,
    dist_thres_percentile: float = 100.0,
    attr_interesting: Optional[str] = None,
    lpips_weights_path: Optional[str] = None,
    lpips_norm: Optional[str] = None,  # "f32" (default) or "trunk": the LPIPS
    # tap maps normalized in float32 or in the trunk's dtype
    image_snapshot_ticks: Optional[int] = None,
    network_snapshot_ticks: Optional[int] = None,
    num_devices: Optional[int] = None,
    seed: int = 1000,
    smoke_test_max_iters: Optional[int] = None,
    prefetch_depth: int = 2,  # batches assembled ahead on a thread (0 = inline)
    enable_profiler: bool = False,  # torch.profiler over iterations 8-16
    save_full_checkpoints: bool = True,
    invariant_rng: bool = False,
    device="cuda",
):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to train "
                           "on the CPU")
    _check_run(num_devices, metric_arg_list)
    world, rank, main = parallel.world_size(), parallel.rank(), parallel.is_main()
    group = torch.distributed.group.WORLD if parallel.active() else None

    # ------------------------------------------------------------ datasets
    # Both streams iterate in a fixed order: the IMLE cursor arithmetic
    # depends on it.
    training_set = load_dataset(data_dir=data_dir, verbose=True,
                                shuffle=False, **dataset_args)
    training_set_rec = load_dataset(data_dir=data_dir, verbose=False,
                                    shuffle=False, **dataset_args)
    image_dim = int(np.prod(training_set.shape))

    run_dir = submit_config.run_dir if submit_config is not None else "."
    stats = StatsCollector(run_dir) if main else _Discard()
    events = EventWriter(run_dir) if main else _Discard()
    ctx = RunContext(submit_config) if submit_config is not None and main else None
    np.random.seed(seed)

    if image_snapshot_ticks is None:
        image_snapshot_ticks = max(data_size // 1000, 1)
    if network_snapshot_ticks is None:
        network_snapshot_ticks = max(data_size // 1000 * 5, 1)

    # every rank draws the grid, so that the data streams stay in step
    grid_size, grid_reals, grid_labels = setup_snapshot_image_grid(
        training_set, **grid_args)
    if main:
        misc.save_image_grid(grid_reals, os.path.join(run_dir, "arb-reals.png"),
                             drange=training_set.dynamic_range, grid_size=grid_size)

    attr_names = None
    if attr_interesting is not None:
        attr_file = "celeba/Anno/list_attr_celeba.txt"
        assert os.path.isfile(attr_file), attr_file
        attr_names, _ = load_celeba_attributes(attr_file)

    # ------------------------------------------------------------ networks
    resume_kimg = 0.0
    resume_time = 0.0  # the earlier runs' seconds, read from their log.txt
    resume_state_params = None
    if resume_pkl is None:
        print("Constructing networks...")
        G = GMain.create(num_channels=training_set.shape[0],
                         resolution=training_set.shape[1],
                         label_size=training_set.label_size, **G_args)
        D = Discriminator(num_channels=training_set.shape[0],
                          resolution=training_set.shape[1],
                          label_size=training_set.label_size, **D_args)
    else:
        print(f'Loading networks from "{resume_pkl}"...')
        G, D, resume_state_params = load_snapshot(resume_pkl, dev)
        resume_kimg, resume_time = misc.parse_kimg_time_from_log(
            os.path.join(os.path.dirname(resume_pkl), "log.txt"))

    lpips_params = get_lpips_params(lpips_weights_path, dev)

    if resume_g_from_gs and resume_state_params is not None:
        print("Resume: initializing G from the Gs (EMA) weights")
    state = create_train_state(
        G.to(dev), D.to(dev), generator=torch.Generator(dev).manual_seed(seed),
        params=resume_state_params,
        g_from_gs=resume_g_from_gs and resume_state_params is not None)

    imle_restore = {}
    if resume_checkpoint is not None:
        from .checkpoint import latest_checkpoint, load_checkpoint
        ckpt = resume_checkpoint
        if os.path.isdir(ckpt) and not os.path.basename(
                ckpt.rstrip("/")).startswith("step_"):
            ckpt = (latest_checkpoint(ckpt) or
                    latest_checkpoint(os.path.join(resume_checkpoint, "checkpoints")))
        assert ckpt, f"no checkpoint under {resume_checkpoint}"
        print(f'Restoring full training state from "{ckpt}"...')
        state, imle_restore = load_checkpoint(ckpt, state)
        # checkpoint dirs are named step_<cur_nimg>
        resume_kimg = int(os.path.basename(ckpt.rstrip("/"))[len("step_"):]) / 1000.0

    if resume_state_params is not None and resume_lrate_rampup_kimg > 0:
        print(f"Resume lr rampup: 0 -> base over {resume_lrate_rampup_kimg:g}"
              f" kimg past {resume_kimg:.1f} (fresh Adam moments)")

    _broadcast_state(state)
    print_layers(state.G, "G")
    print_layers(state.D, "D")
    print(f"device: {dev}")
    print(f"devices: {world}")

    # ------------------------------------------------------------ IMLE
    imle = IMLEOrchestrator(
        data_size=data_size, num_samples_factor=num_samples_factor,
        latent_size=G.mapping.latent_size, image_dim=image_dim,
        init_proj_dim=init_proj_dim, init_staleness=init_staleness,
        knn_perturb_factor=knn_perturb_factor, knn_backend=knn_backend,
        candidate_batch_size=candidate_batch_size,
        exclusive_retrieved_code=bool(exclusive_retrieved_code),
        dist_thres_percentile=dist_thres_percentile,
        attr_interesting=attr_interesting, attr_names=attr_names,
        drange_data=training_set.dynamic_range, drange_net=drange_net,
        projector_cache_dir=run_dir if main else None, seed=seed, device=dev)
    if imle_restore:
        imle.cursor = int(imle_restore.get("cursor", imle.cursor))
        imle.staleness = int(imle_restore.get("staleness", imle.staleness))
    if resume_staleness is not None and resume_checkpoint is not None:
        print(f"IMLE staleness override on resume: {imle.staleness} -> "
              f"{resume_staleness}")
        imle.staleness = int(resume_staleness)

    label_size = G.mapping.label_size
    sample_gen = torch.Generator(dev).manual_seed(seed + 7)

    def generate_images(latents_np):
        """Candidates from the live G in eval mode, padded to
        ``candidate_batch_size``; the images stay on the card."""
        n = latents_np.shape[0]
        bs = candidate_batch_size
        if n < bs:
            latents_np = np.concatenate(
                [latents_np, np.zeros((bs - n, latents_np.shape[1]), latents_np.dtype)])
        with torch.no_grad():
            z = torch.as_tensor(latents_np, device=dev)
            out = state.G(z, torch.zeros((z.shape[0], label_size), device=dev),
                          truncation_psi=None, generator=sample_gen)
        return out[:n]

    # ------------------------------------------------------------ train step
    # gradient-accumulation rounds = minibatch_size / (minibatch_gpu x
    # devices); the resolution is fixed, so the count is too
    sched0 = training_schedule(cur_nimg=int(resume_kimg * 1000),
                               resolution_log2=training_set.resolution_log2,
                               **sched_args)
    num_dev = world
    grad_accum_rounds = max(sched0.minibatch_size // num_dev // sched0.minibatch_gpu, 1)
    if grad_accum_rounds > 1:
        assert sched0.minibatch_size % (sched0.minibatch_gpu * num_dev) == 0, \
            (sched0.minibatch_size, sched0.minibatch_gpu, num_dev)
        print(f"gradient accumulation: {grad_accum_rounds} rounds of "
              f"{sched0.minibatch_gpu}/device")

    cfg = TrainConfig(
        grad_accum_rounds=grad_accum_rounds,
        NN_rec_lpips_weight=G_loss_args.get("NN_rec_lpips_weight", 2.5),
        **({"g_loss_batched": G_loss_args["batched"]}
           if "batched" in G_loss_args else {}),
        lpips_norm=lpips_norm,
        gamma=D_loss_args.get("gamma", 10.0),
        G_reg_interval=G_reg_interval, D_reg_interval=D_reg_interval,
        adam_beta1=G_opt_args.get("beta1", 0.0),
        adam_beta2=G_opt_args.get("beta2", 0.99),
        adam_eps=G_opt_args.get("epsilon", 1e-8),
        mirror_augment=mirror_augment,
        drange_data=tuple(float(v) for v in training_set.dynamic_range),
        lazy_regularization=lazy_regularization,
        lpips_dtype=G_args.get("dtype"),
        invariant_rng=invariant_rng,
        donate_state=True)
    train_step = make_train_step(G, D, lpips_params, cfg, device=dev, group=group)

    grid_latents = np.random.default_rng(seed + 17).standard_normal(
        (int(np.prod(grid_size)), G.mapping.latent_size), dtype=np.float32)

    print(f"Training for {total_kimg} kimg...\n")
    cur_nimg = int(resume_kimg * 1000)
    cur_tick = -1
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    # offset by the earlier runs' seconds, so that the time column goes on
    train_start_time = tick_start_time - resume_time
    running_mb_counter = 0
    # invariant_rng draws on the host: its generator lives there, so that
    # reading the phase seeds does not wait for the card; its seeds are the
    # same on every rank, which offsets the examples by its rank
    step_gen = torch.Generator("cpu" if invariant_rng else dev).manual_seed(
        seed + 11 if invariant_rng else step_seed(seed, rank))
    iters_done = 0
    profiler = None

    def _assemble_batch(mb):
        """One iteration's host work, numpy only: the IMLE rec batches and
        the real minibatch. Runs inline or on the prefetcher's thread (the
        sole consumer of both dataset streams while it is open)."""
        r1, l1, z1, r2, l2, z2 = imle.next_rec_batch(training_set_rec, mb)
        reals, labels = training_set.get_minibatch_np(mb * 2)
        return _shard({"reals_rec_1": r1, "labels_rec_1": l1, "latents_rec_1": z1,
                       "reals_rec_2": r2, "labels_rec_2": l2, "latents_rec_2": z2,
                       "reals": reals, "labels": labels}, rank, world)

    prefetcher = None
    prefetch_mb = None

    def _stop_prefetcher():
        nonlocal prefetcher
        if prefetcher is not None:
            prefetcher.close()
            prefetcher = None

    stop = False
    while cur_nimg < total_kimg * 1000:
        # one rank reads abort.txt every iteration; several ranks read rank
        # 0's at ticks, where the card has been waited for already, so that
        # every rank stops at the same iteration and no iteration waits
        if world == 1:
            stop = ctx is not None and ctx.should_stop()
        if stop:
            break
        sched = training_schedule(cur_nimg=cur_nimg,
                                  resolution_log2=training_set.resolution_log2,
                                  **sched_args)
        if resume_state_params is not None and resume_lrate_rampup_kimg > 0:
            ramp = resume_rampup_scale(cur_nimg / 1000.0, resume_kimg,
                                       resume_lrate_rampup_kimg)
            sched.G_lrate *= ramp
            sched.D_lrate *= ramp
        mb = sched.minibatch_size
        assert data_size % (mb * 2) == 0, (data_size, mb)
        assert mb % world == 0, (mb, world)

        for _repeat in range(minibatch_repeats):
            run_G_reg = (lazy_regularization and
                         running_mb_counter % G_reg_interval == 0)
            run_D_reg = (lazy_regularization and
                         running_mb_counter % D_reg_interval == 0)

            if imle.needs_rebuild(cur_nimg, mb * 2):
                # join the worker first: the rebuild changes the IMLE pool
                # that the assembly reads (queued batches are dropped)
                _stop_prefetcher()
                t0 = time.time()
                if main:  # one rebuild, as on the JAX package's controller
                    imle.rebuild(generate_images, training_set_rec)
                if world > 1:
                    sel = parallel.broadcast_object(imle.selection() if main else None)
                    if not main:
                        imle.set_selection(sel)
                stats.report("Timing/dci_rebuild_sec", time.time() - t0)

            if prefetch_mb != mb:  # minibatch changed: the closure is stale
                _stop_prefetcher()
                prefetch_mb = mb
            if prefetch_depth > 0 and prefetcher is None:
                prefetcher = Prefetcher(lambda m=mb: _assemble_batch(m),
                                        depth=prefetch_depth)
            batch = (prefetcher.get() if prefetcher is not None
                     else _assemble_batch(mb))
            gs_beta = (0.5 ** (mb / (G_smoothing_kimg * 1000.0))
                       if G_smoothing_kimg > 0 else 0.0)
            if resume_state_params is not None \
                    and resume_lrate_rampup_kimg > 0 and G_smoothing_kimg > 0:
                # beta**ramp: a frozen EMA at ramp 0, its half-life
                # stretched 1/ramp times until the warm-up ends
                gs_beta = gs_beta ** resume_rampup_scale(
                    cur_nimg / 1000.0, resume_kimg, resume_lrate_rampup_kimg)
            rec_w = None
            if rec_weight_final is not None:
                lo, hi = rec_weight_ramp_start_kimg, rec_weight_ramp_end_kimg
                t = 1.0 if hi <= lo else float(np.clip(
                    (cur_nimg / 1000.0 - lo) / (hi - lo), 0.0, 1.0))
                rec_w = (1.0 - t) * cfg.NN_rec_lpips_weight + t * rec_weight_final
            state, scalars = train_step(
                state, batch, step_gen, sched.G_lrate, sched.D_lrate, gs_beta,
                do_g_reg=run_G_reg, do_d_reg=run_D_reg, rec_weight=rec_w)

            cur_nimg += mb
            running_mb_counter += 1
            iters_done += 1
            if enable_profiler and main and iters_done == 8:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])])
                profiler.start()
            if enable_profiler and main and iters_done == 16:
                profiler.stop()
                os.makedirs(os.path.join(run_dir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(os.path.join(run_dir, "profile", "trace.json"))
                profiler = None
            if main and (iters_done % 8 == 0 or iters_done <= 2) and scalars:
                # one copy of all the scalars instead of one wait per scalar
                names = list(scalars)
                values = torch.stack([scalars[k].float() for k in names]).cpu().tolist()
                stats.report_dict(dict(zip(names, values)))
            if smoke_test_max_iters and iters_done >= smoke_test_max_iters:
                break
        if smoke_test_max_iters and iters_done >= smoke_test_max_iters:
            break

        # ------------------------------------------------------------ ticks
        done = cur_nimg >= total_kimg * 1000
        if cur_nimg >= tick_start_nimg + sched.tick_kimg * 1000 or done:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the tick's time includes its work
            cur_tick += 1
            tick_kimg = (cur_nimg - tick_start_nimg) / 1000.0
            tick_time = time.time() - tick_start_time
            total_time = time.time() - train_start_time
            print(f"tick {cur_tick:<5d} kimg {cur_nimg / 1000.0:<8.1f} "
                  f"lod 0.00 minibatch {mb:<4d} "
                  f"time {misc.format_time(total_time):<12s} "
                  f"sec/tick {tick_time:<7.1f} "
                  f"sec/kimg {tick_time / max(tick_kimg, 1e-8):<7.2f}")
            stats.report("Progress/G_lrate", sched.G_lrate)
            stats.report("Progress/D_lrate", sched.D_lrate)
            stats.report("Timing/sec_per_tick", tick_time)
            stats.report("Timing/sec_per_kimg", tick_time / max(tick_kimg, 1e-8))
            if dev.type == "cuda":
                stats.report("Resources/peak_device_mem_gb",
                             torch.cuda.max_memory_allocated(dev) / 2.0 ** 30)
            events.add_scalars(stats.flush(step=cur_nimg), step=cur_nimg)
            events.flush()
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if ctx is not None:
                ctx.update(cur_epoch=cur_nimg / 1000.0, max_epoch=total_kimg)

            if main and (cur_tick % image_snapshot_ticks == 0 or done):
                t0 = time.time()
                _save_image_snapshots(state, grid_latents, grid_size, imle, run_dir,
                                      cur_nimg, training_set, drange_net, seed, dev)
                stats.report("Timing/image_snapshot_sec", time.time() - t0)
            if cur_tick % network_snapshot_ticks == 0 or done:
                path = os.path.join(run_dir,
                                    f"network-snapshot-{cur_nimg // 1000:06d}.pkl")
                t0 = time.time()
                if main:
                    misc.save_pkl(snapshot_dict(G, D, state), path)
                stats.report("Timing/snapshot_sec", time.time() - t0)
                if save_full_checkpoints and main:
                    from .checkpoint import save_checkpoint
                    t0 = time.time()
                    save_checkpoint(
                        os.path.join(run_dir, "checkpoints"), state,
                        imle_state={"cursor": int(imle.cursor),
                                    "staleness": int(imle.staleness)},
                        step=cur_nimg)
                    stats.report("Timing/checkpoint_sec", time.time() - t0)
                if metric_arg_list:
                    parallel.barrier()  # the snapshot is on disk for every rank
                    t0 = time.time()
                    _run_metrics(metric_arg_list, path, dataset_args, data_dir, run_dir,
                                 mirror_augment, dev)
                    stats.report("Timing/metrics_sec", time.time() - t0)
            if world > 1:
                stop = parallel.broadcast_object(ctx is not None and ctx.should_stop())

    _stop_prefetcher()
    if profiler is not None:
        profiler.stop()
    if world > 1:
        same = parallel.replicas_identical(
            [t for m in (state.G, state.D, state.Gs) for t in m.state_dict().values()]
            + [t for opt in (state.g_opt, state.d_opt) for t in (*opt.m.values(),
                                                                  *opt.v.values())]
            + [state.pl_mean])
        print(f"replicas: {world} ranks, G, D, Gs and Adam moments "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError(f"the {world} ranks' replicas differ at the end of the run")
    if main:
        misc.save_pkl(snapshot_dict(G, D, state),
                      os.path.join(run_dir, "network-final.pkl"))
    events.add_scalars(stats.flush(step=cur_nimg), step=cur_nimg)
    events.close()
    stats.close()
    if ctx is not None:
        ctx.close()
    return state


def _run_metrics(metric_arg_list, snapshot_path, dataset_args, data_dir, run_dir,
                 mirror_augment, dev):
    """Each metric on the snapshot just written; a metric that fails is
    printed, and training goes on."""
    from ..metrics import metric_base
    for args in metric_arg_list:
        try:
            metric_base.run_metric(args, network_pkl=snapshot_path,
                                   dataset_args=dataset_args, data_dir=data_dir,
                                   run_dir=run_dir, mirror_augment=mirror_augment,
                                   device=dev)
        except Exception as e:  # metrics must not stop training
            print(f"metric {args.get('name', '?')} failed: {e}")


def _sample(Gs, z, label_size, psi, generator, dev, bs=None):
    """Gs images of latents ``z`` (numpy), in batches of ``bs`` padded with
    zeros, as a numpy array."""
    n = z.shape[0]
    bs = bs or n
    outs = []
    with torch.no_grad():
        for i in range(0, n, bs):
            zi = z[i:i + bs]
            pad = bs - zi.shape[0]
            if pad:
                zi = np.concatenate([zi, np.zeros((pad, zi.shape[1]), zi.dtype)])
            img = Gs(torch.as_tensor(zi, device=dev),
                     torch.zeros((bs, label_size), device=dev),
                     truncation_psi=psi, generator=generator)
            outs.append(img[:bs - pad].float().cpu().numpy())
    return np.concatenate(outs)


def _save_image_snapshots(state, grid_latents, grid_size, imle, run_dir, cur_nimg,
                          training_set, drange_net, seed, dev):
    label_size = state.Gs.mapping.label_size
    gen = torch.Generator(dev).manual_seed(seed + 13)
    fakes = _sample(state.Gs, grid_latents, label_size, 0.6, gen, dev, bs=64)
    misc.save_image_grid(fakes, os.path.join(run_dir, f"arb-fakes-{cur_nimg // 1000:06d}.png"),
                         drange=drange_net, grid_size=grid_size)
    if imle.tick_rec_batch is not None:
        reals, labels, latents = imle.tick_rec_batch
        misc.save_image_grid(
            misc.adjust_dynamic_range(reals.astype(np.float32),
                                      training_set.dynamic_range, drange_net),
            os.path.join(run_dir, "rec-reals.png"), drange=drange_net)
        img = _sample(state.Gs, latents, label_size, 1.0, gen, dev)
        misc.save_image_grid(img, os.path.join(run_dir, f"rec-fakes-{cur_nimg // 1000:06d}.png"),
                             drange=drange_net)
