"""Ranks of a gloo process group on the CPU, for the port's data-parallel
tests (``tests/test_torch_data_parallel.py``).

``run_ranks`` spawns the ranks, each of which calls a function of this
module and saves what it returns; the caller gets the list by rank. The
ranks import torch and the port only, never JAX: the test hands them numpy
trees and the port's modules.
"""

import copy
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PHASES = (("g_main", "g_opt"), ("g_reg", "g_opt"), ("d_main", "d_opt"),
          ("d_reg", "d_opt"))


def _rank_main(rank, world, root, fn_name, args):
    from inclusivegan_torch.parallel import init_data_parallel
    torch.set_num_threads(1)
    init_data_parallel(rank, world, "file://" + os.path.join(root, "init"), device="cpu")
    try:
        out = globals()[fn_name](rank, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn_name, *args):
    """``fn_name(rank, *args)`` on each of ``world`` gloo CPU ranks; their
    results, by rank."""
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_rank_main, args=(world, root, fn_name, args), nprocs=world,
                           start_method="spawn")
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def several(rank, calls):
    """Each (function name, arguments) of ``calls`` in turn on this rank;
    their results, in order (one spawn for several tests)."""
    return [globals()[name](rank, *args) for name, args in calls]


def _state_arrays(state):
    """Every tensor of a train state, by name, as numpy."""
    out = {f"{k}.{n}": t.detach().numpy().copy()
           for k in ("G", "D", "Gs") for n, t in getattr(state, k).state_dict().items()}
    for k in ("g_opt", "d_opt"):
        opt = getattr(state, k)
        out.update({f"{k}.m.{n}": t.numpy().copy() for n, t in opt.m.items()})
        out.update({f"{k}.v.{n}": t.numpy().copy() for n, t in opt.v.items()})
        out[f"{k}.count"] = opt.count.numpy().copy()
    out["pl_mean"] = state.pl_mean.numpy().copy()
    return out


def _iteration(nets, lpips_tree, batch, draws, cfg, group, g_lr, d_lr, gs_beta,
               rec_weight):
    """One iteration, phase by phase, from the nets (G, D, Gs): after each
    phase (scalars as floats, the phase's first Adam moment), and every
    tensor of the state at the end."""
    from inclusivegan_torch.models.lpips import lpips_params_from_numpy
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.train_step import make_train_step
    G, D, Gs = copy.deepcopy(nets)
    state = create_train_state(G, D, Gs)
    step = make_train_step(G, D, lpips_params_from_numpy(lpips_tree, "cpu"), cfg,
                           device="cpu", impl="plain", group=group)
    ph = step.phases
    tb = ph["to_device"](batch)
    after = []
    for (name, opt), fn in zip(PHASES, (
            lambda s: ph["g_step"](s, tb, draws["g"], g_lr, rec_weight),
            lambda s: ph["g_reg_step"](s, draws["g_reg"], g_lr),
            lambda s: ph["d_step"](s, tb, draws["d"], d_lr, gs_beta),
            lambda s: ph["d_reg_step"](s, tb, draws["d_reg"], d_lr))):
        state, scalars = fn(state)
        after.append(dict(scalars={k: float(v) for k, v in scalars.items()},
                          m={k: v.numpy().copy() for k, v in getattr(state, opt).m.items()},
                          count=int(getattr(state, opt).count)))
    return after, _state_arrays(state)


def golden_rank(rank, nets, lpips_tree, golden_path, configs, cfg_fields, hparams,
                flat_nets):
    """Each configuration of the two-device golden on this rank: its slice
    of the global batch, its own draws, reduced over the group. On rank 0
    also the iteration of configuration 0 with no group and with a group
    of rank 0 alone, for their bits. Then ``invariant_rng`` on
    ``flat_nets`` (no minibatch stddev) with the port's own draws, and on
    rank 0 the same iteration of the whole batch in one process. Returns
    {config: (after, state)}, (no group, group of one) and (this rank's
    invariant iteration, the one process's)."""
    from inclusivegan_torch.training.train_step import (TrainConfig, draw_train_step,
                                                        unflatten_draws)
    golden = np.load(golden_path)
    world = dist.get_world_size()
    batch = {k[len("batch/"):]: golden[k] for k in golden.files if k.startswith("batch/")}
    local = {k: v[rank * len(v) // world:(rank + 1) * len(v) // world]
             for k, v in batch.items()}
    out = {}
    draws = {}
    for name in configs:
        pre = f"{name}/draws{rank}/"
        draws[name] = unflatten_draws(
            {k[len(pre):]: golden[k] for k in golden.files if k.startswith(pre)})
        cfg = TrainConfig(**cfg_fields, **configs[name])
        out[name] = _iteration(nets, lpips_tree, local, draws[name], cfg,
                               dist.group.WORLD, *hparams)
    solo = dist.new_group([0])
    bits = None
    if rank == 0:
        name = next(iter(configs))
        cfg = TrainConfig(**cfg_fields, **configs[name])
        bits = tuple(_iteration(nets, lpips_tree, local, draws[name], cfg, g, *hparams)[1]
                     for g in (None, solo))
    cfg = TrainConfig(**cfg_fields, invariant_rng=True)
    G = flat_nets[0]
    mb = len(local["latents_rec_1"])

    def inv_draws(n, offset):
        return draw_train_step(G, n, torch.Generator().manual_seed(5), cfg,
                               example_offset=offset, device="cpu")
    invariant = (_iteration(flat_nets, lpips_tree, local, inv_draws(mb, rank * mb), cfg,
                            dist.group.WORLD, *hparams),
                 _iteration(flat_nets, lpips_tree, batch, inv_draws(world * mb, 0), cfg,
                            None, *hparams) if rank == 0 else None)
    return out, bits, invariant


def sampler_rank(rank, network_pkl, latents, minibatch):
    """Rank 0's images of ``latents`` from a GsSampler split over the
    group (None on the other ranks, which serve)."""
    from inclusivegan_torch.metrics.metric_base import GsSampler
    sampler = GsSampler(network_pkl, minibatch_size=minibatch, device="cpu")
    if rank != 0:
        sampler.serve()
        return None
    try:
        return sampler.run(latents)
    finally:
        sampler.close()


def metric_rank(rank, args, network_pkl, run_dir):
    """``metric_base.run_metric`` on each rank: rank 0 evaluates and writes
    ``run_dir``, the others serve its sampler and return {}."""
    from inclusivegan_torch.metrics import metric_base
    return metric_base.run_metric(args, network_pkl=network_pkl, run_dir=run_dir,
                                  device="cpu", mirror_augment=False)


def mean_pixel_metric(name, num_images, minibatch_per_gpu):
    """A metric whose feature is each fake's mean pixel (``run_metric``
    builds it by this name): the metric framework's path through the
    sampler, without a feature net."""
    from inclusivegan_torch.metrics.metric_base import MetricBase

    class MeanPixel(MetricBase):
        def _evaluate(self, sampler, dataset_args, data_dir, **kwargs):
            means = self._fakes_through(
                sampler, num_images,
                lambda imgs: imgs.reshape(len(imgs), -1).mean(1, dtype=np.float64),
                minibatch_per_gpu)
            self._report_result(float(means.mean()))
    return MeanPixel(name)
