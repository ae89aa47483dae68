#!/usr/bin/env python3
"""One process of a two-process ``torch.distributed`` training step: the
port's ``scripts/multihost_worker.py``.

Separate OS processes (two hosts, or two processes of one) join one process
group over ``tcp://`` (``--coordinator host:port``): gloo on the CPU, NCCL on
cards (``cuda`` binds card ``--process-id`` of its host). Each rank takes
its slice of one global batch through the port's ``train_step`` on narrow
16 px networks made from a seed (16 px is the smallest resolution the
LPIPS trunk takes), with both lazy regularizers; the gradients are reduced
over the group. Every rank then writes, as JSON, the sha256 over its state
after the step (G's, D's and Gs's parameters and buffers, both Adam states,
``pl_mean``) and the loss scalars, averaged over the ranks: every rank must
hold the same bytes. ``run_step`` is the same step for the ranks that
``utils.run_harness.submit_run`` spawns (``SubmitConfig.num_devices``).

On the CPU each process computes on one intra-op thread, so that the sums
of every launch of the step come out in the same order.

    python -m inclusivegan_torch.scripts.multihost_worker --process-id 0 \\
        --num-processes 2 --coordinator 127.0.0.1:PORT --out w0.json [--device cpu]
"""

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

RES, ZDIM, PER_RANK = 16, 8, 2
SEED = 0


def networks(device):
    """The narrow G and D, their parameters drawn from ``SEED``, and the
    seeded random-feature LPIPS trunk."""
    import torch

    from inclusivegan_torch.models.lpips import lpips_params_from_numpy, random_lpips_tree
    from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
    from inclusivegan_torch.training.train_state import create_train_state
    G = GMain.create(resolution=RES, num_channels=3, latent_size=ZDIM, dlatent_size=ZDIM,
                     fmap_base=64, fmap_max=8, mapping_layers=1, mapping_fmaps=8).to(device)
    D = Discriminator(resolution=RES, num_channels=3, fmap_base=64, fmap_max=8,
                      mbstd_group_size=1).to(device)
    state = create_train_state(G, D, generator=torch.Generator(device).manual_seed(SEED))
    return G, D, state, lpips_params_from_numpy(random_lpips_tree(1), device)


def global_batch(world):
    """One seeded global batch of ``world * PER_RANK`` (``reals``: twice
    that), as the worker of every rank draws it."""
    import numpy as np
    mb = world * PER_RANK
    r = np.random.RandomState(1)
    return {
        "reals_rec_1": r.randint(0, 256, (mb, 3, RES, RES)).astype(np.uint8),
        "latents_rec_1": r.randn(mb, ZDIM).astype(np.float32),
        "labels_rec_1": np.zeros((mb, 0), np.float32),
        "reals_rec_2": r.randint(0, 256, (mb, 3, RES, RES)).astype(np.uint8),
        "latents_rec_2": r.randn(mb, ZDIM).astype(np.float32),
        "labels_rec_2": np.zeros((mb, 0), np.float32),
        "reals": r.randint(0, 256, (2 * mb, 3, RES, RES)).astype(np.uint8),
        "labels": np.zeros((2 * mb, 0), np.float32),
    }


def step_digest(device):
    """One training step of this rank in the live process group; returns
    its record (rank, world, sha256 of the state, the scalars)."""
    import torch

    from inclusivegan_torch import parallel
    from inclusivegan_torch.training.train_state import params_of
    from inclusivegan_torch.training.train_step import TrainConfig, make_train_step
    from inclusivegan_torch.training.training_loop import _shard, step_seed
    rank, world = parallel.rank(), parallel.world_size()
    G, D, state, lpips = networks(device)
    batch = _shard(global_batch(world), rank, world)
    step = make_train_step(G, D, lpips, TrainConfig(mirror_augment=False), device=device,
                           group=torch.distributed.group.WORLD)
    gen = torch.Generator(device).manual_seed(step_seed(2, rank))
    state, scalars = step(state, batch, gen, 0.002, 0.002, 0.99, do_g_reg=True,
                          do_d_reg=True)
    h = hashlib.sha256()
    tensors = [params_of(m) for m in (state.G, state.D, state.Gs)]
    for opt in (state.g_opt, state.d_opt):
        tensors += [{"count": opt.count}, opt.m, opt.v]
    tensors.append({"pl_mean": state.pl_mean})
    for group in tensors:
        for name in sorted(group):
            h.update(group[name].detach().cpu().contiguous().numpy().tobytes())
    return {"process_id": rank, "process_count": world, "params_sha256": h.hexdigest(),
            "scalars": {k: float(v) for k, v in scalars.items()}}


def _write(record, out):
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"worker {record['process_id']} OK: {record['params_sha256'][:16]}", flush=True)


def run_step(submit_config=None, out_dir=".", device="cpu"):
    """``step_digest`` as the run function of ``submit_run``'s ranks: rank r
    writes ``<out_dir>/worker<r>.json``."""
    import torch

    from inclusivegan_torch import parallel
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    _write(step_digest(device), os.path.join(out_dir, f"worker{parallel.rank()}.json"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default, NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)

    import torch

    from inclusivegan_torch.parallel import init_data_parallel
    from inclusivegan_torch.scripts._train import training_device
    if training_device(args.device).type == "cpu":  # TF32 off on cards
        torch.set_num_threads(1)
    dev = init_data_parallel(args.process_id, args.num_processes,
                             f"tcp://{args.coordinator}", device=args.device)
    try:
        _write(step_digest(dev), args.out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
