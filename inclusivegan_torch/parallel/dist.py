"""Data parallelism over ``torch.distributed``, the counterpart of the JAX
package's 1-D ``data`` mesh (``inclusivegan_tpu/parallel/mesh.py``).

One process per rank. Each rank holds a replica of every parameter and
takes its slice of the global batch; the train step averages gradients,
loss scalars, dlatent batch averages and ``pl_mean`` over the ranks where
the JAX step takes ``lax.pmean``. NCCL on cards, gloo on the CPU.

The backend follows from the device and the world size: NCCL with one
card per rank, gloo on the CPU and for several ranks that share one named
card (``chip_smoke.py`` phase 16 runs two that way, NCCL takes one card per
rank). Under gloo a CUDA tensor goes through a host copy for every
collective: gloo has no CUDA ``gather`` and its CUDA ``all_reduce`` is not
one to depend on. Under NCCL, tensors stay on the card. Outside a process
group every helper acts as a group of one.
"""

import datetime
import hashlib

import torch
import torch.distributed as dist

# The other ranks wait in a collective while rank 0 alone runs an IMLE
# rebuild or writes a snapshot, so the group waits long.
TIMEOUT = datetime.timedelta(hours=2)


def init_data_parallel(rank: int, world_size: int, init_method: str,
                       device="cuda") -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device: ``"cuda"`` binds ``cuda:<rank>`` (NCCL), ``"cuda:K"``
    binds card K on every rank (NCCL for one rank, gloo for several), and
    ``"cpu"`` the CPU (gloo)."""
    dev = torch.device(device)
    shared = dev.index is not None and world_size > 1
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return dev


def check_devices(num_devices: int, device="cuda") -> None:
    """Raise unless ``num_devices`` ranks can run on ``device``: one CUDA
    card per rank for ``"cuda"``; card K present for ``"cuda:K"``, which
    any number of ranks share; any number of ranks on the CPU. Nothing
    moves to the CPU or to fewer ranks."""
    if num_devices < 1:
        raise ValueError(f"num_devices={num_devices}: at least one is needed")
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    have = torch.cuda.device_count()
    if dev.index is not None and dev.index >= have:
        raise RuntimeError(f"device {device!r} names card {dev.index}, and {have} CUDA "
                           "cards are present")
    if dev.index is None and num_devices > 1 and num_devices > have:
        raise RuntimeError(f"{num_devices} ranks need {num_devices} CUDA cards, and "
                           f"{have} are present")


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def is_main() -> bool:
    return rank() == 0


def _via_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_mean_(tensors, group=None, sums=()) -> None:
    """Average each tensor of ``tensors`` over the ranks, and sum each of
    ``sums``, in place: one collective on one flat float32 buffer for both
    lists."""
    means, sums = list(tensors), list(sums)
    every = sums + means
    if not every or not active():
        return
    dev = torch.device("cpu") if _via_host(group) else every[0].device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32) for t in every])
    dist.all_reduce(flat, group=group)
    n_sums = sum(t.numel() for t in sums)
    flat[n_sums:] /= dist.get_world_size(group)
    at = 0
    for t in every:
        n = t.numel()
        t.copy_(flat[at:at + n].view(t.shape))
        at += n


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks of a tensor, differentiable: its gradient is
    the mean of the ranks' incoming gradients, as the transpose of the JAX
    package's ``lax.pmean`` inside ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        all_reduce_mean_([y], group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        all_reduce_mean_([grad], ctx.group)
        return grad, None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` averaged over the ranks, with a gradient."""
    return _AllReduceMean.apply(x, group)


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """Overwrite each tensor with rank ``src``'s, in place: one collective
    per dtype."""
    tensors = list(tensors)
    if not tensors or not active():
        return
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dtype]
        dev = torch.device("cpu") if _via_host(group) else part[0].device
        flat = torch.cat([t.detach().reshape(-1).to(dev) for t in part])
        dist.broadcast(flat, src, group=group)
        at = 0
        for t in part:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=group)
    return box[0]


def gather_to_main(tensor: torch.Tensor, group=None):
    """The ranks' tensors (one shape) concatenated along dim 0, in rank
    order, on rank 0, on ``tensor``'s device; None on the other ranks."""
    if not active():
        return tensor
    world = dist.get_world_size(group)
    main = dist.get_rank(group) == 0
    src = tensor.cpu() if _via_host(group) else tensor.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)] if main else None
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    dist.gather(src, parts, dst=dst, group=group)
    return torch.cat(parts).to(tensor.device) if main else None


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)


def replicas_identical(tensors, group=None) -> bool:
    """Whether every rank holds the same bytes in ``tensors`` (the same list
    on each rank): a digest per rank, gathered."""
    if not active():
        return True
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    mine = torch.tensor(list(h.digest()), dtype=torch.uint8)
    if not _via_host(group):
        mine = mine.to(torch.cuda.current_device())
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    return all(torch.equal(every[0], e) for e in every[1:])
