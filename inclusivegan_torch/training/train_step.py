"""One training iteration, on one card or as one rank of a data-parallel
group, ported from ``inclusivegan_tpu/training/train_step.py``.

The four phases run in order, as in the JAX package: G main (the batched G
loss), G path-length reg (lazy), D main followed by the Gs EMA, D R1 (lazy).
Each takes the gradient of its loss with ``torch.autograd.grad``, then a
shared-moment Adam step (``optimizer.adam_apply``) whose result is written
into the state's modules in place.

Data parallelism (``group``, a ``torch.distributed`` process group of which
this process is one rank): the batch is this rank's slice of the global
batch, and each phase reduces over the ranks, in one collective
(``parallel.all_reduce_mean_``), what the JAX step reduces with
``lax.pmean``: the gradients before Adam, summed as the JAX step's are (so
every rank takes the same non-finite skip), and, averaged, the dlatent
batch averages before they are folded, the new ``pl_mean`` and every loss
scalar. Under ``invariant_rng`` the path-length penalty centres on the
mean over all ranks' examples (``mean_fn``). Without a group nothing is
reduced, and the step is the single-card one.

Randomness: each phase draws from the ``torch.Generator`` the caller passes,
through the ``draw_*`` functions below and in ``loss.py``, unless the caller
hands in the draws (``draws={"g": ..., "g_reg": ..., "d": ..., "d_reg":
...}``), as the tests do with the JAX package's. Mirror flips are uniform
draws ``u``; an image is flipped where ``u >= 0.5``.

Gradient accumulation (``grad_accum_rounds``, the reference optimizer's
minibatch multiplier): each phase splits its batch-shaped inputs into
``rounds`` microbatches, in order, and takes one gradient per microbatch;
the gradients are summed in float32 and divided by ``rounds``, and Adam
(with its non-finite skip) runs once, on the mean. Per-round scalars are
averaged, the dlatent batch averages are folded in round order, and the
path-length ``pl_mean`` threads through the rounds in sequence. The
batch-shaped draws of a phase (flips, arb latents) are made for the whole
batch and split; the draws inside the loss are made per round (under
``"rounds"`` in the phase's draws). R1 draws nothing per round.

``invariant_rng``: every batch-shaped draw comes from the example's global
index (``loss.ExampleDraws``: four phase seeds from the generator, then
per-example streams on the host, moved to the card in one copy), and
batch-scalar draws are shared by the batch, so that a global batch computes
the same on any number of cards. ``draw_train_step``'s ``example_offset``
is the global index of this rank's first example (0 on one card; the step
passes rank x local minibatch when it draws). As in the JAX package, it
needs ``grad_accum_rounds == 1``. Without ``invariant_rng`` each rank draws
from the generator its caller gives it, one per rank.
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import all_reduce_mean, all_reduce_mean_
from .loss import (ExampleDraws, d_main_loss, d_r1_reg, draw_d_main,
                   draw_d_main_invariant, draw_g_main, draw_g_main_invariant,
                   draw_g_path_reg, draw_g_path_reg_invariant, fold_dlatent_avg,
                   g_main_loss, g_path_reg)
from .optimizer import adam_apply, lazy_reg_hparams
from .train_state import TrainState, assign, g_trainables, params_of, update_gs

# Fields of the JAX TrainConfig that mean nothing here and are accepted at
# any value: the port updates the state in place already.
_IGNORED = ("donate_state",)


class _Fields(NamedTuple):
    NN_rec_lpips_weight: float = 2.5
    gamma: float = 10.0
    pl_minibatch_shrink: int = 2
    pl_decay: float = 0.01
    pl_weight: float = 2.0
    G_reg_interval: int = 4
    D_reg_interval: int = 16
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    mirror_augment: bool = False
    drange_data: Tuple[float, float] = (0.0, 255.0)
    lazy_regularization: bool = True
    lpips_dtype: Any = None  # the LPIPS trunk's compute dtype; None: float32
    lpips_norm: Any = None  # "f32" (None) or "trunk": models.lpips.lpips_features
    g_loss_batched: bool = True
    grad_accum_rounds: int = 1  # microbatches per phase, one Adam step
    invariant_rng: bool = False  # draws keyed by the global example index


class TrainConfig(_Fields):
    """The hyperparameters of the step, the JAX package's. Its
    ``donate_state`` is accepted at any value, since the port updates the
    state in place."""
    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        for name in _IGNORED:
            kwargs.pop(name, None)
        return super().__new__(cls, *args, **kwargs)


def _process_reals(x, u, mirror_augment: bool, drange_data):
    """uint8 -> [-1, 1] float32, mirrored where u >= 0.5 (u: [N])."""
    x = x.float()
    lo, hi = drange_data
    x = (x - lo) * (2.0 / (hi - lo)) - 1.0
    if mirror_augment:
        keep = (u.to(x.device) < 0.5).reshape(-1, 1, 1, 1)
        x = torch.where(keep, x, x.flip(3))
    return x


def _uniform(n, generator):
    return torch.rand((n,), generator=generator, device=generator.device)


def draw_train_step(G, minibatch_size: int, generator: torch.Generator,
                    cfg: TrainConfig, *, do_g_reg: bool = True,
                    do_d_reg: bool = True, example_offset: int = 0,
                    device=None) -> Dict[str, Dict[str, Any]]:
    """Every draw of one iteration, phase by phase, from ``generator``. With
    ``grad_accum_rounds`` over 1, each phase's loss draws are a list under
    ``"rounds"``. Under ``invariant_rng`` the draws are made on the host
    and moved to ``device`` (default: the generator's) in one copy."""
    if cfg.invariant_rng:
        return _draw_invariant(G, minibatch_size, generator, cfg, example_offset,
                               device or generator.device, do_g_reg, do_d_reg)
    mb = minibatch_size
    rounds = cfg.grad_accum_rounds
    z = G.mapping.latent_size

    def per_round(draw, n):
        if rounds == 1:
            return draw(n)
        return {"rounds": [draw(n // rounds) for _ in range(rounds)]}

    draws = {"g": {"flip1": _uniform(mb, generator), "flip2": _uniform(mb, generator),
                   "arb_latents": torch.randn((mb, z), generator=generator,
                                              device=generator.device),
                   **per_round(lambda n: draw_g_main(G, n, generator, cfg.g_loss_batched),
                               mb)}}
    if do_g_reg:
        draws["g_reg"] = per_round(
            lambda n: draw_g_path_reg(G, n, generator, cfg.pl_minibatch_shrink), mb)
    draws["d"] = {"flip": _uniform(2 * mb, generator),
                  "arb_latents": torch.randn((2 * mb, z), generator=generator,
                                             device=generator.device),
                  **per_round(lambda n: draw_d_main(G, n, generator), 2 * mb)}
    if do_d_reg:
        draws["d_reg"] = {"flip": _uniform(2 * mb, generator)}
    return draws


def _draw_invariant(G, mb: int, generator, cfg, example_offset: int, device,
                    do_g_reg: bool, do_d_reg: bool):
    """The draws of ``invariant_rng``: four phase seeds from ``generator``
    (one read, which waits for the card if the generator is a CUDA one),
    then per-example streams (``loss.ExampleDraws``), whose sub-streams
    number as the JAX package splits each phase key. Path-length examples
    are ``pl_minibatch_shrink`` times fewer, D's twice as many. The four
    seeds are read whatever the flags, so a lazy phase that is skipped
    leaves the other phases' draws as they are."""
    seeds = torch.randint(0, 2 ** 62, (4,), generator=generator,
                          device=generator.device).tolist()
    z = G.mapping.latent_size
    g = ExampleDraws(seeds[0], example_offset)
    pl_mb = max(mb // cfg.pl_minibatch_shrink, 1)
    gr = ExampleDraws(seeds[1], example_offset * pl_mb // mb)
    d = ExampleDraws(seeds[2], 2 * example_offset)
    draws = {"g": {"flip1": g.sub(0).uniform(mb), "flip2": g.sub(1).uniform(mb),
                   "arb_latents": g.sub(3).normal(mb, (z,)),
                   **draw_g_main_invariant(G, mb, g.sub(4), g.sub(2),
                                           cfg.g_loss_batched)}}
    if do_g_reg:
        draws["g_reg"] = draw_g_path_reg_invariant(G, pl_mb, gr.sub(1), gr.sub(0))
    draws["d"] = {"flip": d.sub(0).uniform(2 * mb),
                  "arb_latents": d.sub(2).normal(2 * mb, (z,)),
                  **draw_d_main_invariant(G, 2 * mb, d.sub(3), d.sub(1))}
    if do_d_reg:
        draws["d_reg"] = {"flip": ExampleDraws(seeds[3], 2 * example_offset).uniform(2 * mb)}
    return _draws_to_device(draws, device)


def _draws_to_device(draws, device):
    """The draws on ``device``, in one host-to-device copy per dtype."""
    device = torch.device(device)
    flat = flatten_draws(draws)
    out = {}
    for dtype in {v.dtype for v in flat.values()}:
        names = [k for k, v in flat.items() if v.dtype == dtype]
        buf = torch.cat([flat[k].reshape(-1) for k in names])
        if device.type == "cuda":
            buf = buf.pin_memory()
        buf = buf.to(device, non_blocking=True)
        at = 0
        for k in names:
            n = flat[k].numel()
            out[k] = buf[at:at + n].view(flat[k].shape)
            at += n
    return unflatten_draws(out, device)


def _round_draws(draws, rounds: int):
    """The loss draws of each round of a phase."""
    return draws["rounds"] if rounds > 1 else [draws]


def _split(tensors: Dict[str, Any], rounds: int):
    """Batch-shaped inputs -> ``rounds`` microbatches, in order."""
    n = next(iter(tensors.values())).shape[0]
    if n % rounds:
        raise ValueError(f"a batch of {n} does not split into {rounds} rounds")
    m = n // rounds
    return [{k: v[r * m:(r + 1) * m] for k, v in tensors.items()} for r in range(rounds)]


class _Accumulator:
    """Gradients of the rounds of one phase: one round's as they are; over
    more, their float32 sum divided by the rounds. Scalars are averaged."""

    def __init__(self, rounds: int):
        self.rounds = rounds
        self.sum = None
        self.scalars = []

    def add(self, grads, scalars):
        self.scalars.append(scalars)
        if self.rounds == 1:
            self.sum = grads
        elif self.sum is None:
            self.sum = {k: g.float() for k, g in grads.items()}
        else:
            self.sum = {k: self.sum[k] + g.float() for k, g in grads.items()}

    def grads(self):
        if self.rounds == 1:
            return self.sum
        return {k: g / self.rounds for k, g in self.sum.items()}

    def mean_scalars(self):
        if self.rounds == 1:
            return self.scalars[0]
        return {k: torch.stack([s[k] for s in self.scalars]).mean()
                for k in self.scalars[0]}


def _detached(scalars):
    return {k: v.detach() for k, v in scalars.items()}


def _grads(loss, params):
    """d loss / d params; a parameter the loss does not reach gets zeros, as
    under jax.grad (the path-length penalty does not see ToRGB biases)."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    return dict(zip(names, grads))


def make_train_step(G, D, lpips_params, cfg: TrainConfig = TrainConfig(),
                    device="cuda", impl: str = "cuda", group=None):
    """Returns ``train_step(state, batch, generator, g_lrate, d_lrate,
    gs_beta, *, do_g_reg, do_d_reg, rec_weight=None, draws=None)``, which
    runs one iteration and returns (state, scalars); the scalars are 0-d
    tensors on the card. ``G`` and ``D`` give the architecture; the
    parameters are the state's. ``impl`` is passed down to every op:
    ``"plain"`` runs the kernels' plain versions, for comparison. ``group``
    (a process group) reduces each phase over its ranks as the JAX step
    does (gradients summed, the rest averaged), and the batch is then this
    rank's slice.

    batch: reals_rec_1/2 [mb, C, H, W] uint8, latents_rec_1/2 [mb, Z],
    labels_rec_1/2 [mb, L], reals [2 mb, C, H, W] uint8, labels [2 mb, L];
    numpy arrays or tensors. The phases are also returned one by one as
    ``train_step.phases``."""
    # as the JAX package asserts: microbatch boundaries would move with the
    # number of cards, and each round draws its own batch-scalar values
    assert not (cfg.invariant_rng and cfg.grad_accum_rounds != 1), (
        "invariant_rng guarantees sharding-invariance only for the rounds=1 "
        "fast path")
    rounds = cfg.grad_accum_rounds
    label_size = G.mapping.label_size
    beta = G.dlatent_avg_beta
    if cfg.lazy_regularization:
        g_lr_mul, g_b1, g_b2 = lazy_reg_hparams(1.0, cfg.adam_beta1, cfg.adam_beta2,
                                                cfg.G_reg_interval)
        d_lr_mul, d_b1, d_b2 = lazy_reg_hparams(1.0, cfg.adam_beta1, cfg.adam_beta2,
                                                cfg.D_reg_interval)
    else:
        g_lr_mul = d_lr_mul = 1.0
        g_b1 = d_b1 = cfg.adam_beta1
        g_b2 = d_b2 = cfg.adam_beta2

    def g_adam(state, grads, g_lrate):
        tr = g_trainables(params_of(state.G))
        new, g_opt, _ = adam_apply(tr, grads, state.g_opt,
                                   learning_rate=g_lrate * g_lr_mul, beta1=g_b1,
                                   beta2=g_b2, epsilon=cfg.adam_eps)
        assign(state.G, new)
        return state._replace(g_opt=g_opt)

    def d_adam(state, grads, d_lrate):
        new, d_opt, _ = adam_apply(params_of(state.D), grads, state.d_opt,
                                   learning_rate=d_lrate * d_lr_mul, beta1=d_b1,
                                   beta2=d_b2, epsilon=cfg.adam_eps)
        assign(state.D, new)
        return state._replace(d_opt=d_opt)

    def fold(state, avgs):
        assign(state.G, {"dlatent_avg": fold_dlatent_avg(
            state.G.dlatent_avg.detach(), avgs, beta)})

    def over_ranks(grads, avgs, scalars, *more):
        """Over the group's ranks, in one collective: the phase's gradients
        summed, and its dlatent batch averages, scalars and ``more``
        tensors averaged (detached). Returns (grads, avgs, scalars). The sum
        is the JAX step's gradient: inside its ``shard_map`` the gradient
        with respect to the replicated parameters is already the devices'
        sum, which its ``lax.pmean`` leaves as it is (``ROADMAP.md`` queue
        3 item 13)."""
        avgs = [a.detach() for a in avgs]
        scalars = _detached(scalars)
        if group is not None:
            all_reduce_mean_([*avgs, *scalars.values(), *more], group,
                             sums=grads.values())
        return grads, avgs, scalars

    rank_mean = None
    if group is not None and cfg.invariant_rng:
        def rank_mean(x):  # the pl_lengths mean over every rank's examples
            return all_reduce_mean(x.mean(), group)

    def g_step(state: TrainState, batch, draws, g_lrate, rec_w):
        r1 = _process_reals(batch["reals_rec_1"], draws["flip1"],
                            cfg.mirror_augment, cfg.drange_data)
        r2 = _process_reals(batch["reals_rec_2"], draws["flip2"],
                            cfg.mirror_augment, cfg.drange_data)
        mb = r1.shape[0]
        data = dict(latents_rec_1=batch["latents_rec_1"], reals_rec_1=r1,
                    labels_rec_1=batch["labels_rec_1"],
                    latents_rec_2=batch["latents_rec_2"], reals_rec_2=r2,
                    labels_rec_2=batch["labels_rec_2"],
                    arb_latents=draws["arb_latents"].to(device),
                    arb_labels=torch.zeros((mb, label_size), device=device))
        trainables = g_trainables(params_of(state.G))
        acc, avgs = _Accumulator(rounds), []
        for part, rd in zip(_split(data, rounds), _round_draws(draws, rounds)):
            out = g_main_loss(
                state.G, state.D, lpips_params, draws=rd, **part,
                NN_rec_lpips_weight=rec_w,
                lpips_dtype=cfg.lpips_dtype or torch.float32,
                lpips_norm=cfg.lpips_norm, batched=cfg.g_loss_batched, impl=impl)
            g_loss = out.loss.mean()
            acc.add(_grads(g_loss, trainables), {**out.scalars, "Loss/G_total": g_loss})
            avgs += out.dlatent_batch_avgs  # folded in round order
        grads, avgs, scalars = over_ranks(acc.grads(), avgs, acc.mean_scalars())
        state = g_adam(state, grads, g_lrate)
        fold(state, avgs)
        return state, scalars

    def g_reg_step(state: TrainState, draws, g_lrate):
        trainables = g_trainables(params_of(state.G))
        acc, avgs, pl_mean = _Accumulator(rounds), [], state.pl_mean
        for rd in _round_draws(draws, rounds):
            # pl_mean threads through the rounds in sequence
            reg, pl_mean, scalars, ba = g_path_reg(
                state.G, draws=rd, pl_mean=pl_mean, label_size=label_size,
                pl_decay=cfg.pl_decay, pl_weight=cfg.pl_weight, impl=impl,
                mean_fn=rank_mean)
            acc.add(_grads(reg.mean() * cfg.G_reg_interval, trainables), scalars)
            avgs.append(ba)
        grads, avgs, scalars = over_ranks(acc.grads(), avgs, acc.mean_scalars(), pl_mean)
        state = g_adam(state, grads, g_lrate)
        fold(state, avgs)
        return state._replace(pl_mean=pl_mean), scalars

    def d_step(state: TrainState, batch, draws, d_lrate, gs_beta):
        reals = _process_reals(batch["reals"], draws["flip"], cfg.mirror_augment,
                               cfg.drange_data)
        n2 = reals.shape[0]
        data = dict(reals=reals, labels=batch["labels"],
                    arb_latents=draws["arb_latents"].to(device),
                    arb_labels=torch.zeros((n2, label_size), device=device))
        params = params_of(state.D)
        acc, avgs = _Accumulator(rounds), []
        for part, rd in zip(_split(data, rounds), _round_draws(draws, rounds)):
            loss, scalars, round_avgs = d_main_loss(state.G, state.D, draws=rd,
                                                    **part, impl=impl)
            d_loss = loss.mean()
            acc.add(_grads(d_loss, params), {**scalars, "Loss/D_total": d_loss})
            avgs += round_avgs
        grads, avgs, scalars = over_ranks(acc.grads(), avgs, acc.mean_scalars())
        state = d_adam(state, grads, d_lrate)
        fold(state, avgs)
        assign(state.Gs, update_gs(params_of(state.G), params_of(state.Gs), gs_beta))
        return state._replace(step=state.step + 1), scalars

    def d_reg_step(state: TrainState, batch, draws, d_lrate):
        reals = _process_reals(batch["reals"], draws["flip"], cfg.mirror_augment,
                               cfg.drange_data)
        params = params_of(state.D)
        acc = _Accumulator(rounds)
        for part in _split(dict(reals=reals, labels=batch["labels"]), rounds):
            reg, scalars = d_r1_reg(state.D, **part, gamma=cfg.gamma, impl=impl)
            acc.add(_grads(reg.mean() * cfg.D_reg_interval, params), scalars)
        grads, _, scalars = over_ranks(acc.grads(), [], acc.mean_scalars())
        state = d_adam(state, grads, d_lrate)
        return state, scalars

    def to_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   g_lrate: float, d_lrate: float, gs_beta: float, *,
                   do_g_reg: bool, do_d_reg: bool, rec_weight=None, draws=None):
        """One iteration: the reference's four session.run calls."""
        batch = to_device(batch)
        if draws is None:
            mb = batch["latents_rec_1"].shape[0]
            offset = mb * dist.get_rank(group) if group is not None else 0
            draws = draw_train_step(G, mb, generator, cfg, do_g_reg=do_g_reg,
                                    do_d_reg=do_d_reg, example_offset=offset,
                                    device=device)
        rec_w = cfg.NN_rec_lpips_weight if rec_weight is None else rec_weight
        scalars = {}
        state, s = g_step(state, batch, draws["g"], g_lrate, rec_w)
        scalars.update(s)
        if do_g_reg:
            state, s = g_reg_step(state, draws["g_reg"], g_lrate)
            scalars.update(s)
        state, s = d_step(state, batch, draws["d"], d_lrate, gs_beta)
        scalars.update(s)
        if do_d_reg:
            state, s = d_reg_step(state, batch, draws["d_reg"], d_lrate)
            scalars.update(s)
        return state, scalars

    train_step.phases = dict(g_step=g_step, g_reg_step=g_reg_step, d_step=d_step,
                             d_reg_step=d_reg_step, to_device=to_device)
    return train_step


def flatten_draws(draws, prefix: str = "") -> Dict[str, Any]:
    """Nested draws -> {"g/mixing/0/0": leaf, ...}, for saving as arrays."""
    out = {}
    items = draws.items() if isinstance(draws, dict) else enumerate(draws)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_draws(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten_draws(flat: Dict[str, Any], device="cpu"):
    """Inverse of ``flatten_draws``, with tensors on ``device``: list
    positions come back as lists, a (latents2, cutoff) pair as a tuple."""
    root: Dict[str, Any] = {}
    for name, v in flat.items():
        node = root
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = torch.as_tensor(v, device=device)

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            seq = [node[str(i)] for i in range(len(node))]
            pair = len(seq) == 2 and torch.is_tensor(seq[1]) and seq[1].ndim == 0
            return tuple(seq) if pair else seq
        return node
    return fix(root)
