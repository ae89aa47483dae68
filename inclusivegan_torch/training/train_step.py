"""One training iteration on one card, ported from
``inclusivegan_tpu/training/train_step.py``.

The four phases run in order, as in the JAX package: G main (the batched G
loss), G path-length reg (lazy), D main followed by the Gs EMA, D R1 (lazy).
Each takes the gradient of its loss with ``torch.autograd.grad``, then a
shared-moment Adam step (``optimizer.adam_apply``) whose result is written
into the state's modules in place. There is one device, so no gradient
average across devices.

Randomness: each phase draws from the ``torch.Generator`` the caller passes,
through the ``draw_*`` functions below and in ``loss.py``, unless the caller
hands in the draws (``draws={"g": ..., "g_reg": ..., "d": ..., "d_reg":
...}``), as the tests do with the JAX package's. Mirror flips are uniform
draws ``u``; an image is flipped where ``u >= 0.5``.
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .loss import (d_main_loss, d_r1_reg, draw_d_main, draw_g_main,
                   draw_g_path_reg, fold_dlatent_avg, g_main_loss, g_path_reg)
from .optimizer import adam_apply, lazy_reg_hparams
from .train_state import TrainState, assign, g_trainables, params_of, update_gs

# Fields of the JAX TrainConfig that this port does not honour yet, with the
# values that mean "off", and the work that brings them.
_LATER = {
    "invariant_rng": ((False,), "invariant_rng comes with gradient accumulation "
                      "(ROADMAP.md, queue 1 item 4)"),
    "grad_accum_rounds": ((1,), "gradient accumulation comes in a later slice "
                          "(ROADMAP.md, queue 1 item 4)"),
}
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


class TrainConfig(_Fields):
    """The hyperparameters of the step that this slice honours. The JAX
    package's other fields (``invariant_rng``, ``grad_accum_rounds``) are
    accepted at their neutral values and raise ``NotImplementedError``
    otherwise; ``donate_state`` is accepted either way, since the port
    updates the state in place."""
    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        for name in _IGNORED:
            kwargs.pop(name, None)
        for name, (neutral, why) in _LATER.items():
            if name in kwargs:
                value = kwargs.pop(name)
                if not any(value is v or value == v for v in neutral):
                    raise NotImplementedError(
                        f"TrainConfig.{name}={value!r} is not ported: {why}")
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
                    do_d_reg: bool = True) -> Dict[str, Dict[str, Any]]:
    """Every draw of one iteration, phase by phase, from ``generator``."""
    mb = minibatch_size
    draws = {"g": {"flip1": _uniform(mb, generator), "flip2": _uniform(mb, generator),
                   "arb_latents": torch.randn((mb, G.mapping.latent_size),
                                              generator=generator,
                                              device=generator.device),
                   **draw_g_main(G, mb, generator, cfg.g_loss_batched)}}
    if do_g_reg:
        draws["g_reg"] = draw_g_path_reg(G, mb, generator, cfg.pl_minibatch_shrink)
    draws["d"] = {"flip": _uniform(2 * mb, generator),
                  "arb_latents": torch.randn((2 * mb, G.mapping.latent_size),
                                             generator=generator,
                                             device=generator.device),
                  **draw_d_main(G, 2 * mb, generator)}
    if do_d_reg:
        draws["d_reg"] = {"flip": _uniform(2 * mb, generator)}
    return draws


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
                    device="cuda", impl: str = "cuda"):
    """Returns ``train_step(state, batch, generator, g_lrate, d_lrate,
    gs_beta, *, do_g_reg, do_d_reg, rec_weight=None, draws=None)``, which
    runs one iteration and returns (state, scalars); the scalars are 0-d
    tensors on the card. ``G`` and ``D`` give the architecture; the
    parameters are the state's. ``impl`` is passed down to every op:
    ``"plain"`` runs the kernels' plain versions, for comparison.

    batch: reals_rec_1/2 [mb, C, H, W] uint8, latents_rec_1/2 [mb, Z],
    labels_rec_1/2 [mb, L], reals [2 mb, C, H, W] uint8, labels [2 mb, L];
    numpy arrays or tensors. The phases are also returned one by one as
    ``train_step.phases``."""
    latent_size = G.mapping.latent_size
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
            state.G.dlatent_avg.detach(), [a.detach() for a in avgs], beta)})

    def g_step(state: TrainState, batch, draws, g_lrate, rec_w):
        r1 = _process_reals(batch["reals_rec_1"], draws["flip1"],
                            cfg.mirror_augment, cfg.drange_data)
        r2 = _process_reals(batch["reals_rec_2"], draws["flip2"],
                            cfg.mirror_augment, cfg.drange_data)
        mb = r1.shape[0]
        out = g_main_loss(
            state.G, state.D, lpips_params, draws=draws,
            latents_rec_1=batch["latents_rec_1"], reals_rec_1=r1,
            labels_rec_1=batch["labels_rec_1"],
            latents_rec_2=batch["latents_rec_2"], reals_rec_2=r2,
            labels_rec_2=batch["labels_rec_2"],
            arb_latents=draws["arb_latents"].to(device),
            arb_labels=torch.zeros((mb, label_size), device=device),
            NN_rec_lpips_weight=rec_w, lpips_dtype=cfg.lpips_dtype or torch.float32,
            lpips_norm=cfg.lpips_norm, batched=cfg.g_loss_batched, impl=impl)
        g_loss = out.loss.mean()
        grads = _grads(g_loss, g_trainables(params_of(state.G)))
        state = g_adam(state, grads, g_lrate)
        fold(state, out.dlatent_batch_avgs)
        return state, _detached({**out.scalars, "Loss/G_total": g_loss})

    def g_reg_step(state: TrainState, draws, g_lrate):
        reg, new_pl, scalars, ba = g_path_reg(
            state.G, draws=draws, pl_mean=state.pl_mean, label_size=label_size,
            pl_decay=cfg.pl_decay, pl_weight=cfg.pl_weight, impl=impl)
        grads = _grads(reg.mean() * cfg.G_reg_interval,
                       g_trainables(params_of(state.G)))
        state = g_adam(state, grads, g_lrate)
        fold(state, [ba])
        return state._replace(pl_mean=new_pl), _detached(scalars)

    def d_step(state: TrainState, batch, draws, d_lrate, gs_beta):
        reals = _process_reals(batch["reals"], draws["flip"], cfg.mirror_augment,
                               cfg.drange_data)
        n2 = reals.shape[0]
        loss, scalars, avgs = d_main_loss(
            state.G, state.D, draws=draws, reals=reals, labels=batch["labels"],
            arb_latents=draws["arb_latents"].to(device),
            arb_labels=torch.zeros((n2, label_size), device=device), impl=impl)
        d_loss = loss.mean()
        state = d_adam(state, _grads(d_loss, params_of(state.D)), d_lrate)
        fold(state, avgs)
        assign(state.Gs, update_gs(params_of(state.G), params_of(state.Gs), gs_beta))
        return (state._replace(step=state.step + 1),
                _detached({**scalars, "Loss/D_total": d_loss}))

    def d_reg_step(state: TrainState, batch, draws, d_lrate):
        reals = _process_reals(batch["reals"], draws["flip"], cfg.mirror_augment,
                               cfg.drange_data)
        reg, scalars = d_r1_reg(state.D, reals=reals, labels=batch["labels"],
                                gamma=cfg.gamma, impl=impl)
        state = d_adam(state, _grads(reg.mean() * cfg.D_reg_interval,
                                     params_of(state.D)), d_lrate)
        return state, _detached(scalars)

    def to_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   g_lrate: float, d_lrate: float, gs_beta: float, *,
                   do_g_reg: bool, do_d_reg: bool, rec_weight=None, draws=None):
        """One iteration: the reference's four session.run calls."""
        batch = to_device(batch)
        if draws is None:
            draws = draw_train_step(G, batch["latents_rec_1"].shape[0], generator,
                                    cfg, do_g_reg=do_g_reg, do_d_reg=do_d_reg)
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
