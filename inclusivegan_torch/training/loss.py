"""Training losses, ported from ``inclusivegan_tpu/training/loss.py``.

``g_main_loss``: IMLE reconstruction LPIPS against the two retrieved-latent
rec batches, the interpolation LPIPS of slerped latents, and the
non-saturating adversarial loss of arbitrary-latent fakes. ``g_path_reg``:
the path-length regularizer, whose gradient flows through the EMA'd
``pl_mean``. ``d_main_loss``: the logistic D loss with fakes and reals in one
D call where minibatch-stddev groups allow. ``d_r1_reg``: the R1 penalty.

Every random draw is an argument (``draws``), made by the ``draw_*``
functions from a ``torch.Generator`` or handed in by a test with the JAX
package's draws. Under ``invariant_rng`` the ``draw_*_invariant``
functions make the same draws per example from its global index
(``ExampleDraws``), so that they do not depend on how the batch is split. Losses are per-sample; the train step takes their mean.
Second-order terms use ``torch.autograd.grad(..., create_graph=True)``, which
reaches the kernels' own backward Functions.
"""

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.lpips import lpips_distance, lpips_distance_from_features, lpips_features

Draws = Dict[str, object]

# --- invariant_rng: per-example draws ---------------------------------------
# The salts of the JAX package's invariant mode, numbered as there: t, the
# path-length latents and image-space noise, and the parent of each G
# forward's draws (+ the forward's id); under a forward, its style-mixing
# latents2 (the JAX package's models/stylegan2.py _EK_MIX) and its synthesis
# noise, every layer in one draw (the JAX package folds in each layer index).
_EK_T = (1 << 20) | 1
_EK_PL_Z = (1 << 20) | 2
_EK_PL_NOISE = (1 << 20) | 3
_EK_FWD_BASE = 1 << 21
_EK_MIX = 1 << 20
_EK_NOISE = 0


class ExampleDraws:
    """Random streams of one phase under ``invariant_rng``. The values of the
    example with global index ``offset + i`` under a path of salts come
    from numpy's PCG64 seeded by ``SeedSequence([seed, 1, len(path), *path,
    offset + i])``: they depend on the phase seed, the salts and the index
    alone, so that a global batch drawn whole equals its parts drawn at
    their offsets, on any number of cards. ``scalar_rng`` gives the
    batch-scalar draws (the style-mixing decision and cutoff), which depend
    on the seed and the salts alone. Values are drawn on the host, one call
    per example and salt."""

    def __init__(self, seed: int, offset: int = 0, path: tuple = ()):
        self.seed, self.offset, self.path = int(seed), int(offset), tuple(path)

    def sub(self, *salts: int) -> "ExampleDraws":
        return ExampleDraws(self.seed, self.offset, self.path + salts)

    def _rngs(self, n: int):
        head = [self.seed, 1, len(self.path), *self.path]
        return [np.random.default_rng(head + [self.offset + i]) for i in range(n)]

    def normal(self, n: int, shape=()) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [r.standard_normal(shape, dtype=np.float32) for r in self._rngs(n)]))

    def uniform(self, n: int, shape=()) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [r.random(shape, dtype=np.float32) for r in self._rngs(n)]))

    def scalar_rng(self) -> np.random.Generator:
        return np.random.default_rng([self.seed, 2, len(self.path), *self.path])


def _mixing_invariant(G, n: int, fwd: ExampleDraws, scalars: ExampleDraws):
    """(latents2 per example, cutoff shared by the batch), the layout of
    ``GMain.draw_mixing``; None without style mixing."""
    if G.style_mixing_prob is None:
        return None
    num_layers = G.synthesis.num_layers
    latents2 = fwd.sub(_EK_MIX).normal(n, (G.mapping.latent_size,))
    rng = scalars.scalar_rng()
    mix = rng.random() < G.style_mixing_prob
    layer = int(rng.integers(1, num_layers))
    return latents2, torch.tensor(layer if mix else num_layers, dtype=torch.int64)


def _noise_invariant(G, n: int, fwd: ExampleDraws) -> Dict[str, torch.Tensor]:
    """Each example's synthesis noise of every layer in one draw, split into
    the [n, 1, h, w] images of ``GSynthesis.draw_noise``."""
    shapes = G.synthesis.noise_shapes()
    sizes = [int(np.prod(s)) for s in shapes.values()]
    z = fwd.sub(_EK_NOISE).normal(n, (sum(sizes),))
    return {k: part.reshape((n,) + s[1:])
            for (k, s), part in zip(shapes.items(), torch.split(z, sizes, dim=1))}


def _normalize(v, dim=-1):
    return v / torch.sqrt(v.square().sum(dim=dim, keepdim=True))


def slerp(a, b, t):
    """Batch spherical interpolation, re-normalized to the unit sphere."""
    a = _normalize(a)
    b = _normalize(b)
    d = (a * b).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(torch.clamp(d, -1.0, 1.0))
    c = _normalize(b - d * a)
    return _normalize(a * torch.cos(p) + c * torch.sin(p))


def lerp(a, b, t):
    return a + (b - a) * t


def _to_255(img):
    """[-1, 1] -> [0, 255] for LPIPS."""
    return (img.float() + 1.0) * (255.0 / 2.0)


class GLossOut(NamedTuple):
    loss: torch.Tensor                     # [N] per-sample total main loss
    scalars: Dict[str, torch.Tensor]
    dlatent_batch_avgs: Tuple[torch.Tensor, ...]  # fold into dlatent_avg


def draw_g_main(G, n: int, generator: torch.Generator, batched: bool = True) -> Draws:
    """The draws of ``g_main_loss`` for n samples per group: t [n, 1], one
    style mixing per logical G forward (rec1, rec2, interp, arb), and the
    synthesis noise, one dict for the 4n batch or one per forward."""
    dev = generator.device
    t = torch.rand((n, 1), generator=generator, device=dev)
    mixing = [G.draw_mixing(n, generator) for _ in range(4)]
    noise = ([G.synthesis.draw_noise(4 * n, generator)] if batched
             else [G.synthesis.draw_noise(n, generator) for _ in range(4)])
    return {"t": t, "mixing": mixing, "noise": noise}


def draw_g_main_invariant(G, n: int, ex: ExampleDraws, scalars: ExampleDraws,
                          batched: bool = True) -> Draws:
    """``draw_g_main``'s draws per example (``ex``: the phase's example
    streams) with the mixing decisions from ``scalars``."""
    fwd = [ex.sub(_EK_FWD_BASE + fid) for fid in range(4)]
    noise = [_noise_invariant(G, n, f) for f in fwd]
    if batched:
        noise = [{k: torch.cat([z[k] for z in noise]) for k in noise[0]}]
    return {"t": ex.sub(_EK_T).uniform(n, (1,)),
            "mixing": [_mixing_invariant(G, n, f, scalars.sub(fid))
                       for fid, f in enumerate(fwd)],
            "noise": noise}


def g_main_loss(G, D, lpips_params, *, draws: Draws,
                latents_rec_1, reals_rec_1, labels_rec_1,
                latents_rec_2, reals_rec_2, labels_rec_2,
                arb_latents, arb_labels, NN_rec_lpips_weight: float = 2.5,
                lpips_dtype=torch.float32, lpips_norm=None,
                batched: bool = True, impl: str = "cuda") -> GLossOut:
    """Main (non-lazy) G loss: rec-LPIPS + interp-LPIPS + adversarial NS.

    ``batched=True`` (the production form) maps four groups of latents with
    their own mixing draws, synthesizes the 4n images in one call and runs
    the five LPIPS image stacks through one VGG call; ``batched=False`` runs
    four G forwards and six LPIPS evaluations, as the reference does.
    ``lpips_dtype`` and ``lpips_norm``: the VGG trunk's compute dtype and
    tap normalization (``models.lpips.lpips_features``)."""
    t = draws["t"].to(latents_rec_1.device)
    interp_latents = slerp(latents_rec_2, latents_rec_1, t)
    interp_labels = (lerp(labels_rec_2, labels_rec_1, t) if labels_rec_1.numel()
                     else labels_rec_1)
    groups = [(latents_rec_1, labels_rec_1), (latents_rec_2, labels_rec_2),
              (interp_latents, interp_labels), (arb_latents, arb_labels)]
    t1 = t[:, 0]

    if not batched:
        avgs, imgs = [], []
        for (z, labels), mixing, noise in zip(groups, draws["mixing"], draws["noise"]):
            img, _dl, avg = G(z, labels, is_training=True, return_dlatents=True,
                              mixing=mixing, noise=noise, randomize_noise=False,
                              impl=impl)
            imgs.append(img)
            avgs.append(avg)
        rec1, rec2, interp, arb = imgs
        def lpips(a, b):
            return lpips_distance(lpips_params, _to_255(a), _to_255(b),
                                  lpips_dtype, lpips_norm)

        loss_rec = 0.5 * (lpips(rec1, reals_rec_1) + lpips(rec2, reals_rec_2)) \
            * NN_rec_lpips_weight
        d2, d1 = lpips(interp, reals_rec_2), lpips(interp, reals_rec_1)
    else:
        dlats, avgs = [], []
        for (z, labels), mixing in zip(groups, draws["mixing"]):
            dl, avg = G.map_latents(z, labels, mixing=mixing, impl=impl)
            dlats.append(dl)
            avgs.append(avg)
        imgs = G.synthesis(torch.cat(dlats), noise=draws["noise"][0],
                           randomize_noise=False, impl=impl)
        rec1, rec2, interp, arb = torch.chunk(imgs, 4)
        stack = torch.cat([_to_255(rec1), _to_255(rec2), _to_255(interp),
                           _to_255(reals_rec_1), _to_255(reals_rec_2)])
        feats = lpips_features(lpips_params, stack, lpips_dtype, lpips_norm)
        f_rec1, f_rec2, f_interp, f_real1, f_real2 = zip(
            *(torch.chunk(f, 5) for f in feats))

        def dist(a, b):
            return lpips_distance_from_features(lpips_params, a, b)

        loss_rec = 0.5 * (dist(f_rec1, f_real1) + dist(f_rec2, f_real2)) \
            * NN_rec_lpips_weight
        d2, d1 = dist(f_interp, f_real2), dist(f_interp, f_real1)
    loss_interp = lerp(d2, d1, t1) * (NN_rec_lpips_weight * 0.4)
    arb_scores, _ = D(arb, arb_labels, impl=impl)
    loss_arb = F.softplus(-arb_scores)
    loss = loss_rec + loss_interp + loss_arb
    scalars = {"Loss/loss_NN_rec_lpips": loss_rec.mean(),
               "Loss/loss_NN_interp_lpips": loss_interp.mean(),
               "Loss/loss_G_arb": loss_arb.mean()}
    return GLossOut(loss, scalars, tuple(avgs))


def draw_g_path_reg(G, minibatch_size: int, generator: torch.Generator,
                    pl_minibatch_shrink: int = 2) -> Draws:
    """The draws of ``g_path_reg``: pl latents, one style mixing, the
    image-space noise (standard normal, scaled in the loss) and the
    synthesis noise."""
    pl_mb = max(minibatch_size // pl_minibatch_shrink, 1)
    dev = generator.device
    syn = G.synthesis
    pl_latents = torch.randn((pl_mb, G.mapping.latent_size), generator=generator,
                             device=dev)
    mixing = G.draw_mixing(pl_mb, generator)
    res = syn.resolution
    pl_noise = torch.randn((pl_mb, syn.num_channels, res, res),
                           generator=generator, device=dev)
    return {"pl_latents": pl_latents, "mixing": mixing, "pl_noise": pl_noise,
            "noise": syn.draw_noise(pl_mb, generator)}


def draw_g_path_reg_invariant(G, pl_mb: int, ex: ExampleDraws,
                              scalars: ExampleDraws) -> Draws:
    """``draw_g_path_reg``'s draws per path-length example."""
    syn = G.synthesis
    res = syn.resolution
    return {"pl_latents": ex.sub(_EK_PL_Z).normal(pl_mb, (G.mapping.latent_size,)),
            "mixing": _mixing_invariant(G, pl_mb, ex.sub(_EK_FWD_BASE), scalars),
            "pl_noise": ex.sub(_EK_PL_NOISE).normal(pl_mb, (syn.num_channels, res, res)),
            "noise": _noise_invariant(G, pl_mb, ex.sub(_EK_FWD_BASE + 1))}


def g_path_reg(G, *, draws: Draws, pl_mean, label_size: int,
               pl_decay: float = 0.01, pl_weight: float = 2.0,
               impl: str = "cuda", mean_fn=None):
    """Path-length regularizer. Returns (reg [pl_mb], new_pl_mean (no
    gradient), scalars, dlatent_batch_avg). The inner gradient is taken
    with respect to the dlatents with ``create_graph=True``; the penalty
    centres on the updated mean, and the gradient flows through it.
    ``mean_fn`` takes the batch mean of the path lengths that feeds the
    mean (default: this batch's); under ``invariant_rng`` on several ranks
    it is the mean over every rank's examples, as in the JAX package."""
    pl_latents = draws["pl_latents"]
    pl_mb = pl_latents.shape[0]
    pl_labels = torch.zeros((pl_mb, label_size), device=pl_latents.device)
    dlatents, batch_avg = G.map_latents(pl_latents, pl_labels,
                                        mixing=draws["mixing"], impl=impl)
    pl_noise = draws["pl_noise"] / np.sqrt(float(G.synthesis.resolution ** 2))
    imgs = G.synthesis(dlatents, noise=draws["noise"], randomize_noise=False,
                       impl=impl)
    (pl_grads,) = torch.autograd.grad((imgs.float() * pl_noise).sum(), dlatents,
                                      create_graph=True)
    pl_lengths = torch.sqrt(pl_grads.square().sum(dim=2).mean(dim=1))
    batch_mean = pl_lengths.mean() if mean_fn is None else mean_fn(pl_lengths)
    pl_mean_new = pl_mean + pl_decay * (batch_mean - pl_mean)
    reg = (pl_lengths - pl_mean_new).square() * pl_weight
    scalars = {"Loss/pl_penalty": reg.mean(), "Loss/pl_lengths": pl_lengths.mean()}
    return reg, pl_mean_new.detach(), scalars, batch_avg


def draw_d_main(G, n: int, generator: torch.Generator) -> Draws:
    """The draws of ``d_main_loss``'s G forward for n fakes."""
    return {"mixing": G.draw_mixing(n, generator),
            "noise": G.synthesis.draw_noise(n, generator)}


def draw_d_main_invariant(G, n: int, ex: ExampleDraws, scalars: ExampleDraws) -> Draws:
    """``draw_d_main``'s draws per example."""
    fwd = ex.sub(_EK_FWD_BASE)
    return {"mixing": _mixing_invariant(G, n, fwd, scalars),
            "noise": _noise_invariant(G, n, fwd)}


def d_main_loss(G, D, *, draws: Draws, reals, labels, arb_latents, arb_labels,
                impl: str = "cuda"):
    """Logistic D loss on fakes and reals (both 2x minibatch). They share
    one D call when the fake count is a multiple of the minibatch-stddev
    group: groups then never straddle the boundary. The fakes are made
    without a graph, since the loss is differentiated for D alone."""
    with torch.no_grad():
        arb, _dl, batch_avg = G(arb_latents, arb_labels, is_training=True,
                                return_dlatents=True, mixing=draws["mixing"],
                                noise=draws["noise"], randomize_noise=False,
                                impl=impl)
    n_fake = arb.shape[0]
    if D.mbstd_group_size <= 1 or n_fake % D.mbstd_group_size == 0:
        scores, _ = D(torch.cat([arb, reals]), torch.cat([arb_labels, labels]),
                      impl=impl)
        arb_scores, real_scores = scores[:n_fake], scores[n_fake:]
    else:
        arb_scores, _ = D(arb, arb_labels, impl=impl)
        real_scores, _ = D(reals, labels, impl=impl)
    loss = F.softplus(arb_scores) + F.softplus(-real_scores)
    scalars = {"Loss/loss_D": loss.mean(), "Loss/scores_real": real_scores.mean(),
               "Loss/scores_fake": arb_scores.mean()}
    return loss, scalars, (batch_avg,)


def d_r1_reg(D, *, reals, labels, gamma: float = 10.0, impl: str = "cuda"):
    """R1 penalty gamma/2 * |grad_x D(x)|^2 per sample; differentiable in
    D's parameters (double backward)."""
    reals = reals.detach().requires_grad_()
    scores, _ = D(reals, labels, impl=impl)
    (real_grads,) = torch.autograd.grad(scores.sum(), reals, create_graph=True)
    reg = real_grads.square().sum(dim=(1, 2, 3)) * (gamma * 0.5)
    return reg, {"Loss/gradient_penalty_D": reg.mean()}


def fold_dlatent_avg(dlatent_avg, batch_avgs, beta: float = 0.995):
    """Fold each G forward's batch average into the EMA, one lerp per
    forward, in order."""
    for ba in batch_avgs:
        dlatent_avg = ba + (dlatent_avg - ba) * beta
    return dlatent_avg
