"""The bfloat16 compute knob of the port against the JAX package's, on the CPU.

Narrow networks (tests/torch_golden/narrow_nets.py: 16 px, at most 16
feature maps) with G, D and the LPIPS trunk computing in bfloat16, as
``run_training.py --dtype bfloat16`` trains from a fresh init. The same numpy
parameters and inputs go to both packages. Tolerances (bfloat16 keeps 8
bits of mantissa, and the two packages' CPU backends round bf16
intermediates at other places):

- forward outputs and loss scalars: relative L2 error (relative error for a
  scalar) at most 2e-2;
- gradients: the relative L2 error of each phase's whole gradient (every
  parameter of the network the phase updates) at most 5e-2, and 8e-2 for
  R1. Gradients that cancel to nearly 0 in float32 (a noise strength, the
  R1 gradient of an early bias, which reaches it only through the
  minibatch stddev) are rounding noise in bf16, in both packages, so no
  tensor is held alone; R1 in the iteration misses 5e-2 at 5.9e-2 here.
  R1 alone from one D state (``torch_golden/r1_bf16_reading.py``) shows
  why: there the two bf16 gradients lie 5e-3 apart and each as far from
  float64 (ratio 1.09), so the miss is what each package's earlier bf16
  phases carry into R1's state; that reading is held below;
- against JAX's float32 iteration, from the same draws, the port's bf16
  whole gradient deviates at most 1.5 times as far as JAX's bf16 one, and
  so do its loss scalars (root mean square of the relative deviations) and
  its per-tensor gradient norms (median of the relative deviations);
- dtypes exactly: D resnet's activations block by block (the JAX package's
  ``(x + t) * np.float32(1 / sqrt(2))`` promotes the bf16 residual sum to
  float32, so every block after the first computes in float32), and the
  dtypes of the networks and of LPIPS in the loop, fresh and resumed.

The iteration runs torch's bf16 convolutions as float32 sums rounded to
bf16, as cuDNN and XLA compute them: torch's CPU bf16 convolution through
oneDNN returns a wrong double backward for a 3x3 convolution with padding 1
(its weight gradient off by 100% in torch 2.13; ROADMAP.md, queue 3), and
its other CPU path sums in bf16.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inclusivegan_torch.models.stylegan2 as tsg
import inclusivegan_tpu.models.stylegan2 as jsg
from inclusivegan_tpu.models import lpips as jl
from inclusivegan_tpu.parallel import make_data_mesh
from inclusivegan_tpu.training.train_state import create_train_state as j_create
from inclusivegan_tpu.training.train_step import TrainConfig as JTrainConfig
from inclusivegan_tpu.training.train_step import make_train_step as j_make
from inclusivegan_torch.models import lpips as tl
from inclusivegan_torch.training.train_state import create_train_state
from inclusivegan_torch.training.train_step import TrainConfig, make_train_step
from test_torch_training_loop import LOOP, NETS, _args, _Recorder, toy_dataset  # noqa: F401
from torch_golden import jax_draws
from torch_golden.narrow_nets import RES, ZDIM, flat, narrow_nets, to_port

FWD_REL = 2e-2
GRAD_REL_L2 = {"g_main": 5e-2, "g_reg": 5e-2, "d_main": 5e-2, "d_reg": 8e-2}
VS_F32_FACTOR = 1.5
GRADIENT_CRITERION = 5e-2  # R1 alone, from one D state, is held at it
MB = 2
LR = 0.002
GS_BETA = 0.99
CFG = dict(gamma=100.0, mirror_augment=True)
PHASES = (("g_main", "g_opt"), ("g_reg", "g_opt"), ("d_main", "d_opt"),
          ("d_reg", "d_opt"))


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def jax_bf16(G, D, dtype=jnp.bfloat16):
    """The JAX networks computing in ``dtype``."""
    return (dataclasses.replace(G, mapping=dataclasses.replace(G.mapping, dtype=dtype),
                                synthesis=dataclasses.replace(G.synthesis, dtype=dtype)),
            dataclasses.replace(D, dtype=dtype))


def port_bf16(gc, gp, dc, dp):
    """The port's networks from the same trees, computing in bfloat16."""
    TG, TD = to_port(gc, gp, dc, dp)
    for net in (TG, TD):
        tsg.set_compute_dtype(net, "bfloat16")
    return TG, TD


@pytest.fixture(scope="module")
def nets():
    G, D, gp, dp, gc, dc = narrow_nets()
    JG, JD = jax_bf16(G, D)
    TG, TD = port_bf16(gc, gp, dc, dp)
    return G, D, JG, JD, TG, TD, gp, dp, gc, dc


def test_mapping_synthesis_and_d_forward_match_jax_bf16(nets):
    _, _, JG, JD, TG, TD, gp, dp, _, _ = nets
    rnd = np.random.RandomState(0)
    z = rnd.randn(4, ZDIM).astype(np.float32)
    jw = JG.mapping.apply(gp["mapping"], jnp.asarray(z))
    tw = TG.mapping(torch.from_numpy(z))
    assert jw.dtype == jnp.bfloat16 and tw.dtype == torch.bfloat16
    assert rel_l2(_np(tw), jw) <= FWD_REL

    dl = rnd.randn(4, JG.synthesis.num_layers, ZDIM).astype(np.float32)
    jimg = JG.synthesis.apply(gp["synthesis"], jnp.asarray(dl), noise=gp["noise"],
                              randomize_noise=False)
    timg = TG.synthesis(torch.from_numpy(dl), noise=dict(TG.noise.named_buffers()),
                        randomize_noise=False)
    assert jimg.dtype == jnp.bfloat16 and timg.dtype == torch.bfloat16
    assert rel_l2(_np(timg), jimg) <= FWD_REL

    imgs = rnd.uniform(-1, 1, (4, 3, RES, RES)).astype(np.float32)
    js, jf = JD.apply(dp, jnp.asarray(imgs))
    ts, tf = TD(torch.from_numpy(imgs))
    assert (str(js.dtype), str(jf.dtype)) == ("float32", "float32")
    assert (ts.dtype, tf.dtype) == (torch.float32, torch.float32)
    assert rel_l2(_np(ts), js) <= FWD_REL and rel_l2(_np(tf), jf) <= FWD_REL


def _activation_dtypes(monkeypatch, module, run):
    """(shape, dtype name) of every bias + activation output while ``run``
    runs, through the module's ``_bias_act``."""
    seen = []
    inner = module._bias_act

    def recording(x, *a, **k):
        y = inner(x, *a, **k)
        seen.append((tuple(y.shape), str(y.dtype).replace("torch.", "")))
        return y

    with monkeypatch.context() as m:
        m.setattr(module, "_bias_act", recording)
        run()
    return seen


def test_d_resnet_activation_dtypes_block_by_block(nets, monkeypatch):
    """D resnet at bf16: FromRGB and the first block in bfloat16, every later
    block, the 4x4 conv, the dense layer and the output in float32, in both
    packages alike."""
    _, _, _, JD, _, TD, _, dp, _, _ = nets
    imgs = np.random.RandomState(1).uniform(-1, 1, (4, 3, RES, RES)).astype(np.float32)
    jseen = _activation_dtypes(monkeypatch, jsg, lambda: JD.apply(dp, jnp.asarray(imgs)))
    tseen = _activation_dtypes(monkeypatch, tsg, lambda: TD(torch.from_numpy(imgs)))
    assert tseen == jseen
    dtypes = [d for _, d in tseen]
    blocks = JD.resolution_log2 - 2
    assert len(dtypes) == 1 + 2 * blocks + 3
    assert dtypes[:3] == ["bfloat16"] * 3  # FromRGB, Conv0, Conv1_down of 16x16
    assert dtypes[3:] == ["float32"] * (len(dtypes) - 3)


def test_g_skip_activations_stay_bf16(nets, monkeypatch):
    """G skip at bf16: every mapping and synthesis layer in bfloat16."""
    _, _, JG, _, TG, _, gp, _, _, _ = nets
    z = np.random.RandomState(2).randn(2, ZDIM).astype(np.float32)
    jseen = _activation_dtypes(monkeypatch, jsg, lambda: JG.apply(
        gp, jnp.asarray(z), randomize_noise=False, truncation_psi=0.7))
    tseen = _activation_dtypes(monkeypatch, tsg, lambda: TG(
        torch.from_numpy(z), randomize_noise=False, truncation_psi=0.7))
    assert tseen == jseen
    assert {d for _, d in tseen} == {"bfloat16"}


@pytest.fixture(scope="module")
def vgg_params():
    tree = jax.tree_util.tree_map(np.asarray, jl.init_lpips_params(seed=3))
    return tree, tl.lpips_params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("norm", ["f32", "trunk"])
def test_lpips_bf16_matches_jax(vgg_params, norm):
    """The VGG trunk in bfloat16: the tap maps in float32 ("f32") or in
    bfloat16 ("trunk"), and the distances, against the JAX package's."""
    jp, tp = vgg_params
    rnd = np.random.RandomState(4)
    a, b = (rnd.uniform(0, 255, (3, 3, RES, RES)).astype(np.float32) for _ in range(2))
    jf = jl.lpips_features(jp, jnp.asarray(a), jnp.bfloat16, norm=norm)
    tf = tl.lpips_features(tp, torch.from_numpy(a), "bfloat16", norm=norm)
    want = "bfloat16" if norm == "trunk" else "float32"
    for f, g in zip(tf, jf):
        assert str(f.dtype) == f"torch.{want}" and str(g.dtype) == want
        assert rel_l2(_np(f), g) <= FWD_REL
    jd = jl.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b), jnp.bfloat16, norm=norm)
    td = tl.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b), torch.bfloat16,
                           norm=norm)
    assert td.dtype == torch.float32
    assert rel_l2(_np(td), jd) <= FWD_REL


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {
        "reals_rec_1": r.randint(0, 256, (MB, 3, RES, RES)).astype(np.uint8),
        "latents_rec_1": r.randn(MB, ZDIM).astype(np.float32),
        "labels_rec_1": np.zeros((MB, 0), np.float32),
        "reals_rec_2": r.randint(0, 256, (MB, 3, RES, RES)).astype(np.uint8),
        "latents_rec_2": r.randn(MB, ZDIM).astype(np.float32),
        "labels_rec_2": np.zeros((MB, 0), np.float32),
        "reals": r.randint(0, 256, (2 * MB, 3, RES, RES)).astype(np.uint8),
        "labels": np.zeros((2 * MB, 0), np.float32),
    }


def _jax_iteration(G, D, gp, dp, lp, lpips_dtype):
    """JAX's scalars and gradients (first Adam moments, beta1 = 0) after
    each phase of one iteration, with bf16-valued synthesis noise."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jsg, "random", jax_draws.bf16_noise_random())
        return _jax_phases(G, D, gp, dp, lp, lpips_dtype)


def _jax_phases(G, D, gp, dp, lp, lpips_dtype):
    ph = j_make(G, D, lp, make_data_mesh(1),
                JTrainConfig(**CFG, lpips_dtype=lpips_dtype)).phases
    batch = _batch()
    bg = {k: v for k, v in batch.items() if k.endswith(("_1", "_2"))}
    bd = {"reals": batch["reals"], "labels": batch["labels"]}
    k1, k2, k3, k4 = jax.random.split(jax.random.key(3), 4)
    state = j_create(jax.random.key(0), G, D)._replace(
        g_params=gp, d_params=dp, gs_params=jax.tree_util.tree_map(np.copy, gp))
    out = []
    for name, opt in PHASES:
        if name == "g_main":
            state, s = ph["g_step"](state, bg, k1, jnp.float32(LR), jnp.float32(2.5))
        elif name == "g_reg":
            state, s = ph["g_reg_step"](state, k2, jnp.float32(LR), MB)
        elif name == "d_main":
            state, s = ph["d_step"](state, bd, k3, jnp.float32(LR), jnp.float32(GS_BETA))
        else:
            state, s = ph["d_reg_step"](state, bd, k4, jnp.float32(LR), jnp.float32(100.0))
        out.append(({k: float(v) for k, v in s.items()},
                    {k: np.asarray(v, np.float32)
                     for k, v in flat(getattr(state, opt).m).items()}))
    return out


def _f32_sums(fn):
    """``fn`` with bf16 inputs computed in float32 and rounded to bf16."""
    def call(x, w, *a, **k):
        if x.dtype == torch.bfloat16:
            return fn(x.float(), w.float(), *a, **k).to(torch.bfloat16)
        return fn(x, w, *a, **k)
    return call


@pytest.fixture(scope="module")
def iterations(nets, vgg_params):
    """One iteration in JAX bf16, JAX float32 and the port's bf16, from the
    same trees, batch and draws (synthesis noise drawn in bfloat16, as a
    bf16 G draws it), with the VGG LPIPS at bf16 in the bf16 runs."""
    G, D, JG, JD, _, _, gp, dp, gc, dc = nets
    jp, tp = vgg_params
    j16 = _jax_iteration(JG, JD, gp, dp, jp, "bfloat16")
    j32 = _jax_iteration(G, D, gp, dp, jp, None)
    TG, TD = port_bf16(gc, gp, dc, dp)
    TGs, _ = port_bf16(gc, gp, dc, dp)
    state = create_train_state(TG, TD, TGs)
    step = make_train_step(TG, TD, tp, TrainConfig(**CFG, lpips_dtype="bfloat16"),
                           device="cpu")
    draws = jax_draws.to_torch(jax_draws.train_step(JG, jax.random.key(3), MB))
    tb = step.phases["to_device"](_batch())
    ph = step.phases
    port = []
    patch = pytest.MonkeyPatch()
    for fn in ("conv2d", "conv_transpose2d"):
        patch.setattr(torch.nn.functional, fn, _f32_sums(getattr(torch.nn.functional, fn)))
    for name, opt in PHASES:
        if name == "g_main":
            state, s = ph["g_step"](state, tb, draws["g"], LR, 2.5)
        elif name == "g_reg":
            state, s = ph["g_reg_step"](state, draws["g_reg"], LR)
        elif name == "d_main":
            state, s = ph["d_step"](state, tb, draws["d"], LR, GS_BETA)
        else:
            state, s = ph["d_reg_step"](state, tb, draws["d_reg"], LR)
        port.append(({k: float(v) for k, v in s.items()},
                     {k: _np(v) for k, v in getattr(state, opt).m.items()}))
    patch.undo()
    return j16, j32, port


def _whole(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
def test_phase_scalars_and_gradients_match_jax_bf16(iterations, phase):
    j16, _, port = iterations
    name = PHASES[phase][0]
    (js, jg), (ts, tg) = j16[phase], port[phase]
    assert set(ts) == set(js) and set(tg) == set(jg)
    for k, v in js.items():
        assert abs(ts[k] - v) <= FWD_REL * abs(v), (k, ts[k], v)
    assert rel_l2(_whole(tg), _whole(jg)) <= GRAD_REL_L2[name]


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
def test_bf16_lies_as_near_float32_as_jax_bf16(iterations, phase):
    """Against JAX's float32 iteration, the port's bf16 whole gradient,
    loss scalars (root mean square of the relative deviations) and
    per-tensor gradient norms (their median relative deviation) deviate no
    more than 1.5 times JAX's bf16 ones."""
    j16, j32, port = iterations
    s32, g32 = j32[phase]

    def deviations(run):
        s, g = run[phase]
        ds = [(s[k] - v) / abs(v) for k, v in s32.items() if v != 0]
        dn = [abs(np.linalg.norm(g[k]) / np.linalg.norm(v) - 1)
              for k, v in g32.items() if np.linalg.norm(v) > 0]
        return (rel_l2(_whole(g), _whole(g32)), float(np.sqrt(np.mean(np.square(ds)))),
                float(np.median(dn)))

    port_dev, jax_dev = deviations(port), deviations(j16)
    for what, p, j in zip(("whole gradient", "scalars", "gradient norms"), port_dev,
                          jax_dev):
        assert p <= VS_F32_FACTOR * j, (what, p, j)


# ---------------------------------------------------------------------------
# The loop at bf16: control flow, and the compute dtypes fresh and resumed.

class _DtypeRecorder(_Recorder):
    """The loop's recorder that also keeps the compute dtypes of G, D and
    LPIPS that the loop gives the train step, and the dtype of the images
    its G draws from the state on the first step."""

    def make(self, G, D, lpips_params, *args, **kwargs):
        cfg = kwargs.get("cfg") or next(a for a in args if hasattr(a, "lpips_dtype"))
        self.dtypes = dict(mapping=G.mapping.dtype, synthesis=G.synthesis.dtype,
                           D=D.dtype, lpips=cfg.lpips_dtype, lpips_norm=cfg.lpips_norm)
        self.dtypes = {k: _dtype_name(v) for k, v in self.dtypes.items()}
        inner = super().make(G, D, lpips_params, *args, **kwargs)

        def train_step(state, *a, **k):
            if not self.steps:
                self.dtypes["images"] = _dtype_name(_images_of(G, state).dtype)
            return inner(state, *a, **k)
        return train_step


def _dtype_name(d):
    if d is None:
        return None
    return str(getattr(d, "__name__", d)).replace("torch.", "")


def _images_of(G, state):
    z = np.random.RandomState(0).randn(2, G.mapping.latent_size).astype(np.float32)
    if hasattr(state, "g_params"):  # JAX
        return G.apply(state.g_params, jnp.asarray(z), randomize_noise=False)
    with torch.no_grad():
        return state.G(torch.from_numpy(z), randomize_noise=False)


def _run_loop(package, toy_dataset, root, monkeypatch, **kw):  # noqa: F811
    if package == "jax":
        from inclusivegan_tpu.training import training_loop as loop
        from inclusivegan_tpu.utils import run_harness
        name = "inclusivegan_tpu.training.training_loop.training_loop"
    else:
        from inclusivegan_torch.training import training_loop as loop
        from inclusivegan_torch.utils import run_harness
        name, kw = LOOP, dict(kw, device="cpu")
    rec = _DtypeRecorder()
    monkeypatch.setattr(loop, "make_train_step", rec.make)
    run_harness.submit_run(run_harness.SubmitConfig(run_dir_root=root, run_desc="bf16"),
                           name, **_args(toy_dataset, **kw))
    run_dir = os.path.join(root, "00000-bf16")
    files = sorted("events.out.tfevents" if n.startswith("events.out.tfevents.") else n
                   for n in os.listdir(run_dir))
    with open(os.path.join(run_dir, "network-final.pkl"), "rb") as f:
        snap = pickle.load(f)
    configs = (snap["G"]["config"]["synthesis"]["dtype"], snap["D"]["config"]["dtype"])
    return rec, files, configs


BF16_NETS = dict(G_args=dict(NETS["G_args"], dtype="bfloat16"),
                 D_args=dict(NETS["D_args"], dtype="bfloat16"))


def test_resume_computes_float32_networks_and_bf16_lpips(toy_dataset, tmp_path,  # noqa: F811
                                                         monkeypatch):
    """--resume-pkl of a bf16 run's snapshot with dtype bfloat16: both loops
    build G and D from the snapshot without its dtype, so they compute in
    float32, while LPIPS takes G_args.dtype, bfloat16."""
    _, _, gp, dp, gc, dc = narrow_nets()
    for c in (gc["mapping"], gc["synthesis"], dc):
        c["dtype"] = "bfloat16"
    pkl = tmp_path / "network-snapshot-000000.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"format": "inclusivegan_tpu.network_snapshot.v1",
                     "G": {"config": gc, "params": gp}, "D": {"config": dc, "params": dp},
                     "Gs": {"config": gc, "params": gp}}, f)
    kw = dict(BF16_NETS, resume_pkl=str(pkl), smoke_test_max_iters=1, seed=5,
              prefetch_depth=0, save_full_checkpoints=False)
    kw["G_args"] = {k: v for k, v in kw["G_args"].items() if k == "dtype"}
    kw["D_args"] = {k: v for k, v in kw["D_args"].items() if k == "dtype"}
    out = {}
    for package in ("jax", "port"):
        with monkeypatch.context() as m:
            out[package] = _run_loop(package, toy_dataset, str(tmp_path / package), m, **kw)
    (jrec, _, _), (rec, _, _) = out["jax"], out["port"]
    assert rec.dtypes == jrec.dtypes == dict(
        mapping="float32", synthesis="float32", D="float32", lpips="bfloat16",
        lpips_norm=None, images="float32")


def test_r1_bf16_lies_as_near_float64_as_jax_bf16():
    """R1 alone, from one D state (``torch_golden/r1_bf16_reading.py``): the
    port's bf16 gradient lies no farther from the float64 gradient than 1.5
    times the JAX package's bf16 one, and within 5e-2 of it."""
    from torch_golden.r1_bf16_reading import reading
    r = reading()
    port, jax_dev = r["whole"]
    assert port <= VS_F32_FACTOR * jax_dev, (port, jax_dev)
    assert r["port_vs_jax"] <= GRADIENT_CRITERION, r["port_vs_jax"]
