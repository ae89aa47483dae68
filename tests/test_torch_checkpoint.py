"""The port's full-state checkpoint (``training/checkpoint.py``): it holds
what the JAX package's orbax checkpoint holds (the step, G's, D's and Gs's
parameters, both Adam states, ``pl_mean`` and the IMLE counters), every
tensor comes back exactly with its dtype, it loads with ``weights_only``,
and ``latest_checkpoint`` picks the highest step."""

import os

import jax
import pytest
import torch

from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
from inclusivegan_torch.training import checkpoint
from inclusivegan_torch.training.train_state import create_train_state, params_of

NETS = dict(resolution=16, fmap_base=128, fmap_max=16)


def _state(seed, g_dtype=torch.float16):
    gen = torch.Generator().manual_seed(seed)
    G = GMain.create(latent_size=16, dlatent_size=16, mapping_layers=2, mapping_fmaps=16,
                     label_size=2, **NETS)
    D = Discriminator(mbstd_group_size=2, label_size=2, **NETS)
    state = create_train_state(G, D, generator=gen)
    state.G.to(g_dtype)  # G stored as the CelebA snapshot stores it; Gs float32

    def rand_like(t):
        return torch.randn(t.shape, generator=gen).to(t.dtype)

    for opt in (state.g_opt, state.d_opt):
        for k in opt.m:
            opt.m[k].copy_(rand_like(opt.m[k]))
            opt.v[k].copy_(rand_like(opt.v[k]).abs())
    return state._replace(step=torch.tensor(7, dtype=torch.int32),
                          g_opt=state.g_opt._replace(count=torch.tensor(9, dtype=torch.int32)),
                          d_opt=state.d_opt._replace(count=torch.tensor(8, dtype=torch.int32)),
                          pl_mean=torch.tensor(0.123, dtype=torch.float32))


def _tensors(state):
    out = {"step": state.step, "pl_mean": state.pl_mean}
    for name, module in (("G", state.G), ("D", state.D), ("Gs", state.Gs)):
        out.update({f"{name}/{k}": v for k, v in params_of(module).items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        out[f"{name}/count"] = opt.count
        out.update({f"{name}/m/{k}": v for k, v in opt.m.items()})
        out.update({f"{name}/v/{k}": v for k, v in opt.v.items()})
    return out


def test_round_trip_is_exact(tmp_path):
    saved = _state(0)
    path = checkpoint.save_checkpoint(str(tmp_path / "checkpoints"), saved,
                                      imle_state={"cursor": 120, "staleness": 40},
                                      step=4800)
    assert os.path.basename(path) == "step_00004800"
    target = _state(1, g_dtype=torch.float32)  # other values, other G dtype
    restored, imle = checkpoint.load_checkpoint(path, target)
    assert imle == {"cursor": 120, "staleness": 40}
    want, got = _tensors(saved), _tensors(restored)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    assert restored.G is target.G  # loaded into the target's modules


def test_it_holds_what_the_jax_checkpoint_holds(tmp_path):
    from inclusivegan_tpu.models.stylegan2 import Discriminator as JD
    from inclusivegan_tpu.models.stylegan2 import GMain as JG
    from inclusivegan_tpu.training import checkpoint as jckpt
    from inclusivegan_tpu.training.train_state import create_train_state as j_create
    jplain = jckpt._to_plain(j_create(jax.random.key(0), JG.create(**NETS),
                                      JD(**NETS)))
    path = checkpoint.save_checkpoint(str(tmp_path), _state(0), step=0)
    payload = torch.load(os.path.join(path, checkpoint.STATE_FILE), weights_only=True)
    assert set(payload["state"]) == set(jplain)
    for opt in ("g_opt", "d_opt"):
        assert set(payload["state"][opt]) == set(jplain[opt])
    assert set(payload["imle"]) == set()


def test_load_refuses_other_networks(tmp_path):
    path = checkpoint.save_checkpoint(str(tmp_path), _state(0), step=1)
    gen = torch.Generator().manual_seed(0)
    other = create_train_state(
        GMain.create(latent_size=16, dlatent_size=16, mapping_layers=3,
                     mapping_fmaps=16, **NETS),
        Discriminator(mbstd_group_size=2, **NETS), generator=gen)
    with pytest.raises(ValueError, match="names differ"):
        checkpoint.load_checkpoint(path, other)


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    assert checkpoint.latest_checkpoint(str(tmp_path / "missing")) is None
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    for name in ("step_00000300", "step_00002000", "step_00000100", "step_notanumber",
                 "other"):
        os.makedirs(tmp_path / name)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_00002000")
    os.makedirs(tmp_path / "step_100000000")  # past eight digits
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_100000000")


def _script(name):
    """``scripts/<name>.py`` loaded as a module, as tests/test_mirror_sidecar.py
    loads its script."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _half_save(obj, f, *args, **kwargs):
    """torch.save interrupted after part of the file is written."""
    with open(f, "wb") as fh:
        fh.write(b"PK\x03\x04 partial")
    raise OSError("interrupted in the middle of the save")


@pytest.mark.parametrize("killed", [False, True], ids=["raised", "killed"])
def test_an_interrupted_save_leaves_only_complete_checkpoints(tmp_path, monkeypatch, killed):
    """A save that fails in the middle leaves no ``step_<digits>`` directory
    of its step: the port's ``latest_checkpoint``, the watchdog's
    ``latest_checkpoint`` and ``checkpoint_for_kimg`` and the mirror's
    ``checkpoint_for_kimg`` all find the earlier complete checkpoint, which
    loads. ``killed``: the process dies before it can clean up (the
    temporary directory stays, under a name no finder takes). An
    interrupted re-save of a step keeps the earlier save of that step; a
    complete one replaces it."""
    watchdog, mirror = _script("watchdog_mode_coverage"), _script("mirror_best_checkpoint")
    run_dir = tmp_path / "00000-stacked-synth-2k-mode-coverage"
    cdir = str(run_dir / "checkpoints")
    first = checkpoint.save_checkpoint(cdir, _state(0), imle_state={"cursor": 4, "staleness": 2},
                                       step=2048)
    with monkeypatch.context() as m:
        m.setattr(torch, "save", _half_save)
        if killed:
            m.setattr(checkpoint.shutil, "rmtree", lambda *a, **k: None)
        for step in (4096, 2048):
            with pytest.raises(OSError, match="interrupted"):
                checkpoint.save_checkpoint(cdir, _state(1), step=step)
    names = sorted(os.listdir(cdir))
    assert [n for n in names if n[len("step_"):].isdigit()] == ["step_00002048"]
    assert len(names) == (3 if killed else 1), names
    assert checkpoint.latest_checkpoint(cdir) == first
    assert watchdog.latest_checkpoint(str(run_dir)) == first
    assert watchdog.checkpoint_for_kimg(str(run_dir), 2) == first
    assert watchdog.checkpoint_for_kimg(str(run_dir), 4) is None
    assert mirror.checkpoint_for_kimg(str(run_dir), 2) == first
    assert mirror.checkpoint_for_kimg(str(run_dir), 4) is None
    want = _tensors(_state(0))
    restored, imle = checkpoint.load_checkpoint(first, _state(2, g_dtype=torch.float32))
    assert imle == {"cursor": 4, "staleness": 2}
    assert all(torch.equal(_tensors(restored)[k], v) for k, v in want.items())

    again = checkpoint.save_checkpoint(cdir, _state(1), imle_state={"cursor": 8, "staleness": 4},
                                       step=2048)
    assert again == first
    assert sorted(n for n in os.listdir(cdir) if n[len("step_"):].isdigit()) == ["step_00002048"]
    restored, imle = checkpoint.load_checkpoint(again, _state(2, g_dtype=torch.float32))
    assert imle == {"cursor": 8, "staleness": 4}
    want = _tensors(_state(1))
    assert all(torch.equal(_tensors(restored)[k], v) for k, v in want.items())
