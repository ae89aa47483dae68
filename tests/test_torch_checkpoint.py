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
