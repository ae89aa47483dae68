"""The port's snapshot reader on the real CelebA-128 snapshot: the Gs tree
carries across with every key mapped and every shape right (no forward
pass). The writer, ``snapshot_dict``: the JAX package's ``load_snapshot``
reads it bit for bit with float16 kept, the JAX generate-images CLI draws
the same images from it as the port, and the CelebA snapshot resumed at its
stored dtype is written back unchanged."""

import os

import numpy as np
import pytest
import torch

from inclusivegan_torch import snapshot
from inclusivegan_torch.models.stylegan2 import nf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELEBA = os.path.join(ROOT, "artifacts", "celeba_best_weights_fp16.pkl")


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


@pytest.fixture(scope="module")
def celeba():
    snap = snapshot.read_snapshot(CELEBA)
    G = snapshot.gmain_from_params(snap["Gs"]["config"], snap["Gs"]["params"],
                                   device="cpu")
    return snap, G


def test_every_gs_key_and_shape_carries_across(celeba):
    snap, G = celeba
    state = G.state_dict()
    flat = dict(_flat(snap["Gs"]["params"]))
    assert set(state) == set(flat)
    assert len(flat) == 108
    for key, arr in flat.items():
        t = state[key]
        assert t.dtype == torch.float16, key  # stored dtype kept
        if key.startswith("synthesis.") and key.endswith(".weight") and arr.ndim == 4:
            k, _, cin, cout = arr.shape
            assert tuple(t.shape) == (cout, cin, k, k), key
            np.testing.assert_array_equal(t.numpy(), np.transpose(arr, (3, 2, 0, 1)))
        else:
            assert tuple(t.shape) == arr.shape, key
            np.testing.assert_array_equal(t.numpy(), arr)


def test_celeba_config_is_the_slice_model(celeba):
    _, G = celeba
    syn, mapping = G.synthesis, G.mapping
    assert (2 ** syn.resolution_log2, syn.architecture, syn.num_layers) == (128, "skip", 12)
    assert syn.resample_kernel == [1, 3, 3, 1]
    assert (mapping.mapping_layers, mapping.dlatent_size, mapping.mapping_lrmul,
            mapping.label_size) == (8, 512, 0.01, 40)
    assert G.truncation_psi == 0.6
    channels = [G.state_dict()[f"synthesis.{2 ** r}x{2 ** r}.Conv1.bias"].shape[0]
                for r in range(3, 8)]
    assert channels == [nf(r - 1, 8192) for r in range(3, 8)] == [512, 512, 512, 256, 128]


def test_numpy_core_is_mapped_under_old_numpy(monkeypatch):
    """Snapshots written under numpy >= 2 name numpy._core; an older numpy
    only has numpy.core."""
    import io
    u = snapshot._Unpickler(io.BytesIO(b""))
    monkeypatch.setattr(snapshot.np, "__version__", "1.26.4")
    assert u.find_class("numpy._core.multiarray", "_reconstruct") is \
        np.core.multiarray._reconstruct


def test_load_snapshot_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        snapshot.load_snapshot(CELEBA)


# ---------------------------------------------------------------------------
# The writer: snapshot.snapshot_dict, read back by the JAX package.

def _narrow_state(dtype=torch.float16):
    """Freshly initialized narrow port networks stored in ``dtype``, with a
    Gs that differs from G, as a training state."""
    import copy
    from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
    from inclusivegan_torch.training.train_state import create_train_state
    gen = torch.Generator().manual_seed(5)
    G = GMain.create(resolution=32, fmap_base=256, fmap_max=32, latent_size=32,
                     dlatent_size=32, mapping_layers=2, mapping_fmaps=32, label_size=3)
    D = Discriminator(resolution=32, fmap_base=256, fmap_max=32, mbstd_group_size=2,
                      label_size=3)
    state = create_train_state(G, D, generator=gen)
    with torch.no_grad():
        for p in state.Gs.parameters():
            p.add_(0.1)
        for net in (state.G, state.D, state.Gs):
            for p in net.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
    for net in (state.G, state.D, state.Gs):
        net.to(dtype)
    return copy.deepcopy(G), copy.deepcopy(D), state


def test_jax_load_snapshot_reads_the_ports_snapshot(tmp_path):
    """The JAX training loop's ``load_snapshot`` reads what
    ``snapshot_dict`` writes: every parameter and buffer of G, D and Gs
    bit-equal in the JAX layout, float16 kept, and the configs build the
    same networks."""
    from inclusivegan_torch.utils.misc import save_pkl
    from inclusivegan_tpu.training.training_loop import load_snapshot as j_load
    from torch_golden.narrow_nets import flat
    G, D, state = _narrow_state()
    path = str(tmp_path / "network-snapshot-000000.pkl")
    save_pkl(snapshot.snapshot_dict(G, D, state), path)
    JG, JD, params = j_load(path)
    for key, module in (("g_params", state.G), ("d_params", state.D),
                        ("gs_params", state.Gs)):
        want = {k: v.numpy() for k, v in module.state_dict().items()}
        got = flat(params[key])  # back in the port's layout
        assert set(got) == set(want), key
        for k, v in want.items():
            assert got[k].dtype == v.dtype, (key, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{key} {k}")
    assert params["g_params"]["synthesis"]["4x4"]["Conv"]["weight"].dtype == np.float16
    assert (JG.synthesis.resolution, JG.synthesis.architecture, JG.mapping.label_size,
            JD.architecture, JD.mbstd_group_size) == (32, "skip", 3, "resnet", 2)
    assert JG.synthesis.resample_kernel == (1, 3, 3, 1)


def test_jax_forward_of_the_ports_snapshot_matches(tmp_path):
    """The JAX generate-images CLI and the port's on the port's snapshot
    (float16 Gs): the same uint8 images, as in test_torch_generate.py."""
    import types
    import PIL.Image
    import run_generator as jax_run_generator
    from inclusivegan_torch import run_generator
    from inclusivegan_torch.utils.misc import save_pkl
    G, D, state = _narrow_state()
    path = str(tmp_path / "network-final.pkl")
    save_pkl(snapshot.snapshot_dict(G, D, state), path)
    jax_run_generator.generate_images(types.SimpleNamespace(run_dir=str(tmp_path)),
                                      path, 3, 2)
    want = np.stack([np.asarray(PIL.Image.open(tmp_path / f"{i:06d}.png"))
                     for i in range(3)])
    got = run_generator.generate_images(path, 3, 2, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_celeba_snapshot_round_trips_bit_for_bit(tmp_path):
    """The CelebA-128 snapshot resumed as a training state at its stored
    float16 and written again: every array of G, D and Gs equal to the
    original's, dtype included."""
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.training_loop import load_snapshot
    G, D, params = load_snapshot(CELEBA, device="cpu")
    state = create_train_state(G, D, generator=torch.Generator().manual_seed(0),
                               params=params)
    out = snapshot.snapshot_dict(G, D, state)
    src = snapshot.read_snapshot(CELEBA)
    for net in ("G", "D", "Gs"):
        want, got = dict(_flat(src[net]["params"])), dict(_flat(out[net]["params"]))
        assert set(got) == set(want), net
        for k, v in want.items():
            assert got[k].dtype == v.dtype == np.float16, (net, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{net} {k}")
