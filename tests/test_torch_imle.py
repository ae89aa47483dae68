"""The port's IMLE orchestrator (inclusivegan_torch.training.imle) against
the JAX package's, on the CPU, with the exact backend and with DCI:
the same numpy ``generate_images`` callable and the same SyntheticDataset go
to both. Retrieved candidate ids must be identical, distances within 1e-4
(float32 matrix products in another order), the rec batches of
``next_rec_batch`` identical, and the staleness schedule identical."""

import numpy as np
import pytest
import torch

from inclusivegan_tpu.data.dataset import SyntheticDataset as JSyntheticDataset
from inclusivegan_tpu.training.imle import IMLEOrchestrator as JIMLE
from inclusivegan_torch.data.dataset import SyntheticDataset
from inclusivegan_torch.training import imle as timle

RES, Z, DATA = 8, 16, 24


def _generate_images(latents):
    """A fixed smooth map of latents to [-1, 1] images [B, 3, 8, 8]."""
    w = np.random.RandomState(0).randn(Z, 3 * RES * RES).astype(np.float32)
    return np.tanh(latents.astype(np.float32) @ w / 4).reshape(-1, 3, RES, RES)


def _pair(tmp_path, **kw):
    args = dict(data_size=DATA, num_samples_factor=5, latent_size=Z,
                image_dim=3 * RES * RES, candidate_batch_size=16, seed=3,
                projector_cache_dir=str(tmp_path), **kw)
    j = JIMLE(knn_backend="exact", **args)
    t = timle.IMLEOrchestrator(knn_backend="exact", device="cpu", **args)
    return j, t


def _datasets():
    kw = dict(resolution=RES, num_images=DATA, label_size=4, seed=5)
    return JSyntheticDataset(**kw), SyntheticDataset(**kw)


@pytest.mark.parametrize("kw", [
    dict(init_proj_dim=16), dict(init_proj_dim=None, dist_thres_percentile=50.0),
    dict(init_proj_dim=16, exclusive_retrieved_code=True)],
    ids=["projected", "raw-percentile", "exclusive"])
def test_retrieval_and_rec_batches_match_jax(tmp_path, kw):
    j, t = _pair(tmp_path, **kw)
    np.testing.assert_array_equal(t.latent_candidates, j.latent_candidates)
    if j.projector is not None:
        np.testing.assert_array_equal(t.projector, j.projector)
    jds, tds = _datasets()
    np.testing.assert_array_equal(tds.get_all_images(), jds.get_all_images())
    j.rebuild(_generate_images, jds, verbose=False)
    t.rebuild(_generate_images, tds, verbose=False)
    np.testing.assert_array_equal(t.selected_latents, j.selected_latents)
    np.testing.assert_allclose(t.selected_dists, j.selected_dists, rtol=1e-4, atol=1e-4)
    assert t.dist_thres == pytest.approx(j.dist_thres, rel=1e-4)
    for _ in range(6):  # past one epoch of the rec set (24 / 6 per iteration)
        for a, b in zip(t.next_rec_batch(tds, 3), j.next_rec_batch(jds, 3)):
            np.testing.assert_array_equal(a, b)
        assert t.cursor == j.cursor


def test_staleness_schedule_matches_jax(tmp_path):
    j, t = _pair(tmp_path, init_proj_dim=16, init_staleness=1)
    jds, tds = _datasets()
    mb2 = 6
    for it in range(40):
        cur = it * 3
        need = t.needs_rebuild(cur, mb2)
        assert need == j.needs_rebuild(cur, mb2), it
        if need:
            j.rebuild(_generate_images, jds, verbose=False)
            t.rebuild(_generate_images, tds, verbose=False)
        assert t.staleness == j.staleness
    assert t.staleness > 1


def test_knn_topk_keeps_the_earlier_of_equal_candidates():
    cand = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [2.0, 2.0]])
    q = torch.tensor([[1.0, 0.0], [0.0, 0.9]])
    d, i = timle._knn_topk(q, cand, 1, chunk=2)
    assert i[:, 0].tolist() == [0, 1]
    np.testing.assert_allclose(d[:, 0].numpy(), [0.0, 0.1], atol=1e-6)
    d3, i3 = timle._knn_topk(q, cand, 3, chunk=3)
    assert sorted(i3[0].tolist()[:2]) == [0, 2]


def test_dci_backend_builds_an_index(tmp_path):
    """knn_backend='dci': the rebuild makes the host index at the production
    shape's tables (3 x 15 directions over proj_dim, 2 levels) over every
    candidate, and retrieves a latent for every real."""
    t = timle.IMLEOrchestrator(data_size=DATA, num_samples_factor=5, latent_size=Z,
                               image_dim=3 * RES * RES, knn_backend="dci",
                               init_proj_dim=16, projector_cache_dir=str(tmp_path),
                               device="cpu")
    assert t.dci is None  # nothing is built before the first rebuild
    _, tds = _datasets()
    t.rebuild(_generate_images, tds, verbose=False)
    assert t.dci.num_points == DATA * 5 and t.dci.num_levels == 2
    assert t.dci.proj_vec.shape == (45, 16)
    assert t.selected_latents.shape == (DATA, Z) and np.isfinite(t.selected_dists).all()


# ---------------------------------------------------------------------------
# The DCI backend against the JAX package's, on tests/test_imle.py's set:
# reals that are the images of known latents under a fixed linear G.

class _LinearG:
    def __init__(self, seed=0):
        self.W = np.random.RandomState(seed).randn(3 * RES * RES, 8) * 0.3

    def __call__(self, latents):
        return np.tanh(latents @ self.W.T).reshape(-1, 3, RES, RES).astype(np.float32)


class _GeneratedDataset:
    def __init__(self, g, latents):
        self._images = ((g(latents) + 1) * 127.5).astype(np.uint8)
        self._labels = np.zeros((len(latents), 0), np.float32)
        self.num_images = len(latents)
        self._cursor = 0

    def get_all_images(self):
        return self._images

    def get_minibatch_np(self, n):
        idx = (np.arange(n) + self._cursor) % self.num_images
        self._cursor += n
        return self._images[idx], self._labels[idx]


def _dci_pair(tmp_path, **kw):
    args = dict(data_size=32, num_samples_factor=4, latent_size=8,
                image_dim=3 * RES * RES, knn_perturb_factor=0.0, candidate_batch_size=16,
                num_comp_indices=2, num_simp_indices=6, num_levels=1, seed=0,
                projector_cache_dir=str(tmp_path), knn_backend="dci")
    args.update(kw)
    return JIMLE(**args), timle.IMLEOrchestrator(device="cpu", **args)


@pytest.mark.parametrize("kw", [
    dict(), dict(init_proj_dim=16), dict(exclusive_retrieved_code=True),
    dict(init_proj_dim=16, num_samples_factor=40, num_levels=2)],
    ids=["raw", "projected", "exclusive", "projected-1280"])
def test_dci_rebuild_matches_jax(tmp_path, kw):
    """The same candidates, reals, index seed (drawn from the orchestrator's
    PCG64 stream) and budgets: the same selected latents. Raw features are
    float32 images in both; projected ones are float32 products summed in
    other orders (XLA's and torch's), which move distances by under 1e-6
    and have moved no neighbour on these sets. Exclusive mode's ids are
    distinct, and the rec batches after the rebuild are equal."""
    j, t = _dci_pair(tmp_path, **kw)
    g = _LinearG()
    reals = np.random.RandomState(1).randn(32, 8)
    jds, tds = _GeneratedDataset(g, reals), _GeneratedDataset(g, reals)
    j.rebuild(g, jds, verbose=False)
    t.rebuild(g, tds, verbose=False)
    np.testing.assert_array_equal(t.dci.proj_vec, j.dci.proj_vec)
    np.testing.assert_array_equal(t.selected_latents, j.selected_latents)
    np.testing.assert_allclose(t.selected_dists, j.selected_dists, rtol=0, atol=1e-6)
    if kw.get("exclusive_retrieved_code"):
        ids = [int(np.flatnonzero((t.latent_candidates == z).all(1))[0])
               for z in t.selected_latents]
        assert len(set(ids)) == len(ids)
    for a, b in zip(t.next_rec_batch(tds, 4), j.next_rec_batch(jds, 4)):
        np.testing.assert_array_equal(a, b)


def test_knn_backend_exact_matches_or_beats_dci(tmp_path):
    """Exact never retrieves a farther neighbour than DCI, and agrees with
    brute force on the host."""
    g = _LinearG()
    ds = _GeneratedDataset(g, np.random.RandomState(7).randn(32, 8))
    runs = {}
    for backend in ("exact", "dci"):
        _, t = _dci_pair(tmp_path, knn_backend=backend)
        t.rebuild(g, ds, verbose=False)
        runs[backend] = t
    assert (runs["exact"].selected_dists <= runs["dci"].selected_dists + 1e-4).all()
    cand = g(runs["exact"].latent_candidates).reshape(128, -1).astype(np.float64)
    reals = (ds.get_all_images().astype(np.float64) / 127.5 - 1.0).reshape(32, -1)
    bf = ((reals[:, None] - cand[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_allclose(runs["exact"].selected_latents,
                               runs["exact"].latent_candidates[bf], atol=1e-6)


def test_dci_cost_gate_routes_and_warns(tmp_path, monkeypatch, capsys):
    """auto beyond the exact budget with a DCI build over its time budget
    raises with guidance; an explicit dci warns and runs."""
    assert timle.estimate_dci_build_seconds(2_400_000) > \
        timle.estimate_dci_build_seconds(240_000) > 0
    monkeypatch.setattr(timle, "_EXACT_KNN_MEMORY_BUDGET", 0)
    monkeypatch.setattr(timle, "_DCI_BUILD_BUDGET_S", 0.0)
    g = _LinearG()
    ds = _GeneratedDataset(g, np.random.RandomState(1).randn(32, 8))
    _, t = _dci_pair(tmp_path, knn_backend="auto")
    with pytest.raises(RuntimeError, match="knn_backend='dci'"):
        t.rebuild(g, ds, verbose=False)
    _, t = _dci_pair(tmp_path, knn_backend="dci")
    t.rebuild(g, ds, verbose=False)
    assert t.selected_latents is not None
    assert "projected to take" in capsys.readouterr().out


def test_dci_host_memory_gate(tmp_path, monkeypatch):
    """Features beyond the host budget fail before any candidate is
    rendered, with init_proj_dim guidance."""
    monkeypatch.setattr(timle, "_EXACT_KNN_MEMORY_BUDGET", 0)
    monkeypatch.setattr(timle, "_DCI_HOST_MEM_BUDGET", 0)
    _, t = _dci_pair(tmp_path, knn_backend="dci")

    def no_render(z):
        raise AssertionError("rendered before the gate")

    with pytest.raises(RuntimeError, match="init_proj_dim"):
        t.rebuild(no_render, None, verbose=False)


def test_routing_matches_jax_at_the_celeba_shapes():
    """auto picks the same backend as the JAX package at the CelebA run's
    shapes: 300,000 candidates at proj_dim 512 fit the exact budget, the
    un-projected 49152 do not (and then pass the host budget)."""
    from inclusivegan_tpu.training import imle as jimle
    assert timle._EXACT_KNN_MEMORY_BUDGET == jimle._EXACT_KNN_HBM_BUDGET
    assert timle._DCI_HOST_MEM_BUDGET == jimle._DCI_HOST_MEM_BUDGET
    assert timle._DCI_BUILD_BUDGET_S == jimle._DCI_BUILD_BUDGET_S
    assert 300_000 * 512 * 4 <= timle._EXACT_KNN_MEMORY_BUDGET
    assert 300_000 * 49152 * 8 > timle._DCI_HOST_MEM_BUDGET


def test_func_proj_dim_matches_jax():
    from inclusivegan_tpu.training.imle import func_proj_dim
    for args in ((None, 10, 5, 99), (0, 240, 10, 49152), (512, 10, 5, 99)):
        assert timle.func_proj_dim(*args) == func_proj_dim(*args)


def test_host_helper_copies_match_jax():
    from inclusivegan_tpu.utils.misc import adjust_dynamic_range as j_adr
    from inclusivegan_tpu.utils.misc import slerp_np as j_slerp
    from inclusivegan_torch.utils.misc import adjust_dynamic_range, slerp_np
    rnd = np.random.RandomState(1)
    a, b = rnd.randn(4, 6).astype(np.float32), rnd.randn(4, 6).astype(np.float32)
    np.testing.assert_array_equal(slerp_np(a, b, 0.05), j_slerp(a, b, 0.05))
    x = rnd.randint(0, 256, (2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(adjust_dynamic_range(x, [0, 255], [-1, 1]),
                                  j_adr(x, [0, 255], [-1, 1]))
    jds, tds = _datasets()
    np.testing.assert_array_equal(tds.get_all_labels(), jds.get_all_labels())
    for a, b in zip(tds.get_minibatch_np(5), jds.get_minibatch_np(5)):
        np.testing.assert_array_equal(a, b)
