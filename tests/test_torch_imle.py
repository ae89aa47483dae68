"""The port's IMLE orchestrator (inclusivegan_torch.training.imle, exact
backend) against the JAX package's (``knn_backend="exact"``), on the CPU:
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


def test_dci_backend_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="later slice"):
        timle.IMLEOrchestrator(data_size=DATA, num_samples_factor=5, latent_size=Z,
                               image_dim=3 * RES * RES, knn_backend="dci",
                               projector_cache_dir=str(tmp_path), device="cpu")


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
