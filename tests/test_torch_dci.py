"""The port's DCI (inclusivegan_torch.dci) on the CPU: each case of
tests/test_dci.py on the port's binding, the port's index against the JAX
package's on the same data, seed and projections (the same C++ source built
with the same flags: directions, ids and distances equal exactly), and
``DciNnSearch`` against the JAX package's ``jax_op.DciNnSearch``."""

import numpy as np
import pytest
import torch

from inclusivegan_torch.dci import DCI
from inclusivegan_torch.dci.example import gen_data
from inclusivegan_torch.dci.torch_op import DciNnSearch


def _low_intrinsic_data(n, ambient_dim, intrinsic_dim, seed=0, basis_seed=1234):
    """Points on one shared low-dimensional subspace."""
    basis = np.random.RandomState(basis_seed).randn(intrinsic_dim, ambient_dim)
    coords = np.random.RandomState(seed).randn(n, intrinsic_dim)
    return (coords @ basis).astype(np.float64)


def _brute_1nn(data, queries):
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1), np.sqrt(d2.min(1))


def test_exact_on_small_set():
    data = _low_intrinsic_data(200, 32, 4)
    queries = _low_intrinsic_data(20, 32, 4, seed=1)
    dci = DCI(32, num_comp_indices=2, num_simp_indices=7)
    dci.add(data, num_levels=1)
    ids, dists = dci.query(queries, num_neighbours=1, prop_to_retrieve=1.0,
                           max_retrieve=200, max_visits=100000)
    bf_ids, bf_dists = _brute_1nn(data, queries)
    np.testing.assert_array_equal([i[0] for i in ids], bf_ids)
    np.testing.assert_allclose([d[0] for d in dists], bf_dists, rtol=1e-9)


@pytest.mark.parametrize("num_levels", [1, 2, 3])
def test_recall_low_intrinsic_dim(num_levels):
    data = _low_intrinsic_data(5000, 64, 6)
    queries = _low_intrinsic_data(200, 64, 6, seed=2)
    dci = DCI(64, num_comp_indices=3, num_simp_indices=10)
    dci.add(data, num_levels=num_levels)
    ids, _ = dci.query(queries, num_neighbours=1, field_of_view=16,
                       max_retrieve=300, max_visits=20000)
    bf_ids, _ = _brute_1nn(data, queries)
    recall = float((np.array([i[0] if i else -1 for i in ids]) == bf_ids).mean())
    assert recall >= 0.9, f"1-NN recall {recall} at num_levels={num_levels}"


def test_knn_ordering_and_counts():
    data = _low_intrinsic_data(1000, 16, 3)
    queries = data[:5] + 1e-3  # near-duplicates of known points
    dci = DCI(16)
    dci.add(data, num_levels=1)
    ids, dists = dci.query(queries, num_neighbours=5, max_retrieve=500, max_visits=50000)
    for i in range(5):
        assert len(ids[i]) == 5 and ids[i][0] == i
        assert all(dists[i][j] <= dists[i][j + 1] for j in range(4))
        assert len(set(ids[i])) == 5


def test_external_projections_match_internal():
    data = _low_intrinsic_data(800, 24, 4)
    queries = _low_intrinsic_data(50, 24, 4, seed=3)
    a = DCI(24, seed=42)
    a.add(data, num_levels=1)
    b = DCI(24, seed=42)
    b.add(data, num_levels=1, projections=data @ b.proj_vec.T)
    ids_a, d_a = a.query(queries, num_neighbours=1, max_retrieve=200)
    ids_b, d_b = b.query(queries, num_neighbours=1, max_retrieve=200,
                         projections=queries @ b.proj_vec.T)
    assert [i[0] for i in ids_a] == [i[0] for i in ids_b]
    np.testing.assert_allclose([d[0] for d in d_a], [d[0] for d in d_b], rtol=1e-9)


def test_reset_and_readd():
    data = _low_intrinsic_data(100, 8, 2)
    dci = DCI(8)
    dci.add(data, num_levels=1)
    assert dci.num_points == 100
    pv1 = dci.proj_vec.copy()
    dci.reset(seed=99)
    assert dci.num_points == 0
    assert np.abs(pv1 - dci.proj_vec).max() > 1e-6
    dci.add(data[:50], num_levels=2)
    assert dci.num_points == 50 and dci.num_levels == 2
    ids, _ = dci.query(data[:3], num_neighbours=1)
    assert [i[0] for i in ids] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="clear"):
        dci.add(data, num_levels=1)
    dci.clear()
    dci.add(data, num_levels=1)
    assert dci.num_points == 100 and np.array_equal(dci.proj_vec, DCI(8, seed=99).proj_vec)


def test_proj_vec_unit_norm():
    pv = DCI(32, num_comp_indices=2, num_simp_indices=5).proj_vec
    assert pv.shape == (10, 32)
    np.testing.assert_allclose(np.linalg.norm(pv, axis=1), 1.0, rtol=1e-9)


@pytest.mark.parametrize("projected", [False, True], ids=["internal", "projections"])
def test_port_index_equals_the_jax_packages(projected):
    """The same data, seed, projections and budgets through both bindings:
    directions, ids and distances equal exactly, for k = 1 and k = 4."""
    from inclusivegan_tpu.dci import DCI as JDCI
    data = gen_data(48, 6, 3000, seed=4)
    queries = gen_data(48, 6, 64, seed=5)
    t, j = DCI(48, 3, 8, seed=17), JDCI(48, 3, 8, seed=17)
    np.testing.assert_array_equal(t.proj_vec, j.proj_vec)
    proj = (data @ t.proj_vec.T) if projected else None
    qproj = (queries @ t.proj_vec.T) if projected else None
    t.add(data, num_levels=2, projections=proj)
    j.add(data, num_levels=2, projections=proj)
    for k, kw in ((1, dict(field_of_view=200)), (4, dict(max_retrieve=64, max_visits=900))):
        assert t.query(queries, num_neighbours=k, projections=qproj, **kw) == \
            j.query(queries, num_neighbours=k, projections=qproj, **kw)
    t.reset(seed=5)
    j.reset(seed=5)
    np.testing.assert_array_equal(t.proj_vec, j.proj_vec)


def test_nn_search_matches_the_jax_op():
    """DciNnSearch: a persistent index queried with a tensor, -1 padding,
    and update_db rebuilding it, against the JAX op inside jit."""
    import jax
    import jax.numpy as jnp
    from inclusivegan_tpu.dci.jax_op import DciNnSearch as JDciNnSearch
    data = _low_intrinsic_data(200, 16, 3)
    queries = _low_intrinsic_data(17, 16, 3, seed=7)
    op = DciNnSearch(16, num_comp_indices=2, num_simp_indices=7, num_levels=1)
    jop = JDciNnSearch(16, num_comp_indices=2, num_simp_indices=7, num_levels=1)
    op.update_db(torch.from_numpy(data))
    jop.update_db(data)
    ids, dists = op.nn_search(torch.tensor(queries, dtype=torch.float32), max_retrieve=200)
    jids, jdists = jax.jit(lambda q: jop.nn_search(q, max_retrieve=200))(
        jnp.asarray(queries, jnp.float32))
    assert ids.dtype == torch.int32 and dists.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(dists.numpy(), np.asarray(jdists))
    np.testing.assert_array_equal(ids[:, 0].numpy(), _brute_1nn(data, queries)[0])
    op.update_db(data[:3])
    ids, dists = op.nn_search(torch.tensor(data[:3]), num_neighbours=5)
    assert ids[:, 0].tolist() == [0, 1, 2]
    assert (ids[:, 3:] == -1).all() and (dists[:, 3:] == -1).all()


@pytest.mark.parametrize("max_visits", [None, 131072], ids=["default_budgets", "max_visits_131072"])
def test_port_index_equals_the_jax_packages_at_the_orchestrators_settings(max_visits):
    """The IMLE orchestrator's index (dim 512, 3 x 15 directions, 2 levels,
    field of view 200, k = 1) on 8192 points of dci/example.py's generator:
    the port's ids and distances equal the JAX package's, so its recall@1
    (read by tests/torch_golden/dci_recall.py) is the reference's; each
    query's distance never falls below the exact one."""
    from inclusivegan_tpu.dci import DCI as JDCI
    from torch_golden.dci_recall import DIM, TABLES, query, sample
    data, queries, exact = sample(8192, 200)
    t, j = DCI(DIM, *TABLES, seed=1), JDCI(DIM, *TABLES, seed=1)
    t.add(data, num_levels=2)
    j.add(data, num_levels=2)
    ids, dists = query(t, queries, max_visits)
    assert (ids, dists) == query(j, queries, max_visits)
    exact_d = np.sqrt(((queries - data[exact]) ** 2).sum(1))
    assert (np.array([d[0] for d in dists]) >= exact_d - 1e-9).all()
