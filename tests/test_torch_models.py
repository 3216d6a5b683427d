"""Port vs reference: the model-family façades (``models/``), each fitted
by both packages on the same rows (the fixtures of
``tests/test_models.py``), on torch-CPU and JAX-CPU.

Tolerances: λ and stage-D λ within 1e-5 (the taumode tests' bound);
search ids equal and scores within 1e-5 on every tier; energy distances
under the same-k rule at ``ENERGY_TIE_TOL``; smoothed centroids within
1e-5."""

import numpy as np
import pytest

from matternet_rs_tpu import pipeline as jp
from matternet_rs_tpu.models import EigenIndex as JEigen
from matternet_rs_tpu.models import EnergyIndex as JEnergy
from matternet_rs_tpu.models import SurffaceModel as JSurfface
from matternet_rs_tpu.utils.fixtures import make_energy_test_dataset, make_gaussian_blob

from matternet_rs_tpu_torch import pipeline as tp
from matternet_rs_tpu_torch.models import EigenIndex, EnergyIndex, SurffaceModel
from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches

CPU = "cpu"
TOL = 1e-5
TIERS = (False, True, "auto", "int8", "int8_rescored", "int8_auto", "bf16x3_rescored")


@pytest.fixture(scope="module")
def eigen_pair():
    data = make_gaussian_blob(150, 0.4).astype(np.float32)
    kw = dict(eps=1.0, k=6, max_clusters=12, radius=4.0)
    return data, JEigen(**kw).fit(data), EigenIndex(**kw, device=CPU).fit(data)


def test_eigen_index_fit_and_query_match(eigen_pair):
    data, ref, got = eigen_pair
    assert isinstance(got.lambdas, np.ndarray) and got.lambdas.shape == (150,)
    np.testing.assert_allclose(got.lambdas, np.asarray(ref.lambdas), atol=TOL, rtol=0)
    r, g = ref.query(data[31], k=5), got.query(data[31], k=5)
    assert g[0][0] == 31 and [i for i, _ in g] == [i for i, _ in r]
    np.testing.assert_allclose([s for _, s in g], [s for _, s in r], atol=TOL, rtol=0)


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_eigen_index_query_batch_tiers_match(eigen_pair, tier):
    data, ref, got = eigen_pair
    ri, rs = ref.query_batch(data[:8], k=5, quantized=tier)
    gi, gs = got.query_batch(data[:8], k=5, quantized=tier)
    assert gi.shape == (8, 5) and (gi[:, 0] == np.arange(8)).all()
    assert np.array_equal(gi, np.asarray(ri))
    np.testing.assert_allclose(gs, np.asarray(rs), atol=TOL, rtol=0)


def test_eigen_index_single_query_batch_equals_query(eigen_pair):
    data, _, got = eigen_pair
    ref = got.query(data[31], k=5)
    ids, sc = got.query_batch(data[31], k=5)
    assert ids[0][0] == ref[0][0]
    assert sc[0][0] == pytest.approx(ref[0][1], abs=TOL)


def test_eigen_index_save_loads_in_both_packages(tmp_path):
    from matternet_rs_tpu.storage import parquet as jpq
    from matternet_rs_tpu_torch.storage import parquet as tpq

    data = make_gaussian_blob(100, 0.4).astype(np.float32)
    idx = EigenIndex(eps=1.0, k=6, max_clusters=10, radius=4.0, device=CPU).fit(data)
    idx.save(tmp_path, "m")
    a2, _ = tpq.load_arrowspace(tmp_path, "m", device=CPU)
    j2, _ = jpq.load_arrowspace(tmp_path, "m")
    assert a2.nitems == j2.nitems == 100
    np.testing.assert_array_equal(a2.lambdas.numpy(), np.asarray(j2.lambdas))


@pytest.mark.parametrize("cls", [EigenIndex, EnergyIndex])
def test_unfitted_raises(cls):
    with pytest.raises(ValueError, match="fit"):
        cls(device=CPU).query(np.zeros(4), 3)
    with pytest.raises(ValueError, match="fit"):
        cls(device=CPU).lambdas


def test_energy_index_fit_and_query_match():
    data = make_energy_test_dataset(200, 32, seed=5).astype(np.float32)
    kw = dict(max_clusters=30, radius=16.0, seed=11)
    ref, got = JEnergy(**kw).fit(data), EnergyIndex(**kw, device=CPU).fit(data)
    np.testing.assert_allclose(got.lambdas, np.asarray(ref.lambdas), atol=TOL, rtol=0)
    r, g = ref.query(data[50], k=5), got.query(data[50], k=5)
    assert len(g) == 5 and g[0][1] <= g[-1][1]
    assert not same_k_mismatches([[i for i, _ in r]], [[d for _, d in r]],
                                 [[i for i, _ in g]], [[d for _, d in g]], ENERGY_TIE_TOL)


def test_surfface_model_fit_matches():
    data = make_gaussian_blob(120, 0.4).astype(np.float32)
    ref = JSurfface(config=jp.PipelineConfig(
        clustering=jp.ClusteringConfig(max_clusters=15, radius_threshold=16.0))).fit(data)
    got = SurffaceModel(config=tp.PipelineConfig(
        clustering=tp.ClusteringConfig(max_clusters=15, radius_threshold=16.0)), device=CPU).fit(data)
    assert got.lambdas.shape == (120,) and got.centroids.shape[1] == 10
    assert isinstance(got.centroids, np.ndarray)
    np.testing.assert_allclose(got.lambdas, np.asarray(ref.lambdas), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.centroids, np.asarray(ref.centroids), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="fit"):
        SurffaceModel(device=CPU).centroids


def test_fields_follow_the_reference():
    import dataclasses

    for port, ref in ((EigenIndex, JEigen), (EnergyIndex, JEnergy), (SurffaceModel, JSurfface)):
        # Defaults by repr: the two packages' TauMode are distinct classes.
        pf = [(f.name, repr(f.default)) for f in dataclasses.fields(port)]
        rf = [(f.name, repr(f.default)) for f in dataclasses.fields(ref)]
        assert pf[:-1] == rf and pf[-1] == ("device", "None"), port.__name__
