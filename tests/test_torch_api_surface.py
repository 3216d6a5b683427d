"""The checks of ``tests/test_api_surface.py`` that no other port test
holds, on the port (the CPU) with the reference's assertions:
``CentroidState.regularize_variances`` (also against the reference's) and
the SF-GRASS class API with its ratio clamps.

The other ten are held already: ``ArrowItem.euclidean_distance`` and
``get_item`` by ``test_torch_items.py`` (against the reference);
``EnergyParams.large_dataset`` by
``test_torch_energymaps.py::test_energy_params_presets_match`` (every preset
equal to the reference's); the energy motif subgraphs by
``test_torch_motives_subgraphs.py::test_spot_subg_motives_matches``;
``pad_to_mesh`` by ``test_torch_parallel_mesh.py`` and the backend probes
by ``test_torch_pipeline.py::test_backend_rest``; ``device_trace`` by
``test_torch_fixtures_profiling.py::test_device_trace_writes_a_trace``;
``mm_fast`` by ``test_torch_native_helpers.py``; ``lambda_aware_scores`` by
``test_torch_lambda_search.py::test_cosine_and_lambda_aware_scores``
(equal to the reference's scores); the item mutation family by
``test_torch_lambda_search.py`` (the reference's
``test_item_mutation_family`` on the port); the MST's connectivity by
``test_torch_pipeline.py`` (``is_connected`` equal to the reference's);
``empty_with_projection`` by
``test_torch_reduction.py::test_empty_with_projection_and_drop_data``.
"""

import numpy as np
import pytest
import torch


def test_centroid_state_regularize_variances():
    import jax.numpy as jnp

    from matternet_rs_tpu.pipeline.centroid import CentroidState as JCentroidState
    from matternet_rs_tpu_torch.pipeline.centroid import CentroidState

    variances = np.asarray([[0.0, 5.0], [1e-9, 0.5], [10.0, 2.0]], np.float32)
    st = CentroidState(means=torch.zeros((3, 2)), variances=torch.from_numpy(variances),
                       counts=torch.tensor([1, 2, 3]))
    reg = st.regularize_variances(eps=0.01, min_var=0.1, max_var=3.0)
    v = reg.variances.numpy()
    assert v.min() >= 0.1 and v.max() <= 3.0
    assert float(st.variances.max()) == 10.0          # the original untouched
    ref = JCentroidState(means=jnp.zeros((3, 2)), variances=jnp.asarray(variances),
                         counts=jnp.asarray([1, 2, 3])).regularize_variances(
        eps=0.01, min_var=0.1, max_var=3.0)
    np.testing.assert_allclose(v, np.asarray(ref.variances), rtol=1e-6, atol=0)


def test_sfgrass_class_api_matches_function():
    from matternet_rs_tpu_torch import sparsification as sp

    rng = np.random.default_rng(0)
    n = 40
    W = np.abs(rng.normal(size=(n, n)))
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0.0)

    s = sp.SfGrassSparsifier(0.9).with_target_ratio(0.5)
    assert s.target_ratio == pytest.approx(0.5)
    out = np.asarray(s.sparsify_adjacency(W))
    kept = (out > 0).sum(1)
    orig = (W > 1e-12).sum(1)
    assert (kept >= 1).all()
    assert (kept <= np.ceil(orig * 0.5) + 1).all()
    assert sp.SfGrassSparsifier(5.0).target_ratio == pytest.approx(1.0)
    assert sp.SfGrassSparsifier(0.0).target_ratio == pytest.approx(0.1)
