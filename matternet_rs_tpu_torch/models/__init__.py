"""Model families: fit/query façades over the three pipelines (twin of the
reference's ``models/``):

* :class:`EigenIndex`   — the canonical λτ-graph index (eigenmaps path),
* :class:`EnergyIndex`  — the cosine-free energy index (energymaps path),
* :class:`SurffaceModel`— the staged A→D pipeline (centroid skeleton +
  Kalman smoothing + stage-D spectral λ).

Each façade fits on the CUDA card unless its ``device`` is ``"cpu"``.
"""

from matternet_rs_tpu_torch.models.families import EigenIndex, EnergyIndex, SurffaceModel

__all__ = ["EigenIndex", "EnergyIndex", "SurffaceModel"]
