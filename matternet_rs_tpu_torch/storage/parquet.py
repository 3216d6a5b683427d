"""Parquet + JSON persistence of build artifacts (twin of the reference's
``storage/parquet.py``; the same files, column names and metadata).

* dense matrices: one float64 column per feature (``col_j``) with
  name / n_rows / n_cols metadata, Snappy compression;
* sparse matrices: COO triplets (``row``, ``col``, ``value``);
* λ vectors (``lambda``);
* the metadata JSON: the builder's typed config and the space's state
  (λ statistics, clusters, the projection as its seed);
* :func:`save_checkpoint` and :func:`load_arrowspace`, which rebuilds the
  sorted index without recomputing λ and regenerates the projection from
  its seed — on the card unless the caller asks for the CPU. An energy
  index also saves its sub-centroids, their λ and the item map, and
  resumes in energy mode with its item norms recomputed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from matternet_rs_tpu_torch.storage import StorageError


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ensure_dir(path: Path) -> Path:
    path = Path(path)
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        raise StorageError(f"cannot create storage directory {path}: {exc}") from exc
    return path


def _write_table(table, out: Path) -> Path:
    """Snappy Parquet write; IO errors become ``StorageError``."""
    try:
        pq.write_table(table, out, compression="snappy")
    except OSError as exc:
        raise StorageError(f"cannot write {out}: {exc}") from exc
    return out


def _metadata(name: str, builder, **shape) -> dict:
    meta = {b"name": name.encode()}
    meta.update({k.encode(): str(v).encode() for k, v in shape.items()})
    if builder is not None:
        meta[b"builder_config"] = json.dumps(builder_config_typed(builder)).encode()
    return meta


# -- dense matrices ----------------------------------------------------------


def save_dense_matrix(arr, path, name: str, builder=None) -> Path:
    # Column-major, so each column is handed to Arrow without a strided copy.
    arr = np.array(_host(arr), np.float64, order="F")
    if arr.ndim != 2:
        raise StorageError(f"expected 2-D matrix, got shape {arr.shape}")
    path = _ensure_dir(path)
    n_rows, n_cols = arr.shape
    table = pa.table({f"col_{j}": pa.array(arr[:, j]) for j in range(n_cols)})
    table = table.replace_schema_metadata(_metadata(name, builder, n_rows=n_rows, n_cols=n_cols))
    return _write_table(table, path / f"{name}.parquet")


def load_dense_matrix(path) -> np.ndarray:
    path = Path(path)
    if not path.exists():
        raise StorageError(f"missing file {path}")
    table = pq.read_table(path)
    md = table.schema.metadata or {}
    n_cols = int(md.get(b"n_cols", str(table.num_columns).encode()))
    return np.column_stack([np.asarray(table.column(f"col_{j}")) for j in range(n_cols)])


# -- sparse matrices (COO triplets) -------------------------------------------


def save_sparse_matrix(matrix, path, name: str, tol: float = 0.0, builder=None) -> Path:
    m = np.asarray(_host(matrix), np.float64)
    rows, cols = np.nonzero(np.abs(m) > tol)
    path = _ensure_dir(path)
    table = pa.table({
        "row": pa.array(rows.astype(np.int64)),
        "col": pa.array(cols.astype(np.int64)),
        "value": pa.array(m[rows, cols]),
    })
    table = table.replace_schema_metadata(
        _metadata(name, builder, n_rows=m.shape[0], n_cols=m.shape[1]))
    return _write_table(table, path / f"{name}.parquet")


def load_sparse_matrix(path) -> np.ndarray:
    path = Path(path)
    if not path.exists():
        raise StorageError(f"missing file {path}")
    table = pq.read_table(path)
    md = table.schema.metadata or {}
    out = np.zeros((int(md[b"n_rows"]), int(md[b"n_cols"])), np.float64)
    out[np.asarray(table.column("row")), np.asarray(table.column("col"))] = np.asarray(
        table.column("value"))
    return out


# -- λ vectors ---------------------------------------------------------------


def save_lambdas(lambdas, path, name: str, builder=None) -> Path:
    path = _ensure_dir(path)
    table = pa.table({"lambda": pa.array(np.asarray(_host(lambdas), np.float64))})
    table = table.replace_schema_metadata(_metadata(name, builder))
    return _write_table(table, path / f"{name}.parquet")


def load_lambdas(path) -> np.ndarray:
    path = Path(path)
    if not path.exists():
        raise StorageError(f"missing file {path}")
    return np.asarray(pq.read_table(path).column("lambda"))


# -- typed config + metadata JSON --------------------------------------------


def builder_config_typed(builder) -> dict:
    """The builder's config as plain JSON values."""
    return {
        "lambda_eps": builder.lambda_eps,
        "lambda_k": builder.lambda_k,
        "lambda_topk": builder.lambda_topk,
        "lambda_p": builder.lambda_p,
        "lambda_sigma": builder.lambda_sigma,
        "normalise": builder.normalise,
        "sparsity_check": builder.sparsity_check,
        "synthesis_mode": builder.synthesis.name,
        "synthesis_param": builder.synthesis.param,
        "prebuilt_spectral": builder.prebuilt_spectral,
        "sampling": list(builder.sampling) if builder.sampling else None,
        "cluster_max_clusters": builder.cluster_max_clusters,
        "cluster_radius": builder.cluster_radius,
        "clustering_seed": builder.clustering_seed,
        "deterministic_clustering": builder.deterministic_clustering,
        "use_dims_reduction": builder.use_dims_reduction,
        "rp_eps": builder.rp_eps,
    }


def config_summary(builder) -> str:
    """The set config values on one line."""
    return ", ".join(f"{k}={v}" for k, v in builder_config_typed(builder).items() if v is not None)


def arrowspace_config_typed(aspace) -> dict:
    """The space's state a search needs after a reload."""
    proj = aspace.projection
    return {
        "nfeatures": aspace.nfeatures,
        "nitems": aspace.nitems,
        "taumode_mode": aspace.taumode.name,
        "taumode_param": aspace.taumode.param,
        "min_lambdas": aspace.min_lambdas,
        "max_lambdas": aspace.max_lambdas,
        "range_lambdas": aspace.range_lambdas,
        "n_clusters": aspace.n_clusters,
        "cluster_radius": aspace.cluster_radius,
        "projection_seed": proj.seed if proj else None,
        "projection_original_dim": proj.original_dim if proj else None,
        "reduced_dim": aspace.reduced_dim,
        "extra_reduced_dim": aspace.extra_reduced_dim,
    }


def _file_info(out: Path, file_type: str, rows=None, cols=None, nnz=None) -> dict:
    """A manifest entry: file name, type, shape, non-zeros, bytes on disk."""
    return {"filename": out.name, "file_type": file_type, "rows": rows, "cols": cols,
            "nnz": nnz, "size_bytes": out.stat().st_size}


def save_arrowspace_metadata(aspace, builder, path, name: str, files=None) -> Path:
    path = _ensure_dir(path)
    doc = {
        "version": 1,
        "name": name,
        "arrowspace": arrowspace_config_typed(aspace),
        "builder": builder_config_typed(builder) if builder is not None else None,
    }
    if files is not None:
        doc["files"] = files
    out = path / f"{name}-arrowspace_metadata.json"
    out.write_text(json.dumps(doc, indent=2))
    return out


# -- checkpoint / resume -----------------------------------------------------


def save_checkpoint(aspace, gl, builder, path, name: str) -> None:
    """Every artifact of a built space with its manifest: the raw rows,
    the centroids, the Laplacian, the signals (if any), the λ, the energy
    state (if any) and the metadata JSON."""
    path = _ensure_dir(path)
    files = {}
    raw = _host(aspace.data)
    out = save_dense_matrix(raw, path, f"{name}-raw_input", builder)
    files["raw_input"] = _file_info(out, "dense", *raw.shape)
    init = _host(gl.init_data)
    out = save_dense_matrix(init, path, f"{name}-clustered-dm", builder)
    files["clustered_dm"] = _file_info(out, "dense", *init.shape)
    glm = _host(gl.dense())
    out = save_sparse_matrix(glm, path, f"{name}-gl-matrix", builder=builder)
    files["gl_matrix"] = _file_info(out, "sparse", *glm.shape, nnz=int(np.count_nonzero(glm)))
    if aspace.signals is not None:
        sig = _host(aspace.signals)
        out = save_sparse_matrix(sig, path, f"{name}-aspace-signals", builder=builder)
        files["signals"] = _file_info(out, "sparse", *sig.shape, nnz=int(np.count_nonzero(sig)))
    lam = _host(aspace.lambdas)
    out = save_lambdas(lam, path, f"{name}-lambdas", builder)
    files["lambdas"] = _file_info(out, "lambdas", rows=len(lam), cols=1)
    if aspace.sub_centroids is not None:
        sc = _host(aspace.sub_centroids)
        out = save_dense_matrix(sc, path, f"{name}-sub-centroids", builder)
        files["sub_centroids"] = _file_info(out, "dense", *sc.shape)
        scl = _host(aspace.subcentroid_lambdas)
        out = save_lambdas(scl, path, f"{name}-subcentroid-lambdas", builder)
        files["subcentroid_lambdas"] = _file_info(out, "lambdas", rows=len(scl), cols=1)
        cmap = np.asarray(aspace.centroid_map, np.float64)
        out = save_lambdas(cmap, path, f"{name}-centroid-map", builder)
        files["centroid_map"] = _file_info(out, "lambdas", rows=len(cmap), cols=1)
    save_arrowspace_metadata(aspace, builder, path, name, files=files)


def _graph_params(bcfg: dict):
    from matternet_rs_tpu_torch.graph import GraphParams

    return GraphParams(
        eps=bcfg.get("lambda_eps", 1e-3),
        k=bcfg.get("lambda_k", 6),
        topk=bcfg.get("lambda_topk", 3),
        p=bcfg.get("lambda_p", 2.0),
        sigma=bcfg.get("lambda_sigma"),
        normalise=bcfg.get("normalise", False),
        sparsity_check=bcfg.get("sparsity_check", False),
    )


def load_graph_laplacian(path, name: str, graph_params=None, energy: bool = False,
                         device=None):
    """The GraphLaplacian alone from stored artifacts, on ``device``
    (``None`` is the CUDA card)."""
    from matternet_rs_tpu_torch.backend import resolve_device
    from matternet_rs_tpu_torch.graph import GraphLaplacian, GraphParams

    dev = resolve_device(device)
    path = Path(path)
    matrix = load_sparse_matrix(path / f"{name}-gl-matrix.parquet")
    init_data = load_dense_matrix(path / f"{name}-clustered-dm.parquet")
    return GraphLaplacian(
        matrix=torch.from_numpy(matrix.astype(np.float32)).to(dev),
        init_data=torch.from_numpy(init_data.astype(np.float32)).to(dev),
        nnodes=matrix.shape[0],
        graph_params=graph_params or GraphParams(),
        energy=energy,
    )


def load_arrowspace(path, name: str, device=None):
    """Resume ``(ArrowSpace, GraphLaplacian)`` from a checkpoint directory
    on ``device`` (``None`` is the CUDA card): the stored λ and their
    statistics, the sorted index rebuilt, the projection regenerated from
    its seed. Every artifact the manifest lists must exist, and the λ
    count must equal the item count (``StorageError`` otherwise)."""
    from matternet_rs_tpu_torch.backend import resolve_device
    from matternet_rs_tpu_torch.core import ArrowSpace, TauMode
    from matternet_rs_tpu_torch.graph import GraphLaplacian
    from matternet_rs_tpu_torch.ops import taumode as taumode_ops
    from matternet_rs_tpu_torch.reduction import ImplicitProjection

    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / f"{name}-arrowspace_metadata.json").read_text())
    acfg = meta["arrowspace"]
    bcfg = meta.get("builder") or {}
    manifest = meta.get("files") or {}

    for key, info in manifest.items():
        if not (path / info["filename"]).exists():
            raise StorageError(
                f"checkpoint {name!r} manifest lists artifact {key} "
                f"({info['filename']}) but the file is missing"
            )
    data = load_dense_matrix(path / f"{name}-raw_input.parquet")
    lambdas = load_lambdas(path / f"{name}-lambdas.parquet")
    if len(lambdas) != data.shape[0]:
        raise StorageError(
            f"lambda count {len(lambdas)} does not match item count "
            f"{data.shape[0]} in checkpoint {name!r}"
        )
    matrix = load_sparse_matrix(path / f"{name}-gl-matrix.parquet")
    init_data = load_dense_matrix(path / f"{name}-clustered-dm.parquet")

    mode_map = {"fixed": taumode_ops.TAU_FIXED, "median": taumode_ops.TAU_MEDIAN,
                "mean": taumode_ops.TAU_MEAN, "percentile": taumode_ops.TAU_PERCENTILE}
    taumode = TauMode(mode_map[acfg["taumode_mode"]], acfg["taumode_param"])

    aspace = ArrowSpace.from_items(data, taumode, device=dev)
    aspace.lambdas = torch.from_numpy(lambdas.astype(np.float32)).to(dev)
    aspace.min_lambdas = acfg["min_lambdas"]
    aspace.max_lambdas = acfg["max_lambdas"]
    aspace.range_lambdas = acfg["range_lambdas"]
    aspace.n_clusters = acfg["n_clusters"]
    aspace.cluster_radius = acfg["cluster_radius"]
    if acfg.get("projection_seed") is not None:
        aspace.projection = ImplicitProjection(
            acfg["projection_original_dim"], acfg["reduced_dim"], acfg["projection_seed"])
        aspace.reduced_dim = acfg["reduced_dim"]
    aspace.extra_reduced_dim = bool(acfg.get("extra_reduced_dim", False))
    aspace.build_lambdas_sorted()

    signals_path = path / f"{name}-aspace-signals.parquet"
    if signals_path.exists():
        aspace.signals = torch.from_numpy(
            load_sparse_matrix(signals_path).astype(np.float32)).to(dev)

    sc_path = path / f"{name}-sub-centroids.parquet"
    if sc_path.exists():
        aspace.sub_centroids = torch.from_numpy(
            load_dense_matrix(sc_path).astype(np.float32)).to(dev)
        aspace.subcentroid_lambdas = load_lambdas(path / f"{name}-subcentroid-lambdas.parquet")
        aspace.centroid_map = load_lambdas(path / f"{name}-centroid-map.parquet").astype(np.int64)
        aspace.item_norms = torch.sqrt(torch.sum(aspace.data * aspace.data, dim=1))

    gl = GraphLaplacian(
        matrix=torch.from_numpy(matrix.astype(np.float32)).to(dev),
        init_data=torch.from_numpy(init_data.astype(np.float32)).to(dev),
        nnodes=acfg["nitems"],
        graph_params=_graph_params(bcfg),
        energy=aspace.sub_centroids is not None,
    )
    return aspace, gl
