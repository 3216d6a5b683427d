"""The resident int8 sketch sharded over a mesh (twin of the reference's
``parallel/sketch.py``): for corpora whose sketch outgrows one card.

The stacked ``[nb, blk, F]`` sketch blocks are split over the slots (each
holds ``nb/D`` blocks, ≈ N·(F + 8)/D bytes); each slot runs the
single-card scan over its blocks — the block-carry scan
(:func:`..index.streaming.scan_sketch_blocks`, its global ids from the
slot's row base) or, where the maxima-first envelope holds at the slot's
size, kernels D and E (:func:`..index.streaming._sketch_maxfirst_topk`) —
and one gather of ``[B, C]`` ids and scores a slot with the deterministic
(score desc, id asc) re-rank gives the global candidates. The exact disk
rescore is the single-card one (:meth:`StreamingIndex.refine_candidates`).
"""

from __future__ import annotations

import numpy as np
import torch

from matternet_rs_tpu_torch.index.streaming import (
    MAXFIRST_MIN_ROWS,
    StreamingIndex,
    _sketch_maxfirst_topk,
    scan_sketch_blocks,
    suffix_padded,
)
from matternet_rs_tpu_torch.ops import scores as score_ops
from matternet_rs_tpu_torch.ops import search as so
from matternet_rs_tpu_torch.parallel.mesh import Mesh, local_map, replicate, sharded
from matternet_rs_tpu_torch.parallel.search import _gathered_rows, merge_topk


def make_sharded_sketch_scan(mesh: Mesh, kk: int, energy: bool = False,
                             maxfirst: bool = False, kfinal: int = 10):
    """The sharded sketch scan: ``scan(X8s, mults, lams, valids, row_info,
    Q, q_lams, alpha) -> (scores [B, kk], ids [B, kk])`` on the lead device
    (λ already normalised; ``alpha`` as :func:`..ops.scores.alpha_param`
    leaves it, a ``[B]`` vector for ``maxfirst``; ``row_info`` each slot's
    first global id and real-row count, on the host; ids −1 and scores
    −inf where a row has fewer candidates). ``energy=True`` scans the
    energy semantics (negated distances: callers flip the sign);
    ``maxfirst=True`` (blend only) runs each slot through kernels D and E,
    ``kfinal`` sizing its slab budget — the caller checks the envelope
    (:meth:`ShardedSketch._maxfirst_ok`)."""
    if maxfirst and energy:
        raise ValueError("maxfirst scan is blend-mode only")

    def body(slot, X8l, ml, ll, vl, row_info, Ql, qll, al):
        base, n_valid = (int(v) for v in row_info)
        if maxfirst:
            nb_l, blk, f = X8l.shape
            n_l = nb_l * blk
            top, idx = _sketch_maxfirst_topk(
                X8l.view(n_l, f), ml.view(n_l), ll.view(n_l), Ql, qll, al,
                rows_out=kk, kfinal=kfinal, n_items=n_valid)
            return top, torch.where(idx >= 0, idx + base, -1)
        return scan_sketch_blocks(X8l, ml, ll, vl, Ql, qll, al, 0.0, 1.0, kk, base, energy=energy)

    def scan(X8s, mults, lams, valids, row_info, Q, q_lams, alpha):
        al = alpha if isinstance(alpha, float) else replicate(mesh, alpha)
        outs = local_map(mesh, body, X8s, mults, lams, valids, row_info, replicate(mesh, Q),
                         replicate(mesh, q_lams), al)
        all_s = _gathered_rows(mesh, [o[0] for o in outs])
        all_i = _gathered_rows(mesh, [o[1] for o in outs])
        ids, sc = merge_topk(all_s, all_i, kk)
        return sc, ids

    return scan


class ShardedSketch:
    """The int8 sketch of a built :class:`StreamingIndex` sharded over a
    mesh, serving its blended and energy top-k: the index gives the disk
    layout, the λ stats, the query λ and the exact refine; this class
    replaces the scan. The host keeps one dense copy of the sketch while
    placing it (the block count padded to a slot multiple at allocation,
    so no second copy)."""

    def __init__(self, index: StreamingIndex, mesh: Mesh,
                 sketch_maxfirst: bool | None = None):
        d = mesh.size
        n, blk = index.n_items, index.block_rows
        nb = (n + blk - 1) // blk
        X8h, multh, lamh, validh = index.sketch_host_buffers(nb_pad=nb + ((-nb) % d))
        self._place(index, mesh, X8h, multh, lamh, validh, sketch_maxfirst,
                    stats=(float(index.min_lambdas), float(index.range_lambdas)))

    def _place(self, index, mesh, X8h, multh, lamh, validh, sketch_maxfirst, stats=None):
        """Ship each slot its blocks. With ``stats = (min, range)`` the raw
        λ is normalised once, on each slot's device, by the expression the
        single-card scan applies per block (``clamp((λ − mn)/rng, 0, 1)``),
        so every scan then folds with mn = 0, rng = 1, an identity, and
        the scores are the single card's bit for bit."""
        self.index = index
        self.mesh = mesh
        # None: the maxima-first scan from MAXFIRST_MIN_ROWS rows a slot;
        # True/False force it or the carry scan.
        self.sketch_maxfirst = sketch_maxfirst
        d = mesh.size
        if X8h.shape[0] % d:
            raise ValueError(f"{X8h.shape[0]} sketch blocks do not split over {d} slots")
        bpd = self.blocks_per_device = X8h.shape[0] // d
        blk = X8h.shape[1]
        # Each slot's first global id: the items in all earlier blocks.
        starts = np.concatenate([[0], np.cumsum(validh.astype(np.int64))])[:-1]
        bases = starts[::bpd].astype(np.int64)
        devs = mesh.slot_devices
        arrays = {"X8": X8h, "mult": multh, "lam": lamh, "valid": validh}
        self._shards = {}
        for name, a in arrays.items():
            self._shards[name] = sharded(mesh, [
                torch.from_numpy(np.ascontiguousarray(a[i * bpd:(i + 1) * bpd])).to(devs[i])
                for i in mesh.local_slots], a.shape)
        if stats is not None:
            mn, rng = stats
            lam = self._shards["lam"]
            self._shards["lam"] = sharded(mesh, [score_ops.normalised(t, mn, rng)
                                                 for _, t in lam.local()], lam.shape)
        # Each slot's (first global id, real rows) on the host: the masks
        # take host integers, so a scan reads nothing back.
        self._row_info = sharded(mesh, [torch.tensor(
            [bases[i], int(validh[i * bpd:(i + 1) * bpd].sum())]) for i in mesh.local_slots],
            (d, 2))
        for dev in set(devs[i] for i in mesh.local_slots):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._scan_cache: dict = {}
        # Suffix-only padding per slot (every block full but on the last
        # partial slot): the maxima-first scan's precondition.
        self._suffix_pad = suffix_padded(validh, blk) and all(
            int(bases[i]) == i * bpd * blk for i in range(d))

    @property
    def hbm_bytes_per_device(self) -> int:
        s = self._shards
        tot = (int(np.prod(s["X8"].shape)) + 4 * int(np.prod(s["mult"].shape))
               + 4 * int(np.prod(s["lam"].shape)) + 4 * int(np.prod(s["valid"].shape)))
        return tot // self.mesh.size

    def _args(self):
        s = self._shards
        return s["X8"], s["mult"], s["lam"], s["valid"], self._row_info

    def _scan(self, kk: int, energy: bool = False, maxfirst: bool = False, kfinal: int = 10):
        key = (kk, energy, maxfirst, kfinal if maxfirst else 0)
        fn = self._scan_cache.get(key)
        if fn is None:
            fn = self._scan_cache[key] = make_sharded_sketch_scan(
                self.mesh, kk, energy=energy, maxfirst=maxfirst, kfinal=kfinal)
        return fn

    def _maxfirst_ok(self, b_pad: int, kfinal: int, cand: int) -> bool:
        """Whether a slot's scan takes kernels D and E: the per-slot mirror
        of ``StreamingIndex._sketch_fused_ok``, at the slot's flat rows."""
        if self.sketch_maxfirst is False or not self._suffix_pad:
            return False
        nb, blk, f = self._shards["X8"].shape
        n_l = self.blocks_per_device * blk
        if self.sketch_maxfirst is None and n_l < MAXFIRST_MIN_ROWS:
            return False
        return n_l % so.DEFAULT_TILE == 0 and so.fused_rescored_path(n_l, f, b_pad, kfinal, cand)

    def _candidates(self, Q: torch.Tensor, q_lams: torch.Tensor, k: int,
                    candidates: int | None = None, alpha=0.7):
        """The sharded scan alone: ``(scores [B, C], ids [B, C])`` on the
        lead device (maxima-first per slot where :meth:`_maxfirst_ok`
        holds at the padded batch, else the carry scan)."""
        kk, C = self.index._candidate_width(k, candidates)
        b = Q.shape[0]
        b_pad = max(8, 1 << max(b - 1, 1).bit_length())
        al = score_ops.alpha_param(alpha, b, Q.device)      # a vector's length checked
        if self._maxfirst_ok(b_pad, kk, C):
            return self._scan(C, maxfirst=True, kfinal=kk)(
                *self._args(), Q, q_lams, score_ops.alpha_vector(al, b, Q.device))
        return self._scan(C)(*self._args(), Q, q_lams, al)

    def search_batch(self, queries, k: int, alpha=0.7, candidates: int | None = None,
                     refine: bool = True):
        """As :meth:`StreamingIndex.search_batch_sketch`, the scan sharded
        over the mesh: ``refine=True`` rescores each query's top
        ``candidates`` exactly from disk, ``refine=False`` serves the
        scan's first k. Returns numpy ``(ids [B, kk], scores [B, kk])``."""
        idx = self.index
        Q = idx._queries(queries).to(self.mesh.lead)
        q_lams = idx._query_lambdas(Q)
        kk, _ = self.index._candidate_width(k, candidates)
        best_s, best_i = self._candidates(Q, q_lams, k, candidates, alpha)
        if not refine:
            return best_i[:, :kk].cpu().numpy().astype(np.int64), best_s[:, :kk].cpu().numpy()
        return idx.refine_candidates(best_i.cpu().numpy(), Q, q_lams,
                                     score_ops.alpha_param(alpha, Q.shape[0], Q.device),
                                     float(idx.min_lambdas), float(idx.range_lambdas), kk)

    def search(self, query, k: int, alpha: float = 0.7, candidates: int | None = None,
               refine: bool = True) -> list[tuple[int, float]]:
        ids, sc = self.search_batch(np.asarray(query, np.float32)[None, :], k, alpha,
                                    candidates=candidates, refine=refine)
        return [(int(i), float(s)) for i, s in zip(ids[0], sc[0]) if i >= 0]

    def search_energy_batch(self, queries, k: int, candidates: int | None = None,
                            refine: bool = True):
        """Energy search through the sharded sketch (ascending |Δλ| with the
        cosine tie-break; λ exact), as
        :meth:`StreamingIndex.search_energy_batch_sketch`."""
        idx = self.index
        if idx.sub_centroids is None:
            raise ValueError("not an energy-mode index (no sub-centroid state)")
        Q = idx._queries(queries).to(self.mesh.lead)
        q_lams = idx._query_lambdas(Q)
        kk, C = self.index._candidate_width(k, candidates)
        best_s, best_i = self._scan(C, energy=True)(*self._args(), Q, q_lams, 0.0)
        if not refine:
            return best_i[:, :kk].cpu().numpy().astype(np.int64), -best_s[:, :kk].cpu().numpy()
        return idx.refine_energy_candidates(best_i.cpu().numpy(), Q, q_lams,
                                            float(idx.min_lambdas), float(idx.range_lambdas), kk)

    def search_energy(self, query, k: int, candidates: int | None = None,
                      refine: bool = True) -> list[tuple[int, float]]:
        ids, sc = self.search_energy_batch(np.asarray(query, np.float32)[None, :], k,
                                           candidates=candidates, refine=refine)
        return [(int(i), float(s)) for i, s in zip(ids[0], sc[0]) if i >= 0]
