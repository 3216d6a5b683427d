#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``matternet_rs_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, one output line each (JSON):

1. build — compile the CUDA kernels and the host clustering library from
   this checkout's sources, all at once; name the card.
2. main — the user's main path at the repository's headline size: the
   eigen build of ``make_energy_test_dataset(1_000_000, 128, seed=44)``
   with the benchmark's builder settings, then ``search_batch(k=10,
   alpha=0.7)`` over one untimed warm-up batch and three timed batches of
   256 corpus rows. Checks: each
   query's own row is in its top-10 and its top-1 score is at least its
   own blended score less 1e-5; the ids equal those of the same fused
   search run through the kernels' plain versions on the card, up to the
   near-tie rule (``utils/parity.py``, tolerance 1e-5).
   Then ``torch.profiler`` traces the three timed batches again: wall ms
   per batch (host clock), device-busy ms (the union of the traced
   kernels' intervals), the idle share 1 − busy/wall, and the kernels
   with the most device time.
3. rescored — on the same 1M index, the quantised tiers
   ``bf16x3_rescored``, ``int8_rescored``, ``bf16_rescored``, ``int8``
   with ``approx=True`` and ``auto``, each over the same warm-up batch and
   three timed batches (after the int8 sketch and the bf16 copy are made,
   timed once). Per tier: median ms per batch, recall@10 against phase 2's
   exact ids, launches, and phase 2's profiler pass over the timed
   batches. Checks: every returned score is the exact f32
   blended score of its id (≤ 1e-5), ids are distinct, bf16x3_rescored
   finds each query's own row (or an equal score) and has recall@10 ≥
   0.98, and the maxima-first tiers launched kernels D and E. Kernel route
   against plain route: the same ``fused_scan_rescored`` through the plain
   versions must give the same ids under the same-k rule
   (``utils/parity.same_k_mismatches``, 1e-5) wherever both routes chose
   the same slabs; a row whose slabs differ is allowed only where the
   plain route's c-th and (c+1)-th sub-tile maxima are within 1e-5.
4. wide — a build at N = 40,000, F = 768, so the wide-F λ route (the
   TPU's F-tiled kernel range) runs through the builder.
   Launch counts are set to 0 just before phase 2, each tier of phase 3,
   phase 4, each LOBPCG call of phase 5 and phase 6, and read just after
   each; every kernel of a path must have launched.
5. largef — the large-F sparse path at the reference benchmark's shapes,
   (F, N) = (4096, 20,000) and (16,384, 10,000): normal data from a numpy
   seed, 200 centroids (each the mean of 20 rows), ``GraphParams(eps=1.0,
   k=6, topk=4)``. ``build_laplacian_from_k_cluster`` (dense, then the
   exact ELL extraction, at 4096; the direct ELL build at 16,384, which
   must be ELL-backed and drop no reverse edge), ``compute_taumode``
   (sparse λ, all finite), ``search_batch`` of 256 corpus rows (flat
   route; every query finds its own row), ``lobpcg_smallest(gl.ell(), 5,
   iters=40)`` through kernel F (41 launches per call; eigenvalues
   ascending and ≥ −1e-4, residuals ‖Lv − θv‖ ≤ 0.05; at F = 4096 within
   1e-3 of the same solve on the dense matrix). ``L@1 ≈ 0`` through kernel
   F; at F = 4096 λ of 512 rows within 1e-5 of the dense closed form.
   Prints stage seconds, the ELL's width and bytes, and LOBPCG's time
   beside what its kernel F, ``qr`` and ``eigh`` calls cost on their own.
6. streamed — on phase 2's index, ``search_fused`` (kernel G: no [B, N]
   scores) over row-normalised data and the same batches, against the
   exact tier's ids under the near-tie rule (1e-5); ids distinct, scores
   descending; ms per batch beside the exact tier's.
7. kernels — each kernel against its plain PyTorch version on the inputs
   the main path gave it (λ: |Δ| ≤ 1e-5·max(1, |λ|); scores and maxima:
   ≤ 1e-5 abs; gather: bit for bit; slab dots: ≤ 1e-5·‖q‖·‖x‖; the ELL
   product: bit for bit, also on every block LOBPCG applies in one more
   solve on the large graph; the streamed top-k's lists: scores ≤ 1e-5,
   the merge bit for bit), timed
   with CUDA events over cold-L2 launches beside its plain version, the
   one PyTorch call that computes the same thing where there is one, and
   the card's least time for the work: the larger of bytes over 3.35 TB/s
   and operations over the peak of their type (f32 FFMA 67 TFLOP/s, bf16
   tensor cores 989 TFLOP/s; H100 SXM data sheet). Kernel D's ``ms`` times
   its wrapper, a dozen small PyTorch calls included (the per-row and
   per-query terms, the bf16 queries); ``launch_ms`` times the kernel's
   launch alone on the same operands, which is what ``library_ms`` (one
   ``torch.matmul``) compares with. For kernels B and D the phase's own
   line (not the ``kernels`` line) carries the launch plan (loader, queries
   per block, dynamic shared memory), which the Python mirror and the built
   library must report alike, and, when this process ran the build, the
   compiler's registers, static shared memory and spills.
   Kernels B and D are then held against their plain versions at edge
   shapes (≤ 1e-5): 3 and 300 queries, F = 100 and 768, sub-tiles of 128
   and 256 rows, ``mask_from`` inside a sub-tile, a corpus whose address is
   not a multiple of 16 bytes (the element-wise loaders).
   Kernel A runs in 3xTF32 on the tensor cores: its rows also carry the
   gap to its 3xTF32 mirror (≤ 1e-6·max(1, |λ|)), ``bound_ms`` for
   3·14·N·F² flops at 495 TFLOP/s (TF32) and ``bound_ffma_ms`` (14·N·F² at
   67); its launch plan (loader, splits, grid, shared memory) and ptxas
   report go to the phase's line. It is held at every F in {1, 3, 24, 127,
   128, 130, 768, 2047, 2048} with every N in {1, 63, 64, 65, 1000}, and an
   offset view of X, a zero row and a 1e-11 row giving exactly 0: against
   the float64 closed form within 1e-5·max(1, |λ|) plus the row's rounding
   bound for products of relative error 2^-20 (``taumode_rounding_bound``;
   at F = 3 rows with nearly equal features make the expanded sums cancel,
   and the float32 closed form itself misses the exact value by more than
   1e-5), and against the mirror within 1e-6·max(1, |λ|) plus twice that
   bound; the strict gaps to the float32 version and the mirror are printed
   beside. Kernel A's and the merge's ``launch_ms`` time the kernel alone on
   operands the wrapper prepared once. The merge's row carries
   ``launch_floor_ms``, an empty kernel of the same library timed the same
   way; it is held bit for bit at k in {1, 10, 16}, 16, 48, 2,112 and 4,112
   candidates, 1, 7 and 256 queries, on shuffled lists, all-equal scores,
   ±0.0 and −inf fills. The rows of kernels E and F carry ``launch_ms``
   (the kernel alone) and ``launch_floor_ms`` (the same empty kernel).
   Their launch plans (held equal to the library's) and ptxas reports go to the phase's
   line. Kernel F is held bit for bit at every n in {1, 31, 16384} with
   every k in {1, 14, 40} and m in {1, 15, 16, 17, 256}, both forms, with
   rows of empty slots only, empty slots at −1 or naming a row of inf that
   no live slot names. Kernel E is held at every F
   in {1, 3, 100, 128, 768, 2048} with ts in {128, 256}, c in {1, 14}, B in
   {1, 7, 256}, f32 and int8 rows, X aligned and 4 bytes off; ids out of
   range give exactly their NaN slices.

Then the ``kernels`` line, the card's name and power limit
(``nvidia-smi``), and last ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero. Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

N_MAIN, F_MAIN, SEED_MAIN = 1_000_000, 128, 44
N_WIDE, F_WIDE, SEED_WIDE = 40_000, 768, 45
BATCH, K, ALPHA, N_BATCHES = 256, 10, 0.7, 3
TOL_LAMBDA, TOL_SCORE = 1e-5, 1e-5
# The quantised tiers of phase 3: (tier, extra search_batch arguments).
TIERS = (
    ("bf16x3_rescored", {}),
    ("int8_rescored", {}),
    ("bf16_rescored", {"allow_low_recall": True}),
    ("int8", {"approx": True}),
    ("auto", {}),
)
MIN_RECALL_BF16X3 = 0.98
# Phase largef: (F, N) of the reference benchmark's large-F rows.
LARGEF_SHAPES = ((4096, 20_000), (16_384, 10_000))
LARGEF_CENTROIDS, LARGEF_ROWS_PER_CENTROID, LARGEF_SEED = 200, 20, 3
LOBPCG_K, LOBPCG_ITERS = 5, 40
TOL_EIG_NEG, TOL_EIG_DENSE, TOL_RESIDUAL, TOL_ROWSUM = 1e-4, 1e-3, 0.05, 1e-4

# H100 SXM data sheet (dense): HBM3 3.35 TB/s, f32 FFMA 67 TFLOP/s, bf16
# tensor cores 989 TFLOP/s, TF32 tensor cores 495 TFLOP/s.
PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_BF16_FLOP_S = 3.35e12, 67e12, 989e12
PEAK_TF32_FLOP_S = 495e12
TOL_LAMBDA_MIRROR = 1e-6      # kernel A against its 3xTF32 mirror, × max(|λ|, 1)
EPS_3XTF32 = 2.0 ** -20       # relative error of a 3xTF32 product, for the λ rounding bound
TOP_KERNELS = 10
# Edge shapes of phase kernels: (queries, F, sub-tiles per 2048-row tile).
EDGE_N, EDGE_MASK_FROM = 4500, 3000
# Kernel A's edge shapes: every F with every N, and an offset view of X.
EDGE_F_A = (1, 3, 24, 127, 128, 130, 768, 2047, 2048)
EDGE_N_A = (1, 63, 64, 65, 1000)
# The merge's edge cases: k, candidates per query, queries, list contents.
EDGE_K_G, EDGE_CAND_G, EDGE_B_G = (1, 10, 16), (16, 48, 2112, 4112), (1, 7, 256)
EDGE_KINDS_G = ("shuffled", "ties", "zeros", "fills")
EDGE_SHAPES_D = ((3, 100, 16), (300, 100, 8), (3, 768, 8), (300, 768, 16))
EDGE_SHAPES_B = ((3, 100), (3, 768), (300, 768))
# Kernel F's edge cases: every n with every k and m, both forms.
EDGE_N_F, EDGE_K_F, EDGE_M_F = (1, 31, 16_384), (1, 14, 40), (1, 15, 16, 17, 256)
# Kernel E's edge cases: every F, ts, c and B, both row types, X aligned and
# 4 bytes off; EDGE_SLABS_E slabs of corpus.
EDGE_F_E, EDGE_TS_E, EDGE_C_E, EDGE_B_E, EDGE_SLABS_E = (
    (1, 3, 100, 128, 768, 2048), (128, 256), (1, 14), (1, 7, 256), 40)
PLAIN_GATHER_BYTES = 1 << 28  # kernel E's plain version gathers at most this much at once


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, its maximum, temperature and power draw now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / peak_flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_resources(log: str | None, entry: str) -> dict | None:
    """Registers, static shared memory and spill bytes that ``ptxas -v``
    reported for the kernel whose mangled name contains ``entry``; None
    without a log (the library was found built) or without the kernel."""
    lines = (log or "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            res = {}
            for follow in lines[i + 1:i + 4]:
                for key, pat in (("registers", r"Used (\d+) registers"), ("smem_static", r"(\d+) bytes smem"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    m = re.search(pat, follow)
                    if m:
                        res[key] = int(m.group(1))
            return res
    return None


def busy_ms(events, device_type) -> float:
    """Length of the union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == device_type)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3                       # µs → ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import logging

    from matternet_rs_tpu_torch import ArrowSpace, ArrowSpaceBuilder, GraphParams, buildcache, core, native
    from matternet_rs_tpu_torch.ops import eigensolver as eig
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import laplacian as lap
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops import taumode as tmo
    from matternet_rs_tpu_torch.ops.kernels import _cuda
    from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
    from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk
    from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
    from matternet_rs_tpu_torch.ops.kernels import taumode as tk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
    from matternet_rs_tpu_torch.utils.parity import same_k_mismatches, topk_mismatches

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    if "H100" not in name or "PCIe" in name:
        print(f"chip_smoke: bounds assume the H100 SXM's peaks, card is {name}",
              file=sys.stderr)

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    specs = _cuda.specs() + ([native.spec()] if native.spec() else [])
    buildcache.build(specs)
    _cuda.build_all()
    check(native.get_lib() is not None, "native clustering library did not load")
    ptxas = [
        line.strip() for log in buildcache.BUILD_LOG.values()
        for line in log.splitlines() if "registers" in line or "spill" in line
    ]
    emit(phase="build", seconds=time.perf_counter() - t0, card=card, ptxas=ptxas)

    def make_builder(n):
        return (
            ArrowSpaceBuilder()
            .with_lambda_graph(1.0, 6)
            .with_sparsity_check(False)
            .with_cluster_params(max_clusters=max(64, int(2 * n**0.5) // 8), radius=25.0)
            .with_sampling(None)
        )

    # -- 2. main path --------------------------------------------------
    X = make_energy_test_dataset(N_MAIN, F_MAIN, seed=SEED_MAIN).astype(np.float32)
    # Batch 0 warms the search up (one-time set-up); batches 1.. are timed.
    rows = np.random.default_rng(7).choice(N_MAIN, BATCH * (N_BATCHES + 1), replace=False)
    batches = rows.reshape(N_BATCHES + 1, BATCH)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    builder = make_builder(N_MAIN)
    aspace, gl = builder.build(X)
    build_s = time.perf_counter() - t0
    results, batch_ms = [], []
    for r in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx, sc, raw = aspace.search_batch(X[r], gl, k=K, alpha=ALPHA, return_raw=True)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
        results.append((r, idx, sc, raw))
    main_counts = kernels.launch_counts()
    check(np.all(np.isfinite(aspace.lambdas.cpu().numpy())), "non-finite λ")

    Xt, norms, lams = aspace.data, aspace.norms, aspace.lambdas
    mn = torch.tensor(aspace.min_lambdas, device=dev)
    rng_ = torch.tensor(aspace.range_lambdas, device=dev)
    alphas = torch.full((BATCH,), ALPHA, dtype=torch.float32, device=dev)

    def queries_of(r, raw):
        """The batch's queries and normalised λ, as search_batch forms them."""
        rt = torch.from_numpy(r).to(dev)
        return rt, Xt[rt], torch.clamp((torch.from_numpy(raw).to(dev) - mn) / rng_, 0.0, 1.0)

    def exact_scores(Q, ql, ids):
        """f32 blended scores of rows ``ids [B, k]`` for each query."""
        dots = torch.sum(Xt[ids] * Q[:, None, :], dim=-1)
        qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
        return tmk.blend(dots, norms[ids] * qn[:, None], lams[ids], ql[:, None], ALPHA)

    plain_mismatch, self_fail = [], []
    for r, idx, sc, raw in results:
        check(idx.shape == (BATCH, K) and np.all(np.isfinite(sc)), "bad search output")
        rt, Q, ql = queries_of(r, raw)
        # Each query's blended score against its own row.
        own = exact_scores(Q, ql, rt[:, None])[:, 0].cpu().numpy()
        for b in range(BATCH):
            if r[b] not in idx[b] or sc[b, 0] < own[b] - TOL_SCORE:
                self_fail.append(int(r[b]))
        top_p, idx_p = so.fused_tilemax(
            Xt, norms, lams, Q, ql, K + 1, alphas, so.DEFAULT_TILE,
            producer=tmk.scores_and_tilemax_plain, gather=tmk.gather_subtiles_plain,
        )
        plain_mismatch += topk_mismatches(
            idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, TOL_SCORE
        )
    emit(phase="main", n=N_MAIN, f=F_MAIN, batch=BATCH, k=K, card=card,
         build_seconds=build_s, stage_seconds=builder.last_stage_timings,
         n_clusters=aspace.n_clusters, warmup_ms=batch_ms[0],
         search_ms_per_batch_median=statistics.median(batch_ms[1:]),
         search_ms_per_batch=batch_ms[1:], launches=main_counts,
         self_query_failures=self_fail[:10], plain_route_mismatches=plain_mismatch[:10])
    check(not self_fail, f"{len(self_fail)} queries miss their own row")
    check(not plain_mismatch, f"kernel vs plain route: {plain_mismatch[:3]}")
    for kname in ("taumode", "scores_tilemax", "gather_subtiles"):
        check(main_counts[kname] > 0, f"kernel {kname} not launched on the main path")

    def traced(search):
        """Run ``search(r)`` over the timed batches under ``torch.profiler``:
        wall ms per batch (host clock), device-busy ms per batch (the union
        of the traced kernels' intervals), idle share, top kernels."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in batches[1:]:
                search(r)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
        dev_busy = busy_ms(prof.events(), DeviceType.CUDA) / N_BATCHES

        def dev_ms(a):
            return getattr(a, "self_device_time_total", None) or getattr(a, "self_cuda_time_total", 0)

        kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
        top = sorted(kern, key=dev_ms, reverse=True)[:TOP_KERNELS]
        return dict(batches=N_BATCHES, wall_ms_per_batch=wall_ms,
                    device_busy_ms_per_batch=dev_busy,
                    idle_share=1.0 - dev_busy / wall_ms if wall_ms > 0 else None,
                    top_kernels=[{"name": a.key[:80], "calls_per_batch": a.count / N_BATCHES,
                                  "device_ms_per_batch": dev_ms(a) / 1e3 / N_BATCHES}
                                 for a in top if dev_ms(a) > 0])

    emit(phase="profile", card=card,
         **traced(lambda r: aspace.search_batch(X[r], gl, k=K, alpha=ALPHA)))

    # -- 3. rescored tiers --------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aspace.enable_int8_scan()
    torch.cuda.synchronize()
    int8_sketch_s = time.perf_counter() - t0
    aspace.enable_quantized_scan()
    torch.cuda.synchronize()
    bf16_copy_s = time.perf_counter() - t0 - int8_sketch_s
    X8, mult = aspace._ensure_int8()
    Xb = aspace._scan_corpus(True)
    scan_of ={"bf16x3_rescored": (Xt, None), "int8_rescored": (X8, mult),
               "bf16_rescored": (Xb, None)}
    cand = aspace._int8_cand(K, None)
    ts_r = so.DEFAULT_TILE // so.RESCORE_SUBS
    ns_r = (N_MAIN // so.DEFAULT_TILE) * so.RESCORE_SUBS
    c_r = min(ns_r, max(K + so.SELECT_MARGIN, -(-cand // ts_r)))
    tier_counts = {}
    for tier, kw in TIERS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs, ms = [], []
        for r in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            idx, sc, raw = aspace.search_batch(X[r], gl, k=K, alpha=ALPHA, quantized=tier,
                                               return_raw=True, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            outs.append((r, idx, sc, raw))
        counts = tier_counts[tier] = kernels.launch_counts()
        score_err, dup_rows, self_found, hits = 0.0, 0, 0, 0
        plain_bad, sel_differs, sel_unexplained = [], 0, []
        for (r, idx, sc, raw), (_, eidx, _, _) in zip(outs, results):
            check(idx.shape == (BATCH, K) and np.all(np.isfinite(sc)), f"{tier}: bad output")
            rt, Q, ql = queries_of(r, raw)
            ids = torch.from_numpy(idx).to(dev)
            ex = exact_scores(Q, ql, ids)
            score_err = max(score_err, float((torch.from_numpy(sc).to(dev) - ex).abs().max()))
            own = exact_scores(Q, ql, rt[:, None])[:, 0].cpu().numpy()
            for b in range(BATCH):
                dup_rows += len(set(idx[b].tolist())) != K
                self_found += bool(r[b] in idx[b] or np.any(np.abs(sc[b] - own[b]) <= TOL_SCORE))
                hits += len(set(idx[b].tolist()) & set(eidx[b].tolist()))
            if tier not in scan_of:
                continue
            Xs, rn = scan_of[tier]
            a = torch.full((BATCH,), ALPHA, dtype=torch.float32, device=dev)
            pidx, ptop = so.fused_scan_rescored(
                Xs, Xt, norms, lams, Q, ql, K, cand, a, scan_rn=rn,
                producer=rsk.tilemax_only_plain, slab_reader=rsk.slab_dots_plain,
            )
            mk = rsk.tilemax_only(Xs, norms, lams, Q, ql, a, subs=so.RESCORE_SUBS, rn=rn)
            mp = rsk.tilemax_only_plain(Xs, norms, lams, Q, ql, a, subs=so.RESCORE_SUBS, rn=rn)
            sel_k = torch.sort(so.topk_stable(mk, c_r)[1], dim=1).values
            top_p, sel_p = so.topk_stable(mp, c_r + 1)
            sel_p = torch.sort(sel_p[:, :c_r], dim=1).values
            same = torch.all(sel_k == sel_p, dim=1).cpu().numpy()
            gap = (top_p[:, c_r - 1] - top_p[:, c_r]).abs().cpu().numpy()
            sel_differs += int((~same).sum())
            sel_unexplained += [int(r[b]) for b in np.nonzero(~same & (gap > TOL_SCORE))[0]]
            plain_bad += same_k_mismatches(pidx.cpu().numpy()[same], ptop.cpu().numpy()[same],
                                           idx[same], sc[same], TOL_SCORE)
        recall = hits / (K * BATCH * len(outs))
        profile_ = traced(lambda r: aspace.search_batch(X[r], gl, k=K, alpha=ALPHA,
                                                        quantized=tier, **kw))
        emit(phase="rescored", tier=tier, args=kw, card=card, warmup_ms=ms[0],
             search_ms_per_batch_median=statistics.median(ms[1:]), search_ms_per_batch=ms[1:],
             recall_at_10=recall, launches=counts, max_score_err=score_err,
             self_found=self_found, queries=BATCH * len(outs),
             slab_selection_differs_rows=sel_differs, plain_route_mismatches=plain_bad[:5],
             int8_sketch_seconds=int8_sketch_s, bf16_copy_seconds=bf16_copy_s,
             profile=profile_)
        check(score_err <= TOL_SCORE, f"{tier}: returned scores off the exact ones by {score_err}")
        check(dup_rows == 0, f"{tier}: {dup_rows} rows repeat an id")
        check(not plain_bad, f"{tier}: kernel vs plain route: {plain_bad[:3]}")
        check(not sel_unexplained, f"{tier}: slab selection differs without a near tie: {sel_unexplained[:5]}")
        if tier in scan_of:
            for kname in ("tilemax_only", "slab_dots"):
                check(counts[kname] > 0, f"kernel {kname} not launched on tier {tier}")
        if tier == "bf16x3_rescored":
            check(self_found == BATCH * len(outs), f"{tier}: {BATCH * len(outs) - self_found} queries miss their own row")
            check(recall >= MIN_RECALL_BF16X3, f"{tier}: recall@10 {recall} < {MIN_RECALL_BF16X3}")

    # -- 4. wide-F build -----------------------------------------------
    Xw = make_energy_test_dataset(N_WIDE, F_WIDE, seed=SEED_WIDE).astype(np.float32)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wbuilder = make_builder(N_WIDE)
    waspace, wgl = wbuilder.build(Xw)
    wide_s = time.perf_counter() - t0
    wide_counts = kernels.launch_counts()
    emit(phase="wide", n=N_WIDE, f=F_WIDE, card=card, build_seconds=wide_s,
         stage_seconds=wbuilder.last_stage_timings, launches=wide_counts)
    check(wide_counts["taumode"] > 0, "kernel taumode not launched on the wide build")
    check(np.all(np.isfinite(waspace.lambdas.cpu().numpy())), "non-finite wide λ")

    # -- 5. the large-F sparse path ------------------------------------
    def host_ms(fn, reps=5):
        """Median host-clock ms of ``fn`` with the device drained."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    lap_log = logging.getLogger(lap.__name__)
    largef_counts, ell_big, rng_lf = {}, None, np.random.default_rng(LARGEF_SEED)
    for F, N in LARGEF_SHAPES:
        Xl = rng_lf.normal(size=(N, F)).astype(np.float32)
        cents = np.stack([Xl[rng_lf.choice(N, LARGEF_ROWS_PER_CENTROID, replace=False)].mean(0)
                          for _ in range(LARGEF_CENTROIDS)])
        params = GraphParams(eps=1.0, k=6, topk=4, sparsity_check=False)
        records, level = Records(), lap_log.level
        lap_log.addHandler(records)
        lap_log.setLevel(logging.INFO)
        stage = {}

        def staged(key, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stage[key] = time.perf_counter() - t
            return out

        try:
            kernels.reset_launches()
            lgl = staged("graph", lambda: lap.build_laplacian_from_k_cluster(
                torch.from_numpy(cents).to(dev), params, n_items=N))
        finally:
            lap_log.removeHandler(records)
            lap_log.setLevel(level)
        ell = staged("ell_extraction", lambda: lgl.ell().check())
        dropped = [m for m in records.messages if "dropped" in m]
        laspace = staged("upload", lambda: ArrowSpace.from_items(Xl))
        staged("lambda", lambda: laspace.compute_taumode(lgl))
        lam_finite = bool(torch.all(torch.isfinite(laspace.lambdas)))
        rows_l = rng_lf.choice(N, BATCH * (N_BATCHES + 1), replace=False).reshape(-1, BATCH)
        lf_ms, missed = [], 0
        for r in rows_l:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            idx, sc = laspace.search_batch(Xl[r], lgl, k=K, alpha=ALPHA)
            torch.cuda.synchronize()
            lf_ms.append((time.perf_counter() - t1) * 1e3)
            missed += sum(int(r[b] not in idx[b]) for b in range(BATCH))
        ones = torch.ones(F, device=dev)
        rowsum = float(ell.matvec(ones).abs().max())
        if lgl.is_ell_backed:                  # the graph's own product takes the same route
            rowsum = max(rowsum, float(lgl.multiply_vector(ones).abs().max()))
        path_counts = kernels.launch_counts()

        # The first solve also pays the process's first cuSOLVER calls; the
        # second is the one timed. Each must launch kernel F iters + 1 times.
        lobpcg_launches = []
        for solve in ("lobpcg_first_call", "lobpcg"):
            kernels.reset_launches()
            vals, vecs = staged(solve, lambda: eig.lobpcg_smallest(ell, LOBPCG_K, iters=LOBPCG_ITERS))
            lobpcg_launches.append(kernels.launch_counts()["spmv_ell"])
        Vt, th = torch.from_numpy(vecs).to(dev), torch.from_numpy(vals).to(dev)
        resid = torch.linalg.norm(ell.matvec(Vt) - Vt * th[None, :], dim=0).cpu().tolist()
        S = torch.randn((F, 3 * LOBPCG_K), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(F))
        G15 = S.T @ S
        split = dict(
            spmv_ell_ms=host_ms(lambda: ell.matvec(S)) * (LOBPCG_ITERS + 1),
            qr_ms=host_ms(lambda: torch.linalg.qr(S[:, :LOBPCG_K])) * (LOBPCG_ITERS + 1),
            eigh_ms=host_ms(lambda: torch.linalg.eigh(G15)) * 2 * LOBPCG_ITERS,
        )
        split["rest_ms"] = stage["lobpcg"] * 1e3 - sum(split.values())
        dense_gap = lam_gap = None
        if not lgl.is_ell_backed:
            dvals, _ = eig.lobpcg_smallest(lgl.matrix, LOBPCG_K, iters=LOBPCG_ITERS)
            dense_gap = float(np.abs(dvals - vals).max())
            sub = laspace.data[:512]
            lam_gap = float((tmo.taumode_lambdas_ell(sub, ell) - tmo.taumode_lambdas(sub, lgl.matrix))
                            .abs().max())
        else:
            ell_big = ell
        largef_counts[F] = dict(path=path_counts["spmv_ell"], lobpcg=sum(lobpcg_launches))
        emit(phase="largef", f=F, n=N, card=card, ell_backed=lgl.is_ell_backed,
             ell_k=ell.max_degree, ell_bytes=ell.nbytes(), stage_seconds=stage,
             search_ms_per_batch_median=statistics.median(lf_ms[1:]), search_ms_per_batch=lf_ms[1:],
             search_warmup_ms=lf_ms[0], self_query_failures=missed, lambda_finite=lam_finite,
             laplacian_rowsum_max=rowsum, degree_max=float(ell.diag.max()),
             lobpcg=dict(k=LOBPCG_K, iters=LOBPCG_ITERS, eigenvalues=vals.tolist(), residuals=resid,
                         spmv_ell_launches=lobpcg_launches, vs_dense_operator=dense_gap,
                         seconds=stage["lobpcg"], parts_timed_alone_ms=split),
             lambda_vs_dense_512_rows=lam_gap, launches=path_counts,
             build_log=records.messages, dropped_edge_warnings=dropped)
        check(lam_finite, f"largef F={F}: non-finite λ")
        check(missed == 0, f"largef F={F}: {missed} queries miss their own row")
        check(lgl.is_ell_backed == (F >= lap.DIRECT_ELL_N), f"largef F={F}: wrong graph backing")
        check(not dropped, f"largef F={F}: reverse edges dropped under rk=auto: {dropped}")
        check(rowsum <= TOL_ROWSUM * max(1.0, float(ell.diag.max())), f"largef F={F}: L@1 = {rowsum}")
        check(path_counts["spmv_ell"] == 1 + int(lgl.is_ell_backed),
              f"largef F={F}: L@1 launched kernel F {path_counts['spmv_ell']} times")
        check(lobpcg_launches == [LOBPCG_ITERS + 1] * 2,
              f"largef F={F}: kernel F launched {lobpcg_launches} times per LOBPCG call, not {LOBPCG_ITERS + 1}")
        check(bool(np.all(np.diff(vals) >= -1e-6)) and float(vals.min()) >= -TOL_EIG_NEG,
              f"largef F={F}: eigenvalues {vals.tolist()}")
        check(max(resid) <= TOL_RESIDUAL, f"largef F={F}: residuals {resid}")
        if dense_gap is not None:
            check(dense_gap <= TOL_EIG_DENSE, f"largef F={F}: ELL vs dense operator {dense_gap}")
            check(lam_gap <= TOL_LAMBDA, f"largef F={F}: sparse vs dense λ {lam_gap}")
        del Xl, laspace, lgl

    # -- 6. streamed exact top-k (kernel G) ------------------------------
    Xn = Xt / torch.clamp(norms, min=1e-12)[:, None]
    exact_k1 = [aspace.search_batch(X[r], gl, k=K + 1, alpha=ALPHA) for r, _, _, _ in results]
    kernels.reset_launches()
    st_ms, st_bad, st_dups, st_unsorted = [], [], 0, 0
    for (r, _, _, raw), (eidx, esc) in zip(results, exact_k1):
        rt, _, ql = queries_of(r, raw)
        Qn = Xn[rt].contiguous()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fidx, fsc = sfk.search_fused(Xn, lams, Qn, ql, K, ALPHA)
        fidx, fsc = fidx.cpu().numpy(), fsc.cpu().numpy()
        st_ms.append((time.perf_counter() - t1) * 1e3)
        st_bad += topk_mismatches(eidx, esc, fidx, fsc, TOL_SCORE)
        st_dups += sum(len(set(row.tolist())) != K for row in fidx)
        st_unsorted += int(np.any(np.diff(fsc, axis=1) > 0))
    st_counts = kernels.launch_counts()
    emit(phase="streamed", n=N_MAIN, f=F_MAIN, batch=BATCH, k=K, card=card,
         splits=sfk.default_splits(N_MAIN, BATCH, dev), warmup_ms=st_ms[0],
         search_ms_per_batch_median=statistics.median(st_ms[1:]), search_ms_per_batch=st_ms[1:],
         exact_tier_ms_per_batch_median=statistics.median(batch_ms[1:]),
         launches=st_counts, mismatches_vs_exact_tier=st_bad[:10])
    check(not st_bad, f"streamed: ids depart from the exact tier's: {st_bad[:3]}")
    check(st_dups == 0 and st_unsorted == 0, "streamed: repeated ids or unsorted scores")
    for kname in ("search_fused", "search_fused_merge"):
        check(st_counts[kname] == len(results), f"kernel {kname} launched {st_counts[kname]} times")

    # -- 7. kernels against their plain versions -----------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2

    def cuda_ms(fn, reps=5):
        """Median ms of ``fn`` over cold-L2 launches."""
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def bit_equal(a, b):
        """Same shape and the same float32 bits (NaN, inf and ±0 included)."""
        return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    rows_out = []
    resources = {}        # kernels A, B, D, E, F: launch plan and compiler report, by row name

    def record_resources(label, lib_name, entry, plan, chosen):
        """Hold the Python mirror of a launch plan against what the built
        library reports, and keep it with the compiler's report (of a build
        this process ran) for the phase's line."""
        check(plan == chosen, f"{label}: plan {plan} is not what the library chooses: {chosen}")
        log = buildcache.BUILD_LOG.get(lib_name)
        resources[label] = dict(plan=plan, ptxas=ptxas_resources(log, entry))
        check(log is None or resources[label]["ptxas"] is not None,
              f"{label}: no ptxas report for {entry} in the build log")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def lam_gaps(Xk, L, tau):
        """Kernel A's λ and its largest gaps, relative to max(|λ|, 1), to the
        full-f32 plain version and to the 3xTF32 mirror."""
        got = tk.taumode_lambdas_fused(Xk, L, tau)
        ref = tk.taumode_lambdas_plain(Xk, L, tau)
        mirror = tk.taumode_lambdas_3xtf32_plain(Xk, L, tau)
        return (got, float(((got - ref).abs() / torch.clamp(ref.abs(), min=1.0)).max()),
                float(((got - mirror).abs() / torch.clamp(mirror.abs(), min=1.0)).max()),
                float((got - ref).abs().max()))

    def lam_row(label, replaces, Xk, L, launches):
        n, f = Xk.shape
        tau = tmo.select_tau(Xk, tmo.TAU_MEDIAN)
        _, rel, rel_mirror, err = lam_gaps(Xk, L, tau)
        nbytes = 4 * (n * f + f * f + 2 * f + 2 * n)
        bms, by = bound(nbytes, 3 * 14 * n * f * f, PEAK_TF32_FLOP_S)
        state = card_state()
        ops = tk._operands(Xk, L, tau)          # the wrapper's checks and operand preparation, made once
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/taumode.cu",
            replaces=replaces, launches=launches, max_abs_err=err,
            ms=cuda_ms(lambda: tk.taumode_lambdas_fused(Xk, L, tau)),
            launch_ms=cuda_ms(lambda: tk._launch(*ops)),
            plain_ms=cuda_ms(lambda: tk.taumode_lambdas_plain(Xk, L, tau), reps=3),
            bound_ms=bms, bound_by=by, library_ms=None,
            bound_ffma_ms=bound(nbytes, 14 * n * f * f)[0],
            max_rel_err=rel, max_rel_err_vs_3xtf32_mirror=rel_mirror,
            shape=f"N={n} F={f}", arithmetic="3xTF32 (bound: 3·14·N·F² at 495 TFLOP/s)",
            card_state_before=state,
        ))
        check(rel <= TOL_LAMBDA, f"{label}: kernel vs plain λ beyond tolerance ({rel})")
        check(rel_mirror <= TOL_LAMBDA_MIRROR, f"{label}: kernel vs its 3xTF32 mirror {rel_mirror}")
        record_resources(label, "taumode", "taumode_lambda_kernelILb1E",
                         tk.taumode_plan(n, f, Xk.data_ptr() % 16 == 0, sms), tk.taumode_plan_chosen(Xk))

    lam_row("taumode_lambda", "matternet_rs_tpu/ops/pallas/taumode_fused.py:79",
            Xt, gl.matrix.contiguous(), main_counts["taumode"])
    lam_row("taumode_lambda_wide_f", "matternet_rs_tpu/ops/pallas/taumode_fused.py:231",
            waspace.data, wgl.matrix.contiguous(), wide_counts["taumode"])

    r1, raw1 = results[1][0], results[1][3]
    Q = Xt[torch.from_numpy(r1).to(dev)].contiguous()
    ql = torch.clamp((torch.from_numpy(raw1).to(dev) - mn) / rng_, 0.0, 1.0)
    tile = so.DEFAULT_TILE
    n0 = (N_MAIN // tile) * tile
    s_k, m_k = tmk.scores_and_tilemax(Xt, norms, lams, Q, ql, alphas, tile=tile)
    s_p, m_p = tmk.scores_and_tilemax_plain(Xt, norms, lams, Q, ql, alphas, tile=tile)
    err_b = max(float((s_k - s_p).abs().max()), float((m_k - m_p).abs().max()))
    ns = m_k.shape[1]
    bms, by = bound(
        4 * (n0 * F_MAIN + BATCH * F_MAIN + 2 * n0 + 3 * BATCH + BATCH * n0 + BATCH * ns),
        2 * BATCH * n0 * F_MAIN,
    )
    Xn0 = Xt[:n0]
    rows_out.append(dict(
        name="scores_tilemax", route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
        replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:492",
        launches=main_counts["scores_tilemax"], max_abs_err=err_b,
        ms=cuda_ms(lambda: tmk.scores_and_tilemax(Xt, norms, lams, Q, ql, alphas, tile=tile)),
        plain_ms=cuda_ms(lambda: tmk.scores_and_tilemax_plain(Xt, norms, lams, Q, ql, alphas, tile=tile), reps=3),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.matmul(Q, Xn0.T)),
        shape=f"B={BATCH} N={N_MAIN} F={F_MAIN}",
    ))
    check(err_b <= TOL_SCORE, f"scores_tilemax: kernel vs plain {err_b}")
    record_resources("scores_tilemax", "tilemax", "scores_tilemax_kernel",
                     tmk.scores_tilemax_plan(BATCH, F_MAIN), tmk.scores_tilemax_plan_chosen(Xt, Q))

    c = min(ns, K + so.SELECT_MARGIN)
    ts = tile // tmk.SUBS
    sel = torch.sort(so.topk_stable(m_k, c)[1], dim=1).values
    g_k = tmk.gather_subtiles(s_k, sel, ts)
    g_p = tmk.gather_subtiles_plain(s_k, sel, ts)
    err_c = float((g_k - g_p).abs().max())
    gidx = sel[:, :, None].expand(BATCH, c, ts)
    s3 = s_k.view(BATCH, ns, ts)
    bms, by = bound(2 * 4 * BATCH * c * ts + 8 * BATCH * c, 0)
    rows_out.append(dict(
        name="gather_subtiles", route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
        replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:622",
        launches=main_counts["gather_subtiles"], max_abs_err=err_c,
        ms=cuda_ms(lambda: tmk.gather_subtiles(s_k, sel, ts), reps=20),
        plain_ms=cuda_ms(lambda: tmk.gather_subtiles_plain(s_k, sel, ts), reps=20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.gather(s3, 1, gidx), reps=20),
        shape=f"B={BATCH} c={c} ts={ts}",
    ))
    check(bool(torch.equal(g_k, g_p)), f"gather_subtiles: kernel vs plain {err_c}")
    del s_k, s_p, g_k, g_p, s3

    # Kernel D in its three modes, on the tiers' own inputs; the bf16x3 and
    # int8 maxima also give kernel E's slab selections.
    ns_r = (N_MAIN // tile) * so.RESCORE_SUBS
    Qb = Q.to(torch.bfloat16)
    sels = {}
    for label, tier, Xs, rn, passes, library in (
        ("tilemax_only_bf16", "bf16_rescored", Xb, None, 1, lambda: torch.matmul(Qb, Xb[:n0].T)),
        ("tilemax_only_int8", "int8_rescored", X8, mult, 1, lambda: torch.matmul(Qb, Xb[:n0].T)),
        ("tilemax_only_bf16x3", "bf16x3_rescored", Xt, None, 3, lambda: torch.matmul(Q, Xn0.T)),
    ):
        def run_d(fn, Xs=Xs, rn=rn):
            return fn(Xs, norms, lams, Q, ql, alphas, tile=tile, subs=so.RESCORE_SUBS, rn=rn)

        md, mp = run_d(rsk.tilemax_only), run_d(rsk.tilemax_only_plain)
        ops_d = run_d(rsk._tilemax_only_operands)  # the wrapper's own small PyTorch calls, made once
        err_d = float((md - mp).abs().max())
        sels[tier] = torch.sort(so.topk_stable(md, c_r)[1], dim=1).values
        bms, by = bound(n0 * F_MAIN * Xs.element_size() + 8 * n0 + 4 * BATCH * F_MAIN
                        + 4 * BATCH * ns_r, passes * 2 * BATCH * n0 * F_MAIN, PEAK_BF16_FLOP_S)
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:243",
            launches=tier_counts[tier]["tilemax_only"], max_abs_err=err_d,
            ms=cuda_ms(lambda: run_d(rsk.tilemax_only)),
            launch_ms=cuda_ms(lambda: rsk._tilemax_only_launch(ops_d), reps=20),
            plain_ms=cuda_ms(lambda: run_d(rsk.tilemax_only_plain), reps=3),
            bound_ms=bms, bound_by=by, library_ms=cuda_ms(library),
            shape=f"B={BATCH} N={N_MAIN} F={F_MAIN} subs={so.RESCORE_SUBS} {Xs.dtype}",
        ))
        check(err_d <= TOL_SCORE, f"{label}: kernel vs plain maxima {err_d}")
        plan = rsk.tilemax_only_plan(BATCH, F_MAIN, Xs.dtype)
        check(plan["loader"] == "cp.async" and plan["queries_per_block"] == BATCH,
              f"{label}: the main path's shape does not get 16-byte copies and one query block: {plan}")
        record_resources(
            label, "rescored",
            f"tilemax_only_kernelILi{rsk._SCAN_MODES[Xs.dtype]}ELi{plan['queries_per_block']}ELb1E",
            plan, rsk.tilemax_only_plan_chosen(Xs, BATCH))

    # Kernel E in both row modes. The maxima-first tiers read f32 rows; the
    # int8-row mode serves the sketch callers of a later slice, so its row
    # carries the wrapper's count and its own mode's count (0) beside it.
    # The main path calls the wrapper with checked=True (no read-back of
    # the slab ids), and so is it timed here.
    e_launches = sum(tier_counts[t]["slab_dots"] for t in scan_of)
    qnorm = torch.linalg.norm(Q, dim=1)
    floor_ms = cuda_ms(lambda: sfk.empty_launch(dev), reps=20)
    for label, Xr, sel_e, peak, mode_launches, entry in (
        ("slab_dots_f32", Xt, sels["bf16x3_rescored"], PEAK_F32_FLOP_S, e_launches, "slab_dots_kernelILb0E"),
        ("slab_dots_int8", X8, sels["int8_rescored"], PEAK_BF16_FLOP_S, 0, "slab_dots_kernelILb1E"),
    ):
        de, dp = rsk.slab_dots(Xr, Q, sel_e, ts_r, checked=True), rsk.slab_dots_plain(Xr, Q, sel_e, ts_r)
        rows_e = sel_e[:, :, None] * ts_r + torch.arange(ts_r, device=dev)
        scale = qnorm[:, None, None] * torch.linalg.norm(Xr.float(), dim=1)[rows_e]
        err_e = float(((de - dp).abs() / torch.clamp(scale, min=1e-30)).max())
        plan_e = rsk.slab_dots_plan(BATCH, c_r, F_MAIN, Xr.dtype, x_addr=Xr.data_ptr())
        distinct = int(torch.unique(sel_e).numel())
        bms, by = bound(distinct * ts_r * F_MAIN * Xr.element_size() + 4 * BATCH * F_MAIN
                        + 4 * BATCH * c_r * ts_r + 8 * BATCH * c_r,
                        2 * BATCH * c_r * ts_r * F_MAIN, peak)
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:417",
            launches=e_launches, max_abs_err=err_e,
            ms=cuda_ms(lambda: rsk.slab_dots(Xr, Q, sel_e, ts_r, checked=True), reps=20),
            launch_ms=cuda_ms(lambda: rsk._slab_dots_launch(Xr, Q, sel_e, ts_r, de), reps=20),
            plain_ms=cuda_ms(lambda: rsk.slab_dots_plain(Xr, Q, sel_e, ts_r), reps=5),
            bound_ms=bms, bound_by=by, library_ms=None, launch_floor_ms=floor_ms,
            shape=f"B={BATCH} c={c_r} ts={ts_r} F={F_MAIN} {Xr.dtype} distinct_slabs={distinct}",
            mode_launches=mode_launches,
            err_scale="cosine (|Δd|/(‖q‖·‖x‖))",
            launch_floor="an empty kernel, timed the same way",
        ))
        check(err_e <= TOL_SCORE, f"{label}: kernel vs plain dots {err_e} on the cosine scale")
        record_resources(label, "rescored", entry, plan_e, rsk.slab_dots_plan_chosen(Xr, BATCH, c_r))

    # Kernel F on the direct-ELL graph of phase largef (n = 16384): the
    # Laplacian form LOBPCG applies to its [n, 3k] block, and one vector.
    n_e, k_e = ell_big.indices.shape
    live = ell_big.weights != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([live.nonzero()[:, 0], ell_big.indices[live].long()]),
        ell_big.weights[live], (n_e, n_e))
    Wcsr = coo.coalesce().to_sparse_csr()
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, m, launches, entry in (
        ("spmv_ell_block", 3 * LOBPCG_K, largef_counts[n_e]["lobpcg"], "spmv_ell_kernelILi16ELi1E"),
        ("spmv_ell_vector", 1, largef_counts[n_e]["path"], "spmv_ell_kernelILi1ELi1E"),
    ):
        V = torch.randn((n_e, m), device=dev, generator=gen)
        args = (ell_big.indices, ell_big.weights, V, ell_big.diag)
        got, ref = fk.spmv_ell(*args, checked=True), fk.spmv_ell_plain(*args)
        err_f = float((got - ref).abs().max())
        bms, by = bound(n_e * k_e * 8 + n_e * 4 + 2 * n_e * m * 4, 2 * int(live.sum()) * m + 2 * n_e * m)
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/spmv_ell.cu",
            replaces="matternet_rs_tpu/ops/pallas/spmv_ell.py:36", launches=launches,
            max_abs_err=err_f,
            ms=cuda_ms(lambda: fk.spmv_ell(*args, checked=True), reps=20),
            launch_ms=cuda_ms(lambda: fk._spmv_ell_launch(*args, got), reps=20),
            plain_ms=cuda_ms(lambda: fk.spmv_ell_plain(*args), reps=5),
            bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(lambda: torch.sparse.mm(Wcsr, V), reps=20),
            launch_floor_ms=floor_ms,
            shape=f"n={n_e} k={k_e} m={m} live_slots={int(live.sum())}",
            library="torch.sparse.mm(W as CSR, X): the product alone, without d∘X −",
            launch_floor="an empty kernel, timed the same way",
        ))
        check(bit_equal(got, ref), f"{label}: kernel vs plain not bit for bit ({err_f})")
        record_resources(label, "spmv_ell", entry, fk.spmv_ell_plan(n_e, k_e, m),
                         fk.spmv_ell_plan_chosen(n_e, k_e, m))

    # L@V inside LOBPCG: every block the solver applies on the large graph,
    # held bit for bit against the plain version on the same block.
    applied = []

    def capturing(Vb, method=type(ell_big).matvec):
        out = method(ell_big, Vb)
        applied.append((Vb.clone(), out.clone()))
        return out

    ell_big.matvec = capturing
    try:
        eig.lobpcg_smallest(ell_big, LOBPCG_K, iters=LOBPCG_ITERS)
    finally:
        del ell_big.matvec
    lobpcg_unequal = [i for i, (Vb, out) in enumerate(applied) if not bit_equal(
        out.reshape(n_e, -1), fk.spmv_ell_plain(ell_big.indices, ell_big.weights,
                                                Vb.reshape(n_e, -1), ell_big.diag))]
    lobpcg_check = dict(case=f"L@V inside LOBPCG (n={n_e} k={k_e}): {len(applied)} blocks",
                        bit_equal=not lobpcg_unequal, unequal_calls=lobpcg_unequal[:5])
    check(len(applied) == LOBPCG_ITERS + 1 and not lobpcg_unequal,
          f"LOBPCG's L@V: {len(applied)} blocks, unequal at {lobpcg_unequal[:5]}")
    del applied

    # Kernel G on the streamed phase's inputs: the scan (per-range lists)
    # and the merge, each against its plain version.
    r1, raw1 = results[1][0], results[1][3]
    rt1, _, ql1 = queries_of(r1, raw1)
    Qn = Xn[rt1].contiguous()
    splits = sfk.default_splits(N_MAIN, BATCH, dev)
    pv, pi = sfk.scan_partials(Xn, lams, Qn, ql1, K, ALPHA, splits)
    pv_p, pi_p = sfk.scan_partials_plain(Xn, lams, Qn, ql1, K, ALPHA, splits)
    filled = torch.isfinite(pv_p[:, :, :K])       # a range past the corpus end leaves −inf
    err_g = float((pv[:, :, :K] - pv_p[:, :, :K])[filled].abs().max())
    check(bool(torch.equal(filled, torch.isfinite(pv[:, :, :K]))),
          "search_fused_scan: kernel and plain lists fill different entries")
    bms, by = bound(4 * (N_MAIN * F_MAIN + BATCH * F_MAIN + N_MAIN + BATCH) + 8 * pv.numel(),
                    2 * BATCH * N_MAIN * F_MAIN)
    rows_out.append(dict(
        name="search_fused_scan", route="cuda", source="matternet_rs_tpu_torch/csrc/search_fused.cu",
        replaces="matternet_rs_tpu/ops/pallas/search_fused.py:108",
        launches=st_counts["search_fused"], max_abs_err=err_g,
        ms=cuda_ms(lambda: sfk.scan_partials(Xn, lams, Qn, ql1, K, ALPHA, splits)),
        plain_ms=cuda_ms(lambda: sfk.scan_partials_plain(Xn, lams, Qn, ql1, K, ALPHA, splits), reps=1),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.matmul(Qn, Xn.T)),
        matmul_then_topk_ms=cuda_ms(lambda: torch.topk(torch.matmul(Qn, Xn.T), K, dim=1)),
        shape=f"B={BATCH} N={N_MAIN} F={F_MAIN} k={K} splits={splits}",
        library="torch.matmul(Qn, Xn.T): the product alone; matmul_then_topk_ms adds torch.topk (two calls)",
    ))
    check(err_g <= TOL_SCORE, f"search_fused_scan: kernel vs plain list scores {err_g}")
    del pv_p, pi_p
    mi, mv = sfk.merge_partials(pv, pi, K)
    mi_p, mv_p = sfk.merge_partials_plain(pv, pi, K)
    ops_g = sfk._merge_operands(pv, pi, K)     # the wrapper's checks and outputs, made once
    flat_v = pv.view(BATCH, -1)
    bms, by = bound(8 * pv.numel() + 8 * BATCH * K, 0)
    rows_out.append(dict(
        name="search_fused_merge", route="cuda", source="matternet_rs_tpu_torch/csrc/search_fused.cu",
        replaces="matternet_rs_tpu/ops/pallas/search_fused.py:108",
        launches=st_counts["search_fused_merge"], max_abs_err=float((mv - mv_p).abs().max()),
        ms=cuda_ms(lambda: sfk.merge_partials(pv, pi, K), reps=20),
        launch_ms=cuda_ms(lambda: sfk._merge_launch(*ops_g), reps=20),
        plain_ms=cuda_ms(lambda: sfk.merge_partials_plain(pv, pi, K), reps=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.topk(flat_v, K, dim=1), reps=20),
        launch_floor_ms=cuda_ms(lambda: sfk.empty_launch(dev), reps=20),
        shape=f"B={BATCH} candidates={flat_v.shape[1]} k={K}",
        library="torch.topk over the flattened lists (no id tie-break)",
        launch_floor="an empty kernel of the same library, timed the same way",
    ))
    check(bool(torch.equal(mi, mi_p) and torch.equal(mv.view(torch.int32), mv_p.view(torch.int32))),
          "search_fused_merge: kernel vs plain")
    log = buildcache.BUILD_LOG.get("search_fused")
    resources["search_fused_merge"] = dict(ptxas=ptxas_resources(log, "search_fused_merge_kernel"))
    check(log is None or resources["search_fused_merge"]["ptxas"] is not None,
          "search_fused_merge: no ptxas report in the build log")
    # Kernels B and D at edge shapes, each against its plain version.
    def edge_arrays(f, b, seed):
        rng = np.random.default_rng(seed)
        Xe = rng.standard_normal((EDGE_N, f), dtype=np.float32)
        Xe[3] = 0.0
        arrs = [Xe, np.sqrt(np.sum(Xe * Xe, axis=1)).astype(np.float32),
                rng.random(EDGE_N, dtype=np.float32), rng.standard_normal((b, f), dtype=np.float32),
                rng.random(b, dtype=np.float32), rng.uniform(0.3, 0.9, b).astype(np.float32)]
        return [torch.from_numpy(a).to(dev) for a in arrs]

    def misaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    def max_gap(got, ref, what):
        fin = torch.isfinite(ref)
        check(bool(torch.equal(fin, torch.isfinite(got))), f"{what}: -inf entries differ")
        return float((got[fin] - ref[fin]).abs().max())

    edge = [lobpcg_check]
    for b_e, f_e, subs_e in EDGE_SHAPES_D:
        arrs = edge_arrays(f_e, b_e, seed=f_e + b_e)
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            Xs, rn = core.quantize_rows(arrs[0]) if dtype is torch.int8 else (arrs[0].to(dtype), None)
            for Xv in (Xs, misaligned(Xs)):
                plan = rsk.tilemax_only_plan(b_e, f_e, dtype, aligned=Xv.data_ptr() % 16 == 0)
                kw = dict(tile=so.DEFAULT_TILE, subs=subs_e, mask_from=EDGE_MASK_FROM, rn=rn)
                what = f"tilemax_only B={b_e} F={f_e} subs={subs_e} {dtype} {plan['loader']}"
                gap = max_gap(rsk.tilemax_only(Xv, *arrs[1:], **kw),
                              rsk.tilemax_only_plain(Xv, *arrs[1:], **kw), what)
                edge.append(dict(case=what, max_abs_err=gap))
                check(gap <= TOL_SCORE, f"{what}: kernel vs plain {gap}")
                check(plan == rsk.tilemax_only_plan_chosen(Xv, b_e)
                      and plan["loader"] == ("cp.async" if Xv is Xs and (f_e * Xs.element_size()) % 16 == 0
                                             else "elementwise"), f"{what}: unexpected plan {plan}")
    for b_e, f_e in EDGE_SHAPES_B:
        arrs = edge_arrays(f_e, b_e, seed=2 * f_e + b_e)
        for Xv in (arrs[0], misaligned(arrs[0])):
            what = f"scores_tilemax B={b_e} F={f_e} aligned={Xv is arrs[0]}"
            got = tmk.scores_and_tilemax(Xv, *arrs[1:], mask_from=EDGE_MASK_FROM)
            ref = tmk.scores_and_tilemax_plain(Xv, *arrs[1:], mask_from=EDGE_MASK_FROM)
            gap = max(max_gap(got[0], ref[0], what), max_gap(got[1], ref[1], what))
            edge.append(dict(case=what, max_abs_err=gap))
            check(gap <= TOL_SCORE, f"{what}: kernel vs plain {gap}")
            check(tmk.scores_tilemax_plan(b_e, f_e, aligned=Xv is arrs[0])
                  == tmk.scores_tilemax_plan_chosen(Xv, arrs[3]), f"{what}: unexpected plan")
    # Kernel A at edge shapes: against the f32 plain version and the 3xTF32
    # mirror; the zero row and the 1e-11 row give exactly 0; the plan is the
    # library's own.
    rng_a = np.random.default_rng(11)
    for f_e in EDGE_F_A:
        nodes = torch.from_numpy(rng_a.normal(size=(max(f_e, 2), 30)).astype(np.float32)).to(dev)
        L_e = lap.build_laplacian_matrix(nodes, GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False)
                                         ).matrix.contiguous()
        if f_e == 1:                           # a graph needs two nodes; one feature takes L = [[0.7]]
            L_e = torch.full((1, 1), 0.7, device=dev)
        for n_e, offset in [(n_e, False) for n_e in EDGE_N_A] + [(EDGE_N_A[-1], True)]:
            Xe = rng_a.normal(size=(n_e, f_e)).astype(np.float32)
            zero_rows = [r for r in (n_e // 3, n_e // 2) if n_e >= 3]
            if zero_rows:
                Xe[zero_rows[0]] = 0.0
                Xe[zero_rows[1]] = 1e-11
            Xe = torch.from_numpy(Xe).to(dev)
            if offset:
                Xe = misaligned(Xe)
            tau_e = tmo.select_tau(Xe, tmo.TAU_MEDIAN)
            got, rel, rel_mirror, _ = lam_gaps(Xe, L_e, tau_e)
            # Against the float64 closed form, with each row's rounding bound:
            # at F = 3 some rows' sums cancel and the float32 closed form
            # itself strays from the exact value by more than TOL_LAMBDA.
            exact = tk.taumode_lambdas_f64(Xe, L_e, tau_e)
            slack = tk.taumode_rounding_bound(Xe, L_e, tau_e, EPS_3XTF32)
            scale = torch.clamp(exact.abs(), min=1.0)
            mirror = tk.taumode_lambdas_3xtf32_plain(Xe, L_e, tau_e).double()
            vs_exact = float(((got.double() - exact).abs() / (TOL_LAMBDA * scale + slack)).max())
            vs_mirror = float(((got.double() - mirror).abs() / (TOL_LAMBDA_MIRROR * scale + 2 * slack)).max())
            plan = tk.taumode_plan(n_e, f_e, Xe.data_ptr() % 16 == 0, sms)
            what = f"taumode N={n_e} F={f_e} {plan['loader']} splits={plan['splits']}"
            edge.append(dict(case=what, max_rel_err=rel, max_rel_err_vs_3xtf32_mirror=rel_mirror,
                             exact_gap_over_tolerance_and_bound=vs_exact,
                             mirror_gap_over_tolerance_and_bound=vs_mirror,
                             max_rounding_bound=float(slack.max())))
            check(vs_exact <= 1.0 and vs_mirror <= 1.0,
                  f"{what}: kernel vs exact {vs_exact}, vs mirror {vs_mirror} (of tolerance + bound); "
                  f"strict gaps {rel}, {rel_mirror}")
            check(all(float(got[r]) == 0.0 for r in zero_rows), f"{what}: zero rows not 0")
            check(plan == tk.taumode_plan_chosen(Xe), f"{what}: unexpected plan")
            check(plan["loader"] == ("elementwise" if offset or f_e % 4 else "tma"),
                  f"{what}: wrong loader")

    # Kernel F at edge cases, bit for bit, both forms: empty slots carry −1
    # or name a row of inf that no live slot names; every tenth row has no
    # live slot at all.
    rng_f = np.random.default_rng(13)
    for n_e in EDGE_N_F:
        poison = n_e - 1 if n_e > 1 else None
        for k_e in EDGE_K_F:
            idx_e = rng_f.integers(0, max(n_e - 1, 1), size=(n_e, k_e)).astype(np.int32)
            w_e = rng_f.random((n_e, k_e)).astype(np.float32)
            empty = rng_f.random((n_e, k_e)) < 0.3
            empty[::10] = True
            w_e[empty] = 0.0
            to_poison = empty & (rng_f.random((n_e, k_e)) < 0.5)
            idx_e[empty] = -1
            if poison is not None:
                idx_e[to_poison] = poison
            idx_t, w_t = torch.from_numpy(idx_e).to(dev), torch.from_numpy(w_e).to(dev)
            for m_e in EDGE_M_F:
                V = torch.from_numpy(rng_f.normal(size=(n_e, m_e)).astype(np.float32)).to(dev)
                if poison is not None:
                    V[poison] = float("inf")
                for d_e in (None, w_t.sum(dim=1)):
                    got = fk.spmv_ell(idx_t, w_t, V, d_e, checked=True)
                    ref = fk.spmv_ell_plain(idx_t, w_t, V, d_e)
                    fin = torch.ones(n_e, dtype=torch.bool, device=dev)
                    if poison is not None:
                        fin[poison] = False
                    what = f"spmv_ell n={n_e} k={k_e} m={m_e} {'W@X' if d_e is None else 'd∘X−W@X'}"
                    same = bit_equal(got, ref)
                    edge.append(dict(case=what, bit_equal=same))
                    check(same, f"{what}: kernel vs plain not bit for bit")
                    check(bool(torch.isfinite(got[fin]).all()), f"{what}: an empty slot reached X")
                check(fk.spmv_ell_plan(n_e, k_e, m_e) == fk.spmv_ell_plan_chosen(n_e, k_e, m_e),
                      f"spmv_ell n={n_e} k={k_e} m={m_e}: unexpected plan")

    # Kernel E at edge cases (≤ 1e-5 on the cosine scale): every F, ts, c
    # and B, f32 and int8 rows (F = 1 and 3: int8 rows off 4 bytes), X
    # aligned and 4 bytes off; one id out of range gives a NaN slice.
    rng_e = np.random.default_rng(14)
    for f_e in EDGE_F_E:
        for ts_e in EDGE_TS_E:
            Xf = torch.from_numpy(rng_e.standard_normal((EDGE_SLABS_E * ts_e + 7, f_e),
                                                        dtype=np.float32)).to(dev)
            for Xr in (Xf, core.quantize_rows(Xf)[0]):
                off = 4 // Xr.element_size()
                buf = torch.empty(Xr.numel() + off, dtype=Xr.dtype, device=dev)
                Xo = buf[off:].view(Xr.shape)
                Xo.copy_(Xr)
                xnorm = torch.linalg.norm(Xr.float(), dim=1)
                for c_e in EDGE_C_E:
                    for b_e in EDGE_B_E:
                        Qe = torch.from_numpy(rng_e.standard_normal((b_e, f_e), dtype=np.float32)).to(dev)
                        sel_e = torch.sort(torch.from_numpy(
                            rng_e.integers(0, EDGE_SLABS_E, (b_e, c_e))).to(dev), dim=1).values
                        per = max(1, PLAIN_GATHER_BYTES // (c_e * ts_e * f_e * 4))
                        rows_e = sel_e[:, :, None] * ts_e + torch.arange(ts_e, device=dev)
                        scale = torch.linalg.norm(Qe, dim=1)[:, None, None] * xnorm[rows_e]
                        for Xv in (Xr, Xo):
                            ref = torch.cat([rsk.slab_dots_plain(Xv, Qe[q0:q0 + per], sel_e[q0:q0 + per], ts_e)
                                             for q0 in range(0, b_e, per)])
                            got = rsk.slab_dots(Xv, Qe, sel_e, ts_e, checked=True)
                            gap = float(((got - ref).abs() / torch.clamp(scale, min=1e-30)).max())
                            plan = rsk.slab_dots_plan(b_e, c_e, f_e, Xv.dtype, x_addr=Xv.data_ptr())
                            what = (f"slab_dots F={f_e} ts={ts_e} c={c_e} B={b_e} {Xv.dtype} "
                                    f"{'offset' if Xv is Xo else 'aligned'} {plan['reads']}")
                            edge.append(dict(case=what, max_rel_err=gap))
                            check(gap <= TOL_SCORE, f"{what}: kernel vs plain {gap} on the cosine scale")
                            check(plan == rsk.slab_dots_plan_chosen(Xv, b_e, c_e), f"{what}: unexpected plan")
    bad_sel = torch.tensor([[0, 5], [7, EDGE_SLABS_E], [-1, 2]], device=dev)
    d_bad = rsk.slab_dots(Xf, torch.ones((3, Xf.shape[1]), device=dev), bad_sel, EDGE_TS_E[-1], checked=True)
    nan_ok = bool(torch.isnan(d_bad[1, 1]).all() and torch.isnan(d_bad[2, 0]).all()
                  and torch.isfinite(d_bad[0]).all() and torch.isfinite(d_bad[1, 0]).all()
                  and torch.isfinite(d_bad[2, 1]).all())
    edge.append(dict(case="slab_dots ids out of range", nan_slices=nan_ok))
    check(nan_ok, "slab_dots: an out-of-range id does not give exactly its NaN slice")

    # The merge at edge cases, bit for bit: unsorted lists of random scores,
    # all scores equal (ties fall to the ids, some repeated), ±0.0 only,
    # half the entries −inf with EMPTY_ID.
    rng_g = np.random.default_rng(12)
    for b_e in EDGE_B_G:
        for cand_e in EDGE_CAND_G:
            for kind in EDGE_KINDS_G:
                v = rng_g.normal(size=(b_e, cand_e)).astype(np.float32)
                ids_e = rng_g.integers(0, 50 * cand_e, size=(b_e, cand_e)).astype(np.int32)
                if kind == "ties":
                    v[:] = 0.25
                    ids_e = rng_g.integers(0, cand_e, size=(b_e, cand_e)).astype(np.int32)
                elif kind == "zeros":
                    v = np.where(rng_g.random((b_e, cand_e)) < 0.5, np.float32(-0.0), np.float32(0.0))
                    ids_e = rng_g.integers(0, cand_e // 2 + 1, size=(b_e, cand_e)).astype(np.int32)
                elif kind == "fills":
                    empty = rng_g.random((b_e, cand_e)) < 0.5
                    v[empty] = -np.inf
                    ids_e[empty] = sfk.EMPTY_ID
                pv_e = torch.from_numpy(v.reshape(b_e, -1, 16)).to(dev)
                pi_e = torch.from_numpy(ids_e.reshape(b_e, -1, 16)).to(dev)
                for k_e in EDGE_K_G:
                    ik, vk = sfk.merge_partials(pv_e, pi_e, k_e)
                    ip, vp = sfk.merge_partials_plain(pv_e, pi_e, k_e)
                    same = bool(torch.equal(ik, ip) and torch.equal(vk.view(torch.int32), vp.view(torch.int32)))
                    what = f"search_fused_merge B={b_e} candidates={cand_e} k={k_e} {kind}"
                    edge.append(dict(case=what, bit_equal=same))
                    check(same, f"{what}: kernel vs plain")
    torch.cuda.synchronize()
    emit(phase="kernels", card=card, rows=len(rows_out), resources=resources, edge_cases=edge)

    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
