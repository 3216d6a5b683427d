#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``matternet_rs_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, one output line each (JSON):

1. build — compile the CUDA kernels, the host clustering library and the
   shard reader from this checkout's sources, all at once; name the card.
2. main — the user's main path at the repository's headline size: the
   eigen build of ``make_energy_test_dataset(1_000_000, 128, seed=44)``
   with the benchmark's builder settings, then ``search_batch(k=10,
   alpha=0.7)`` over one untimed warm-up batch and three timed batches of
   256 corpus rows. Checks: each
   query's own row is in its top-10 and its top-1 score is at least its
   own blended score less 1e-5; the ids equal those of the same fused
   search run through the kernels' plain versions on the card, up to the
   near-tie rule (``utils/parity.py``, tolerance 1e-5). At k = 10 the
   exact tier's candidate stage (sub-tile selection, gather and top-k) is
   one launch of ``subtile_topk`` a batch (4 in all) and kernel C is not
   launched. The three timed batches then run again through that stage and
   through the selection chain it replaced (kernel C's gather and the
   stable sorts), in turns (stage, chain, chain, stage), each route also
   once under ``torch.profiler``: ms per batch, device-busy ms and idle
   share of each go on the phase's line. One more search at k = 40 takes
   the chain: kernel C launches once, the stage never, and its first ten
   ids are the k = 10 search's.
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
   phase 4, each LOBPCG call of phase 5, phase 6, phases 7–9 (build and
   searches), phase 11 (build and searches), each tier of phase 12, each
   step of phase 13, phases 14 and 15, and read just after each; every
   kernel of a path must have launched. The kernel rows of A, B and the
   candidate stage add the launches of phases 7–9, 11–14 to phase 2's
   (``launches_by_path``); those of D and E add phases 12's and 13's to
   phase 3's.
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
7. heuristics — the builder's default k on phase 2's data (no
   ``max_clusters``, ``with_seed(42)``): ``clustering.compute_optimal_k``
   timed alone (k bounds, intrinsic dimension, k, radius), one k-means++
   run and 20 Lloyd iterations on its 1,000-row sample timed apart (both
   under ``torch.cuda.set_sync_debug_mode("error")``: they read nothing
   back from the card), then the build (it must take the same k and
   radius; kernel A launches) and one warm-up and three timed searches
   (each query finds its own row; kernel B and the candidate stage
   launch).
8. jl — ``make_energy_test_dataset(200_000, 768, seed=46)`` (200,000 rows
   cut from a 1M-row, 768-wide corpus for the run's time limit), phase 2's
   builder settings (111 clusters at this N) with
   ``with_dims_reduction(True)`` and ``with_seed(42)``: the
   reduced width is 384, the card's projection matrix is the host's
   ``prng.normal`` draw bit for bit, kernel A launches on the projected
   rows and is held against its plain version there (1e-5·max(1, |λ|)),
   λ is finite; then one warm-up and three timed searches with phase 2's
   checks (own row, exact blended scores within 1e-5, the plain route
   under the near-tie rule). Stage, projection and host-matrix seconds.
9. persist — if ``pyarrow`` imports (an up-front check, never a caught
   error): ``save_checkpoint`` of phase 8's index into a temporary
   directory, ``load_arrowspace(device="cuda")``, the same batches: ids
   equal, scores and λ bit-equal; save and load seconds, bytes on disk;
   then ``drop_data()`` and ``prepare_query_item`` gives the same λ.
   Without ``pyarrow`` the line says ``"pyarrow": "absent"``.
10. shards — phase 8's rows written as raw shards of 65,536 rows (the last
   partial), streamed back in 32,768-row blocks by the native reader onto
   the card (bit for bit against X), ``read_rows`` of a batch's ids; write
   and read-to-card MB/s.
11. streaming — the out-of-core index (``index/streaming.py``) at the
   resident-sketch tier's own scale, 10,000,000 × 96 (cut, never below
   ``MAXFIRST_MIN_ROWS``, only when the temporary disk cannot hold the
   store and the sketch: the line says ``cut=``): 256 Gaussian centres × 4
   plus unit noise from the seed, written block by block as 1M-row shards;
   ``build_from_store`` with the headline graph settings (λ-graph (1.0, 6),
   250 clusters, radius 25, 131,072-row blocks, 200,000 sample rows,
   ``emit_sketch=True``; kernel A on every block); ``build_sketch`` from
   ``sketch.bin``; 256-query batches of corpus rows, k = 10, α = 0.7, the
   default candidates: one warm-up and three timed batches of each of
   maxima-first (the auto route at this N) and the carry scan, refined or
   not, in turns; a profile of the maxima-first refined batches; recall@10
   of each against the streamed exact scan, whose ms/batch and MB/s are
   taken over two batches in f32 and in bf16. Kernel E's ring and pair
   designs are timed at this shape launched alone and inside the
   maxima-first scan, in turns. Checks: kernel A on the first block within
   1e-5·max(|λ|, 1) of its plain version (and the λ file's block), finite
   stats; kernel D in int8 mode against its plain version on the first 1M
   flat rows and on the tile that holds ``mask_from`` (sub-tiles past
   ``n_items`` −inf); kernel E's int8 rows against the plain version on the
   path's own slab selection (≤ 1e-5 on the cosine scale); with 64 slabs
   of candidates (the most the maxima-first scan takes) the refined
   maxima-first results equal the carry scan's, ids and score bits; the
   streamed exact scan over the first 1M rows against the in-memory exact
   tier under the near-tie rule; a reload (``load`` + ``build_sketch``)
   searches bit for bit as before; the maxima-first scan makes no
   synchronising call from the query λ to its candidate ids
   (``set_sync_debug_mode("error")``). Kernels A, D and E must launch.
12. energy — the energy pipeline at the reference benchmark's size
   (``bench.py`` ``bench_energy``): ``build_energy`` of
   ``make_energy_test_dataset(1_000_000, 128, seed=43)`` with phase 2's
   builder settings, ``with_expected_items`` and
   ``with_dims_reduction(True)``: stage seconds, S, the largest equal-λ
   group and the largest groups, the build's launches (none: the
   sub-centroid λ is the plain closed form, as the reference's); checks
   that each item's λ is its sub-centroid's and the item norms are ‖x‖.
   ``search_energy_batch`` over one warm-up and three timed batches of 256
   corpus rows, k = 10: the full scan (self-retrieval@10),
   ``candidates="auto"`` (must take the full scan), a forced window of the
   largest group plus k (its route printed), the full scan and ``auto`` at
   B = 8, 16 serial ``search_energy`` calls; every route against the full
   scan under the same-k rule at 1e-14 (``ENERGY_TIE_TOL``: the tie-break
   term 1e-9·(1 − cos) at a cosine tolerance of 1e-5). The same on the
   reference's banded benchmark index (``bench_energy_banded_1m``: 1M
   normal rows, 2,048 sorted sub-centroid λ at random), where ``auto``
   must take the full scan at B = 256 and band at B = 8 and the forced
   window must band. Energy-mode ``search_batch`` on the exact tier and on
   ``bf16x3_rescored`` (counts set to 0 before each and read after: B and
   the candidate stage, D and E must launch), each held against its plain
   route as phases 2 and 3 hold theirs, the returned scores exact (1e-5),
   the query λ the nearest sub-centroid's; profiles of the full energy
   scan and of both tiers. A checkpoint of a 100,000-row build of the
   same fixture (a cut for the time limit) saved, reloaded on the card and
   searched bit for bit. The 1M index written as an energy store (shards,
   raw λ, graph, ``energy.npz``, ``index.json``: the layout of the
   reference's ``ShardedArrowSpace.to_store``), loaded by
   ``StreamingIndex``, searched streamed and on the resident sketch
   (refined), both against the in-memory scan under the same-k rule at the
   store's λ round trip (twice its largest error plus the tie-break term's
   span 2e-9, or 1e-14 when exact) and, for the sketch, 1e-9·2δ more (δ
   the int8 sketch's cosine bound over the rows); recall@10 of each.
13. items — on a shallow copy of phase 2's index (every mutation assigns
   new tensors, so later phases see the original): ``get_item`` and
   ``cluster_of``; each of the exact tier, ``int8_rescored`` and
   ``bf16x3_rescored`` searched once (their caches made), then
   ``set_item`` of row r to 1.5 × row s (the caches must be gone) and
   ``recompute_lambdas``; each tier on a batch of 256 whose first query is
   the new row must return r with its exact blended score (1e-5) and
   exact scores throughout, B and the candidate stage, or D and E,
   launching once; ``scale_item``, ``superpose_items`` and ``mul_items``
   (rows as expected); ``add_items`` of 65,536 noisy corpus rows (kernel
   A, one launch); then every appended row queried in batches of 256 must
   find itself in its top-10 with a top-1 score at least its own less
   1e-5. Each recompute launches kernel A once, and its λ of all rows
   (the appended rows after ``add_items``) is held against kernel A's
   plain version within 1e-5·max(|λ|, 1). Seconds and launches by step.
14. lambda_search — on phase 2's index: ``build_ivf_index`` (segment means
   of the build's clusters, 1,024-row buckets); ``search_batch_ivf`` over
   phase 2's warm-up and timed batches at nprobe 8 (ms per batch,
   recall@10 against phase 2's exact ids, the query block's gather bytes)
   and one batch at nprobe = the bucket count (held to the exact tier at
   k + 1 under the near-tie rule, 1e-5; its peak allocation). Then 16
   queries each through ``search_lambda_aware_hybrid``,
   ``search_lambda_banded`` (window 4,096), ``search_linear_sorted``,
   ``search_k_nearest_by_lambda`` and ``range_search`` (ε = −0.1): ms a
   call, each against a plain torch form in float64 on the card (hybrid
   and banded: the same-k rule at 1e-5; the sorted band: equal, bounds
   taken in float32 as the index takes them; k nearest by λ: the k
   smallest |Δλ| of all items; range: equal ids but those within 1e-6 of
   ε).
15. pipeline — on ``make_gaussian_hd(200_000, 0.3)`` (the reference's
   100-D fixture; 200,000 rows rather than 1M because stage A is the host
   scan): first stages A, B0 and B1 with the reference's default MST k = 8
   at cap 3,000: the nodes the MST reached and the thick centroids
   (thickness > 1) that stage A's force-assignment made, whose nearest
   are one another (``pipeline.build`` then raises ``IndexError``, as the
   reference does: ``tests/test_torch_pipeline.py``). Then
   ``pipeline.build`` with the reference's default ``PipelineConfig``
   (radius 1.0, Bhattacharyya MST, median τ) but MST k = 32, at the
   default cap C = 10,000 and at 3,000: stage seconds, C, the nodes the
   MST reached (must be C), the trunk length, τ (must be the median of λ),
   the Laplacian's nnz, stage C's least distance between two features'
   profiles (an edge needs it below ln(1e9); at C = 10,000 none is, the
   graph is empty and λ = 0, so the run at 3,000 must keep edges and a τ
   above its floor), the build's peak allocation; stage D's λ against a
   float64 recompute on the card from the port's own L and rows
   (1e-5·max(|λ|, 1)); L symmetric (exactly when unnormalised, within
   1e-6 when normalised: its two scalings round in either order), the
   unnormalised L's rows summing to 0; ``save_result`` →
   ``load_result_arrays`` bit for bit. At C = 10,000 also the tiled
   Bhattacharyya pass on the smoothed state alone (seconds, peak
   allocation beside the untiled [C, C, F] intermediate's bytes) and its
   first 256 rows against the untiled float64 form (1e-5 relative to the
   summands' magnitude: the log terms cancel for near pairs, in float32
   as in the reference). No kernel launches here (the reference runs this
   chain outside Pallas).
16. kernels — each kernel against its plain PyTorch version on the inputs
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
   ±0.0 and −inf fills. The candidate stage's row (``subtile_topk``, on
   kernel B's scores and maxima of the main path's batch and its ragged
   tail) carries ``launch_ms`` (its C entry point alone), ``launch_floor_ms``,
   ``plain_ms`` (the selection chain on the plain gather), ``chain_ms``
   (the chain with kernel C as its gather) and ``library_ms`` (one
   ``torch.topk`` over the full [B, n] plane, no id tie-break); kernel C's
   row keeps the k = 10 shape (c = 14) with its main-path launches (0) and
   those of the k = 40 search beside them; C is also held bit for bit at
   c = 44. The stage is held bit for bit (values and ids) against the chain
   at random, all-equal, ±0.0-only, half −inf and 1% NaN scores and at
   scores and maxima one element off 16 bytes, for B in {1, 7, 256}, k in
   {1, 10, 16} and tails of 0, 1 and 2,047 columns (64 sub-tiles); with
   every sub-tile selected (1 and 8 sub-tiles); and with the maxima staged
   in two chunks (5,000 sub-tiles). The rows of kernels E and F carry ``launch_ms``
   (the kernel alone) and ``launch_floor_ms`` (the same empty kernel).
   Their launch plans (held equal to the library's) and ptxas reports go to the phase's
   line. Kernel F is held bit for bit at every n in {1, 31, 16384} with
   every k in {1, 14, 40} and m in {1, 15, 16, 17, 256}, both forms, with
   rows of empty slots only, empty slots at −1 or naming a row of inf that
   no live slot names. Kernel E is held at every F
   in {1, 3, 96, 100, 128, 768, 2048} with ts in {128, 256}, c in {1, 14},
   B in {1, 7, 256}, f32 and int8 rows (the ring where it applies), X
   aligned and 4 bytes off, each query's last slab the corpus's last whole
   one; ids out of range give exactly their NaN slices.

Every phase line carries ``at_seconds``, the time since the script
started; a ``total`` line gives the whole run's seconds. Then the
``kernels`` line, the card's name and power limit (``nvidia-smi``), and
last ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero. Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

N_MAIN, F_MAIN, SEED_MAIN = 1_000_000, 128, 44
N_WIDE, F_WIDE, SEED_WIDE = 40_000, 768, 45
BATCH, K, ALPHA, N_BATCHES = 256, 10, 0.7, 3
K_CHAIN = 40                  # a k past the candidate stage's 16: the selection chain with kernel C
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
# The candidate stage's edge cases: score kinds, queries, tail widths, k.
EDGE_KINDS_H = ("random", "equal", "zeros", "fills", "nan", "offset")
EDGE_B_H, EDGE_NR_H, EDGE_K_H = (1, 7, 256), (0, 1, 2047), (1, 10, 16)
EDGE_SHAPES_D = ((3, 100, 16), (300, 100, 8), (3, 768, 8), (300, 768, 16))
EDGE_SHAPES_B = ((3, 100), (3, 768), (300, 768))
# Kernel F's edge cases: every n with every k and m, both forms.
EDGE_N_F, EDGE_K_F, EDGE_M_F = (1, 31, 16_384), (1, 14, 40), (1, 15, 16, 17, 256)
# Kernel E's edge cases: every F, ts, c and B, both row types, X aligned and
# 4 bytes off; EDGE_SLABS_E slabs of corpus.
EDGE_F_E, EDGE_TS_E, EDGE_C_E, EDGE_B_E, EDGE_SLABS_E = (
    (1, 3, 96, 100, 128, 768, 2048), (128, 256), (1, 14), (1, 7, 256), 40)
PLAIN_GATHER_BYTES = 1 << 28  # kernel E's plain version gathers at most this much at once
# Phases heuristics, jl, persist, shards. The jl corpus is 200,000 rows cut
# from a 1M-row, 768-wide one for the run's time limit; its 111 clusters
# give the JL width min(jl_dim(111, 768, 0.3) = 419, 768 // 2) = 384.
SEED_HEURISTICS = 42
N_JL, F_JL, SEED_JL, JL_DIM = 200_000, 768, 46, 384
SHARD_ROWS, SHARD_BLOCK_ROWS = 65_536, 32_768
# Phase streaming: the resident-sketch tier at the reference's own scale
# (DESIGN.md: 10M × 96, the Deep1B width): 1M-row shards, 256 Gaussian
# centres × 4 plus unit noise, the headline build's graph settings.
N_STREAM, F_STREAM, SEED_STREAM = 10_000_000, 96, 47
STREAM_SHARD_ROWS, STREAM_CENTRES, STREAM_CLUSTERS, STREAM_SAMPLE = 1_000_000, 256, 250, 200_000
STREAM_CHECK_ROWS = 1_000_000    # rows of the kernel-D and in-memory checks
# Phase energy: the reference benchmark's energy build (bench.py bench_energy,
# 1M × 128, seed 43), its checkpoint cut to 100,000 rows, and the
# reference's banded benchmark index (bench_energy_banded_1m: seed 5, 2048
# sub-centroid λ at random).
N_ENERGY, SEED_ENERGY, N_ENERGY_CKPT, N_ENERGY_SERIAL = 1_000_000, 43, 100_000, 16
SEED_SPREAD, SPREAD_SUBCENTROIDS = 5, 2048
# Phase items: the rows it picks, the rows it appends (kernel A's route is
# from 32,768), the tiers it holds after set_item.
SEED_ITEMS, N_ITEMS_NEW = 48, 65_536
ITEM_TIERS = (False, "int8_rescored", "bf16x3_rescored")
# Phase lambda_search: IVF probes, the queries of the other searches, the
# banded window, the range search's ε.
IVF_NPROBE, N_LAMBDA_QUERIES, BAND_WINDOW, RANGE_EPS = 8, 16, 4096, -0.1
# Phase pipeline: make_gaussian_hd rows (cut from 1M: stage A is the host
# clustering scan, ≈ 0.1 ms a row at C = 10,000); the MST's candidate k
# (the default 8 leaves the fixture's thick centroids out of the tree, as
# the reference does; 32 reaches them); stage A's caps: the default
# 10,000, where every pair of feature profiles is too far apart for stage
# C to keep an edge, and 3,000, where it keeps some.
N_PIPELINE, PIPELINE_MST_K, PIPELINE_CAPS = 200_000, 32, (10_000, 3_000)


def stream_disk_bytes(n: int) -> int:
    """Temporary disk the streaming phase needs at n rows: the f32 store,
    the int8 sketch (and its tmp), λ and multipliers, 5% and 256 MB spare."""
    return int(n * (4 * F_STREAM + F_STREAM + 8) * 1.05) + (256 << 20)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T_START = time.perf_counter()


def emit(**kw):
    """One phase line; ``at_seconds`` is the time since the script started."""
    print(json.dumps({**kw, "at_seconds": time.perf_counter() - T_START}), flush=True)


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


def profiled(search, items):
    """Run ``search(r)`` for each of ``items`` under ``torch.profiler``:
    wall ms per item (host clock), device-busy ms per item (the union of
    the traced kernels' intervals), idle share, top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nb = len(items)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in items:
            search(r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nb
    dev_busy = busy_ms(prof.events(), DeviceType.CUDA) / nb

    def dev_ms(a):
        return getattr(a, "self_device_time_total", None) or getattr(a, "self_cuda_time_total", 0)

    kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    top = sorted(kern, key=dev_ms, reverse=True)[:TOP_KERNELS]
    return dict(batches=nb, wall_ms_per_batch=wall_ms,
                device_busy_ms_per_batch=dev_busy,
                idle_share=1.0 - dev_busy / wall_ms if wall_ms > 0 else None,
                top_kernels=[{"name": a.key[:80], "calls_per_batch": a.count / nb,
                              "device_ms_per_batch": dev_ms(a) / 1e3 / nb}
                             for a in top if dev_ms(a) > 0])


def make_builder(n):
    """The reference benchmark's builder settings (``bench.py:_make_builder``)."""
    from matternet_rs_tpu_torch import ArrowSpaceBuilder

    return (
        ArrowSpaceBuilder()
        .with_lambda_graph(1.0, 6)
        .with_sparsity_check(False)
        .with_cluster_params(max_clusters=max(64, int(2 * n**0.5) // 8), radius=25.0)
        .with_sampling(None)
    )


def energy_phase(dev, card):
    """Phase 12, ``energy`` (module docstring). Returns the launches of
    energy-mode ``search_batch`` by tier, each counted from 0 just before
    its batches and read just after."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from matternet_rs_tpu_torch import convert
    from matternet_rs_tpu_torch import energymaps as em
    from matternet_rs_tpu_torch.graph import GraphLaplacian
    from matternet_rs_tpu_torch.index import streaming as sti
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.storage import shards
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
    from matternet_rs_tpu_torch.utils.parity import (
        ENERGY_TIE_TOL,
        energy_store_tolerance,
        same_k_mismatches,
        topk_mismatches,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def over(fn, items):
        """``fn(item)`` over ``items`` (the first a warm-up): ms each, outputs."""
        ms, outs = [], []
        for it in items:
            out, s = timed(lambda: fn(it))
            ms.append(s * 1e3)
            outs.append(out)
        return ms, outs

    def mismatches(ref, got, tol):
        return [m for (ri, rd), (gi, gd) in zip(ref, got) for m in same_k_mismatches(ri, rd, gi, gd, tol)]

    def timing(ms):
        return dict(warmup_ms=ms[0], ms_per_batch_median=statistics.median(ms[1:]), ms_per_batch=ms[1:])

    # Count the banded program's launches, to read each call's route.
    banded_calls = [0]
    banded = em._banded_search

    def counting_banded(*a, **kw):
        banded_calls[0] += 1
        return banded(*a, **kw)

    def routed(fn, items):
        before = banded_calls[0]
        ms, outs = over(fn, items)
        return ms, outs, ("banded" if banded_calls[0] > before else "full scan")

    em._banded_search = counting_banded
    try:
        # -- build (the reference benchmark's bench_energy) ------------------
        X = make_energy_test_dataset(N_ENERGY, F_MAIN, seed=SEED_ENERGY).astype(np.float32)
        builder = make_builder(N_ENERGY).with_expected_items(N_ENERGY).with_dims_reduction(True)
        kernels.reset_launches()
        (aspace, gl), build_s = timed(lambda: builder.build_energy(X))
        build_counts = kernels.launch_counts()
        n_sub = int(aspace.sub_centroids.shape[0])
        tie = aspace.max_lambda_tie_group()
        cmap = aspace.centroid_map
        sc_lam32 = torch.from_numpy(aspace.subcentroid_lambdas.astype(np.float32)).to(dev)
        state_ok = bool(
            cmap.shape == (N_ENERGY,) and cmap.min() >= 0 and cmap.max() < n_sub
            and torch.isfinite(aspace.lambdas).all()
            and torch.equal(aspace.lambdas, sc_lam32[torch.from_numpy(cmap).to(dev)])
            and torch.equal(aspace.item_norms, torch.sqrt(torch.sum(aspace.data * aspace.data, dim=1))))
        check(state_ok, "energy: the built state is inconsistent (map, λ or item norms)")
        group_sizes = np.sort(np.bincount(cmap, minlength=n_sub))[::-1]

        rows = np.random.default_rng(11).choice(N_ENERGY, BATCH * (N_BATCHES + 1), replace=False)
        batches = rows.reshape(N_BATCHES + 1, BATCH)
        rows8 = np.random.default_rng(12).choice(N_ENERGY, 8 * (N_BATCHES + 1), replace=False)
        batches8 = rows8.reshape(N_BATCHES + 1, 8)

        def scan(sp, Xh, **kw):
            return lambda r: em.search_energy_batch(sp, Xh[r], gl, K, **kw)

        # -- search_energy_batch ------------------------------------------
        full_ms, full_out, full_route = routed(scan(aspace, X), batches)
        self_hits = float(np.mean([r[b] in idx[b] for r, (idx, _) in zip(batches[1:], full_out[1:])
                                   for b in range(BATCH)]))
        auto_ms, auto_out, auto_route = routed(scan(aspace, X, candidates="auto"), batches)
        forced = tie + K
        forced_ms, forced_out, forced_route = routed(scan(aspace, X, candidates=forced), batches)
        f8_ms, f8_out, _ = routed(scan(aspace, X), batches8)
        a8_ms, a8_out, a8_route = routed(scan(aspace, X, candidates="auto"), batches8)
        serial_rows = batches[1][:N_ENERGY_SERIAL]
        serial_ms, serial_out = over(lambda i: em.search_energy(aspace, X[i], gl, K), serial_rows)
        serial_bad = mismatches(
            [(full_out[1][0][b:b + 1], full_out[1][1][b:b + 1]) for b in range(N_ENERGY_SERIAL)],
            [(np.array([[i for i, _ in o]]), np.array([[s for _, s in o]], np.float32)) for o in serial_out],
            ENERGY_TIE_TOL)
        scan_bad = dict(
            auto=mismatches(full_out, auto_out, ENERGY_TIE_TOL),
            forced=mismatches(full_out, forced_out, ENERGY_TIE_TOL),
            auto_b8=mismatches(f8_out, a8_out, ENERGY_TIE_TOL), serial=serial_bad)
        check(full_route == "full scan" and auto_route == "full scan",
              f"energy: B={BATCH} routes {full_route} / auto {auto_route}, not the full scan")
        check(not any(scan_bad.values()), f"energy: routes disagree: { {k: v[:2] for k, v in scan_bad.items()} }")

        # The reference's banded benchmark index (bench.py bench_energy_banded_1m):
        # normal rows, 2048 sorted sub-centroid λ assigned at random.
        rs = np.random.default_rng(SEED_SPREAD)
        Xs = rs.normal(size=(N_ENERGY, F_MAIN)).astype(np.float32)
        sub_s = rs.normal(size=(SPREAD_SUBCENTROIDS, F_MAIN)).astype(np.float32)
        lam_s = np.sort(rs.uniform(0.0, 1.0, SPREAD_SUBCENTROIDS)).astype(np.float32)
        assign = rs.integers(0, SPREAD_SUBCENTROIDS, N_ENERGY)
        qs = [rs.integers(0, N_ENERGY, BATCH) for _ in range(N_BATCHES + 1)]
        qs8 = [rs.integers(0, N_ENERGY, 8) for _ in range(N_BATCHES + 1)]
        spread, _ = convert.arrowspace_from_arrays(
            Xs, lam_s[assign], np.eye(F_MAIN, dtype=np.float32), min_lambdas=0.0, max_lambdas=1.0,
            range_lambdas=1.0, sub_centroids=sub_s, subcentroid_lambdas=lam_s, centroid_map=assign,
            device=dev)
        tie_s = spread.max_lambda_tie_group()
        s_full_ms, s_full, _ = routed(scan(spread, Xs), qs)
        s_auto_ms, s_auto, s_auto_route = routed(scan(spread, Xs, candidates="auto"), qs)
        s_forced_ms, s_forced, s_forced_route = routed(scan(spread, Xs, candidates=tie_s + K), qs)
        s_f8_ms, s_f8, _ = routed(scan(spread, Xs), qs8)
        s_a8_ms, s_a8, s_a8_route = routed(scan(spread, Xs, candidates="auto"), qs8)
        spread_bad = dict(auto=mismatches(s_full, s_auto, ENERGY_TIE_TOL),
                          forced=mismatches(s_full, s_forced, ENERGY_TIE_TOL),
                          auto_b8=mismatches(s_f8, s_a8, ENERGY_TIE_TOL))
        del spread, Xs
        check(s_auto_route == "full scan" and s_forced_route == "banded" and s_a8_route == "banded",
              f"energy: spread index routes auto {s_auto_route}, forced {s_forced_route}, "
              f"auto B=8 {s_a8_route}")
        check(not any(spread_bad.values()),
              f"energy: banded vs full scan on the spread index: { {k: v[:2] for k, v in spread_bad.items()} }")

        # -- energy-mode search_batch through the kernels -------------------
        alphas = torch.full((BATCH,), ALPHA, dtype=torch.float32, device=dev)
        tier_counts, tier_info = {}, {}
        cand = aspace._int8_cand(K, None)
        ts_r = so.DEFAULT_TILE // so.RESCORE_SUBS
        n0 = (N_ENERGY // so.DEFAULT_TILE) * so.DEFAULT_TILE
        c_r = min((n0 // so.DEFAULT_TILE) * so.RESCORE_SUBS, max(K + so.SELECT_MARGIN, -(-cand // ts_r)))
        Xt, norms, lams = aspace.data, aspace.norms, aspace.lambdas
        for tier in (False, "bf16x3_rescored"):
            torch.cuda.synchronize()
            kernels.reset_launches()
            ms, outs = over(lambda r: aspace.search_batch(X[r], gl, k=K, alpha=ALPHA, quantized=tier,
                                                          return_raw=True), batches)
            counts = tier_counts["exact" if tier is False else tier] = kernels.launch_counts()
            score_err, self_found, plain_bad, sel_differs, sel_unexplained = 0.0, 0, [], 0, []
            for r, (idx, sc, raw) in zip(batches, outs):
                check(idx.shape == (BATCH, K) and np.all(np.isfinite(sc)), f"energy {tier}: bad output")
                rt = torch.from_numpy(r).to(dev)
                Q, ql = Xt[rt], torch.from_numpy(raw).to(dev)
                check(torch.equal(ql, aspace._nearest_subcentroid_lambdas(aspace._energy_query(Q))),
                      f"energy {tier}: the query λ is not the nearest sub-centroid's")
                ids = torch.from_numpy(idx).to(dev)
                qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
                ex = tmk.blend(torch.sum(Xt[ids] * Q[:, None, :], dim=-1), norms[ids] * qn[:, None],
                               lams[ids], ql[:, None], ALPHA)
                score_err = max(score_err, float((torch.from_numpy(sc).to(dev) - ex).abs().max()))
                self_found += sum(int(r[b] in idx[b]) for b in range(BATCH))
                if tier is False:
                    top_p, idx_p = so.fused_tilemax(
                        Xt, norms, lams, Q, ql, K + 1, alphas, so.DEFAULT_TILE,
                        producer=tmk.scores_and_tilemax_plain, gather=tmk.gather_subtiles_plain,
                        select=tmk.select_topk_plain)
                    plain_bad += topk_mismatches(idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, TOL_SCORE)
                    continue
                pidx, ptop = so.fused_scan_rescored(
                    Xt, Xt, norms, lams, Q, ql, K, cand, alphas,
                    producer=rsk.tilemax_only_plain, slab_reader=rsk.slab_dots_plain)
                mk = rsk.tilemax_only(Xt, norms, lams, Q, ql, alphas, subs=so.RESCORE_SUBS)
                mp = rsk.tilemax_only_plain(Xt, norms, lams, Q, ql, alphas, subs=so.RESCORE_SUBS)
                sel_k = torch.sort(so.topk_stable(mk, c_r)[1], dim=1).values
                top_m, sel_p = so.topk_stable(mp, c_r + 1)
                sel_p = torch.sort(sel_p[:, :c_r], dim=1).values
                same = torch.all(sel_k == sel_p, dim=1).cpu().numpy()
                gap = (top_m[:, c_r - 1] - top_m[:, c_r]).abs().cpu().numpy()
                sel_differs += int((~same).sum())
                sel_unexplained += [int(r[b]) for b in np.nonzero(~same & (gap > TOL_SCORE))[0]]
                plain_bad += same_k_mismatches(pidx.cpu().numpy()[same], ptop.cpu().numpy()[same],
                                               idx[same], sc[same], TOL_SCORE)
            name = "exact" if tier is False else tier
            tier_info[name] = dict(
                **timing(ms), launches=counts, max_score_err=score_err,
                self_retrieval_at_10=self_found / (BATCH * len(batches)),
                plain_route_mismatches=plain_bad[:5], slab_selection_differs_rows=sel_differs,
                profile=profiled(lambda r: aspace.search_batch(X[r], gl, k=K, alpha=ALPHA,
                                                               quantized=tier), batches[1:]))
            check(score_err <= TOL_SCORE, f"energy {name}: returned scores off by {score_err}")
            check(not plain_bad, f"energy {name}: kernel vs plain route: {plain_bad[:3]}")
            check(not sel_unexplained, f"energy {name}: slab selection differs without a near tie: {sel_unexplained[:5]}")
        for kname in ("scores_tilemax", "subtile_topk"):
            check(tier_counts["exact"][kname] > 0, f"energy: kernel {kname} not launched on the exact tier")
        for kname in ("tilemax_only", "slab_dots"):
            check(tier_counts["bf16x3_rescored"][kname] > 0, f"energy: kernel {kname} not launched on bf16x3_rescored")
        scan_profile = profiled(scan(aspace, X), batches[1:])

        # -- energy checkpoint (a 100,000-row build of the same fixture) -----
        if importlib.util.find_spec("pyarrow") is None:
            ckpt = dict(pyarrow="absent")
        else:
            from matternet_rs_tpu_torch.storage import parquet as spq

            Xc = make_energy_test_dataset(N_ENERGY_CKPT, F_MAIN, seed=SEED_ENERGY).astype(np.float32)
            cb = make_builder(N_ENERGY_CKPT).with_expected_items(N_ENERGY_CKPT).with_dims_reduction(True)
            (ca, cgl), cbuild_s = timed(lambda: cb.build_energy(Xc))
            rc = np.random.default_rng(13).choice(N_ENERGY_CKPT, BATCH, replace=False)

            def searches(sp, sgl):
                return (*em.search_energy_batch(sp, Xc[rc], sgl, K),
                        *sp.search_batch(Xc[rc], sgl, k=K, alpha=ALPHA))

            before = searches(ca, cgl)
            with tempfile.TemporaryDirectory(prefix="mrs-energy-ckpt-") as tmp:
                _, save_s = timed(lambda: spq.save_checkpoint(ca, cgl, cb, tmp, "energy"))
                disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
                (ra, rgl), load_s = timed(lambda: spq.load_arrowspace(tmp, "energy", device=dev))
            after = searches(ra, rgl)
            bit_equal = all(np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                           b.view(np.int32) if b.dtype == np.float32 else b)
                            for a, b in zip(before, after))
            state_equal = bool(
                rgl.energy and torch.equal(ra.sub_centroids, ca.sub_centroids)
                and np.array_equal(ra.subcentroid_lambdas, ca.subcentroid_lambdas)
                and np.array_equal(ra.centroid_map, ca.centroid_map)
                and torch.equal(ra.item_norms, ca.item_norms))
            ckpt = dict(pyarrow="present", n=N_ENERGY_CKPT, build_seconds=cbuild_s,
                        n_subcentroids=int(ca.sub_centroids.shape[0]), save_seconds=save_s,
                        load_seconds=load_s, bytes_on_disk=disk, searches_bit_equal=bit_equal,
                        energy_state_equal=state_equal,
                        cut="100,000 rows of the 1M fixture, for the run's time limit")
            check(bit_equal and state_equal, "energy: the reloaded checkpoint does not search bit for bit")
            del ca, cgl, ra, rgl, Xc

        # -- an energy store of the 1M index, streamed and on the sketch -----
        with tempfile.TemporaryDirectory(prefix="mrs-energy-store-") as sdir:
            sdir = Path(sdir)

            def write_store():
                """The layout of the reference's ShardedArrowSpace.to_store."""
                shards.write_shards(X, sdir)
                raw = aspace.min_lambdas + aspace.lambdas.double() * aspace.range_lambdas
                (sdir / sti.LAMBDA_FILE).write_bytes(raw.float().cpu().numpy().tobytes())
                sti.StreamingIndex(
                    directory=sdir,
                    gl=GraphLaplacian(matrix=gl.matrix, init_data=gl.init_data, nnodes=gl.nnodes,
                                      graph_params=gl.graph_params),
                    taumode=aspace.taumode, min_lambdas=aspace.min_lambdas,
                    range_lambdas=aspace.range_lambdas, n_items=aspace.nitems,
                    n_features=aspace.nfeatures, sub_centroids=aspace.sub_centroids.cpu().numpy(),
                    subcentroid_lambdas=aspace.subcentroid_lambdas, projection=aspace.projection,
                    device=dev)._save_meta()

            _, write_s = timed(write_store)
            sidx, load_s = timed(lambda: sti.StreamingIndex.load(sdir, device=dev))
            st_ms, st_out = over(lambda r: sidx.search_energy_batch(X[r], K), batches)
            _, sketch_s = timed(lambda: sidx.build_sketch(persist=False))
            sk_ms, sk_out = over(lambda r: sidx.search_energy_batch_sketch(X[r], K, refine=True), batches)
            # The store's λ as the index normalises them, against the in-memory λ.
            raw32 = torch.from_numpy(np.fromfile(sdir / sti.LAMBDA_FILE, np.float32)).to(dev)
            lam_store = torch.clamp((raw32 - sidx.min_lambdas) / sidx.range_lambdas, 0.0, 1.0)
            d_lam = float((lam_store.double() - aspace.lambdas.double()).abs().max())
            tol_st = energy_store_tolerance(lam_store.cpu().numpy(), aspace.lambdas.cpu().numpy())
            # The sketch's cosine is within δ of the exact one (int8 rows,
            # bf16 queries), so its refined top-k may trade items whose
            # exact cosines lie within 2δ.
            maxabs = torch.amax(torch.abs(aspace.data), dim=1)
            delta = float(torch.max((1 + 2 ** -9) * F_MAIN ** 0.5 * maxabs / 254.0
                                    / torch.clamp(aspace.item_norms, min=1e-12))) + 2 ** -9 + 1e-6
            tol_sk = tol_st + 1e-9 * 2 * delta
            store_bad = dict(streamed=mismatches(full_out, st_out, tol_st),
                             sketch=mismatches(full_out, sk_out, tol_sk))

            def recall(outs):
                return float(np.mean([len(set(a[0][b].tolist()) & set(g[0][b].tolist())) / K
                                      for a, g in zip(full_out[1:], outs[1:]) for b in range(BATCH)]))

            store = dict(
                bytes=int(X.nbytes), write_seconds=write_s, load_seconds=load_s,
                streamed=dict(**timing(st_ms), recall_at_10=recall(st_out)),
                sketch_seconds=sketch_s, sketch_refined=dict(**timing(sk_ms), recall_at_10=recall(sk_out)),
                lambda_round_trip_max=d_lam, tolerance_streamed=tol_st, sketch_cosine_bound=delta,
                tolerance_sketch=tol_sk, mismatches={k: v[:3] for k, v in store_bad.items()})
            del sidx
        check(not any(store_bad.values()),
              f"energy: the port-built store vs the in-memory scan: { {k: v[:2] for k, v in store_bad.items()} }")
    finally:
        em._banded_search = banded

    emit(phase="energy", n=N_ENERGY, f=F_MAIN, seed=SEED_ENERGY, card=card,
         build_seconds=build_s, stage_seconds=builder.last_stage_timings, build_launches=build_counts,
         n_clusters=aspace.n_clusters, projection=aspace.projection is not None,
         n_subcentroids=n_sub, max_lambda_tie_group=tie, largest_groups=group_sizes[:5].tolist(),
         empty_subcentroids=int((group_sizes == 0).sum()),
         full_scan=dict(**timing(full_ms), route=full_route, self_retrieval_at_10=self_hits),
         auto_b256=dict(**timing(auto_ms), route=auto_route),
         forced_window=dict(candidates=forced, **timing(forced_ms), route=forced_route),
         full_scan_b8=timing(f8_ms), auto_b8=dict(**timing(a8_ms), route=a8_route),
         serial=dict(calls=N_ENERGY_SERIAL, ms_median=statistics.median(serial_ms[1:]), ms=serial_ms),
         spread_index=dict(source="bench.py bench_energy_banded_1m", n_subcentroids=SPREAD_SUBCENTROIDS,
                           max_lambda_tie_group=tie_s, full_scan=timing(s_full_ms),
                           auto_b256=dict(**timing(s_auto_ms), route=s_auto_route),
                           forced_window=dict(candidates=tie_s + K, **timing(s_forced_ms),
                                              route=s_forced_route),
                           full_scan_b8=timing(s_f8_ms),
                           auto_b8=dict(**timing(s_a8_ms), route=s_a8_route)),
         search_batch=tier_info, scan_profile=scan_profile, checkpoint=ckpt, store=store)
    del aspace, gl, X
    torch.cuda.empty_cache()
    return tier_counts


def _timed_call(fn):
    """``fn()`` between two synchronisations: its output and seconds."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _blended(sp, Q, ql, ids):
    """Full-f32 blended scores of rows ``ids [B, k]`` of ``sp`` for queries
    ``Q [B, F]`` with normalised λ ``ql [B]``."""
    import torch

    from matternet_rs_tpu_torch.ops.kernels.tilemax import blend

    dots = torch.sum(sp.data[ids] * Q[:, None, :], dim=-1)
    qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
    return blend(dots, sp.norms[ids] * qn[:, None], sp.lambdas[ids], ql[:, None], ALPHA)


def items_phase(dev, card, aspace, gl, X, batch_rows):
    """Phase 13, ``items`` (module docstring), on a shallow copy of phase
    main's index: every mutation assigns new tensors to the copy, so the
    original is left as it was. Returns the launches by step."""
    import copy

    import numpy as np
    import torch

    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import taumode as tmo
    from matternet_rs_tpu_torch.ops.kernels import taumode as tk

    sp = copy.copy(aspace)
    L = gl.matrix.contiguous()
    rng = np.random.default_rng(SEED_ITEMS)
    r, s, a, b = (int(v) for v in rng.choice(N_MAIN, 4, replace=False))
    counts, seconds, checks = {}, {}, {}

    def step(name, fn):
        kernels.reset_launches()
        out, seconds[name] = _timed_call(fn)
        counts[name] = kernels.launch_counts()
        return out

    def lam_gap(Xk, lam_norm):
        """Largest gap of the stored λ (back in raw units) to kernel A's
        plain version on the same rows, over max(|λ|, 1)."""
        ref = tk.taumode_lambdas_plain(Xk, L, tmo.select_tau(Xk, tmo.TAU_MEDIAN))
        raw = lam_norm * sp.range_lambdas + sp.min_lambdas
        return float(((raw - ref).abs() / torch.clamp(ref.abs(), min=1.0)).max())

    row, lam = sp.get_item(r)
    checks["get_item"] = bool(np.array_equal(row, X[r])) and lam == float(aspace.lambdas[r])
    c_r = sp.cluster_of(r)
    checks["cluster_of"] = c_r == (None if aspace.cluster_assignments[r] < 0
                                   else int(aspace.cluster_assignments[r]))

    # The tiers first build their caches on the copy (norms, int8 sketch),
    # then row r becomes 1.5 × row s.
    Q0 = X[batch_rows]
    for tier in ITEM_TIERS:
        sp.search_batch(Q0, gl, k=K, alpha=ALPHA, quantized=tier)
    step("set_item", lambda: sp.set_item(r, X[s] * np.float32(1.5)))
    checks["set_item_cleared_caches"] = sp._norms is None and sp._i8_pair is None and sp._data_bf16 is None
    step("recompute_lambdas", lambda: sp.recompute_lambdas(gl))
    gaps = {"recompute_lambdas": lam_gap(sp.data, sp.lambdas)}
    Q = np.concatenate([(X[s] * np.float32(1.5))[None], Q0[1:]])
    tiers = {}
    for tier in ITEM_TIERS:
        name = "exact" if tier is False else tier
        idx, sc, raw = step(name, lambda: sp.search_batch(Q, gl, k=K, alpha=ALPHA, quantized=tier,
                                                          return_raw=True))
        Qt = torch.from_numpy(Q).to(dev)
        ql = torch.clamp((torch.from_numpy(raw).to(dev) - sp.min_lambdas) / sp.range_lambdas, 0, 1)
        own = float(_blended(sp, Qt[:1], ql[:1], torch.tensor([[r]], device=dev))[0, 0])
        got = float(sc[0, list(idx[0]).index(r)]) if r in idx[0] else None
        exact = _blended(sp, Qt, ql, torch.from_numpy(idx).to(dev)).cpu().numpy()
        tiers[name] = dict(seconds=seconds[name], launches=counts[name], new_row_found=got is not None,
                           new_row_score=got, new_row_exact_score=own,
                           max_score_err=float(np.abs(exact - sc).max()))
        check(got is not None and abs(got - own) <= TOL_SCORE,
              f"items {name}: the mutated row {r} is not served with its exact score ({got} vs {own})")
        check(tiers[name]["max_score_err"] <= TOL_SCORE, f"items {name}: scores are not the exact blend")
    for kname, tier in (("scores_tilemax", "exact"), ("subtile_topk", "exact"),
                        ("tilemax_only", "int8_rescored"), ("slab_dots", "int8_rescored"),
                        ("tilemax_only", "bf16x3_rescored"), ("slab_dots", "bf16x3_rescored")):
        check(counts[tier][kname] == 1, f"items {tier}: kernel {kname} launched {counts[tier][kname]} times")

    for name, fn, want in (
        ("scale_item", lambda: sp.scale_item(a, 0.5, gl), X[a] * np.float32(0.5)),
        ("superpose_items", lambda: sp.superpose_items(a, b, gl), None),
        ("mul_items", lambda: sp.mul_items(b, a, gl), None),
    ):
        before_a, before_b = sp.data[a].clone(), sp.data[b].clone()
        step(name, fn)
        if name == "superpose_items":
            checks[name] = bool(torch.equal(sp.data[a], before_a + before_b))
        elif name == "mul_items":
            checks[name] = bool(torch.equal(sp.data[b], before_b * before_a))
        else:
            checks[name] = bool(np.array_equal(sp.data[a].cpu().numpy(), want))
        gaps[name] = lam_gap(sp.data, sp.lambdas)

    new = (X[rng.choice(N_MAIN, N_ITEMS_NEW, replace=False)]
           + rng.normal(0.0, 0.3, (N_ITEMS_NEW, F_MAIN))).astype(np.float32)
    n0 = sp.nitems
    step("add_items", lambda: sp.add_items(new, gl))
    lam_new = sp.lambdas[n0:]
    gaps["add_items"] = lam_gap(torch.from_numpy(new).to(dev), lam_new)
    checks["add_items_lambda_in_unit_interval"] = bool(float(lam_new.min()) >= 0.0
                                                      and float(lam_new.max()) <= 1.0)
    checks["add_items_rows"] = sp.nitems == n0 + N_ITEMS_NEW and bool(
        torch.equal(sp.data[n0:], torch.from_numpy(new).to(dev)))
    kernels.reset_launches()
    top1, missed = 0, []
    t0 = time.perf_counter()
    for st in range(0, N_ITEMS_NEW, BATCH):
        Qn = new[st:st + BATCH]
        idx, sc, raw = sp.search_batch(Qn, gl, k=K, alpha=ALPHA, return_raw=True)
        ids = np.arange(n0 + st, n0 + st + len(Qn))
        top1 += int((idx[:, 0] == ids).sum())
        Qt = torch.from_numpy(Qn).to(dev)
        ql = torch.clamp((torch.from_numpy(raw).to(dev) - sp.min_lambdas) / sp.range_lambdas, 0, 1)
        own = _blended(sp, Qt, ql, torch.from_numpy(ids).to(dev)[:, None])[:, 0].cpu().numpy()
        missed += [int(i) for j, i in enumerate(ids) if i not in idx[j] or sc[j, 0] < own[j] - TOL_SCORE]
    torch.cuda.synchronize()
    seconds["self_query"] = time.perf_counter() - t0
    counts["self_query"] = kernels.launch_counts()
    check(not missed, f"items: {len(missed)} appended rows miss their own top-{K}")
    for name in ("recompute_lambdas", "scale_item", "superpose_items", "mul_items", "add_items"):
        check(counts[name]["taumode"] == 1, f"items {name}: kernel A launched {counts[name]['taumode']} times")
        check(gaps[name] <= TOL_LAMBDA, f"items {name}: kernel A's λ beyond its contract ({gaps[name]})")
    check(all(checks.values()), f"items: failed checks {[k for k, v in checks.items() if not v]}")
    emit(phase="items", card=card, n=N_MAIN, f=F_MAIN, rows=dict(r=r, s=s, a=a, b=b),
         seconds=seconds, launches=counts, tiers_after_set_item=tiers,
         kernel_a_max_rel_gap=gaps, appended=N_ITEMS_NEW, n_after=sp.nitems,
         self_query=dict(batches=-(-N_ITEMS_NEW // BATCH), top1_hits=top1, missed=missed[:10]),
         checks=checks)
    return counts


def lambda_search_phase(dev, card, aspace, gl, X, batches, exact_ids):
    """Phase 14, ``lambda_search`` (module docstring), on phase main's
    index. Returns the phase's launches (the query λ and the exact tier it
    compares with)."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch.index import ivf as ivf_mod
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.utils.parity import same_k_mismatches, topk_mismatches

    kernels.reset_launches()
    ivf, build_s = _timed_call(lambda: aspace.build_ivf_index())
    nb = ivf.n_buckets

    def over(nprobe, rows):
        ms, outs = [], []
        for r in rows:
            out, sec = _timed_call(lambda: aspace.search_batch_ivf(X[r], gl, K, alpha=ALPHA, nprobe=nprobe))
            ms.append(sec * 1e3)
            outs.append(out)
        return ms, outs

    def gather_bytes(nprobe):
        p = min(nprobe, nb) * ivf.bucket_size
        return ivf_mod.gather_block_queries(p, F_MAIN) * p * F_MAIN * 4

    ms8, outs8 = over(IVF_NPROBE, batches)
    hits = sum(len(set(i) & set(e)) for (idx, _), ex in zip(outs8[1:], exact_ids[1:])
               for i, e in zip(idx, ex))
    recall = hits / (len(outs8[1:]) * BATCH * K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    msf, outsf = over(nb, batches[1:2])
    peak_full = torch.cuda.max_memory_allocated(dev) - base
    ref_i, ref_s = aspace.search_batch(X[batches[1]], gl, k=K + 1, alpha=ALPHA)
    full_bad = topk_mismatches(ref_i, ref_s, *outsf[0], TOL_SCORE)
    check(not full_bad, f"lambda_search: IVF at full probe differs from the exact tier: {full_bad[:3]}")
    ivf_info = dict(build_seconds=build_s, n_buckets=nb, bucket_size=ivf.bucket_size,
                    n_clusters=ivf.n_clusters,
                    nprobe8=dict(warmup_ms=ms8[0], ms_per_batch_median=statistics.median(ms8[1:]),
                                 ms_per_batch=ms8[1:], recall_at_10=recall,
                                 peak_gather_bytes=gather_bytes(IVF_NPROBE)),
                    full_probe=dict(nprobe=nb, ms=msf[0], peak_gather_bytes=gather_bytes(nb),
                                    peak_allocated_bytes=peak_full, mismatches=full_bad[:5]))

    # The other searches, 16 queries each, held against plain forms in
    # float64 on the card.
    rows16 = batches[1][:N_LAMBDA_QUERIES]
    X64 = aspace.data.double()
    n64 = torch.sqrt(torch.sum(X64 * X64, dim=1))
    lam32 = aspace.lambdas
    lam64 = lam32.double()
    sl = aspace.lambdas_sorted
    plain_bad, calls = {}, {}

    def blend64(cos, lam, q_lam):
        return ALPHA * cos + (1 - ALPHA) * (1 - torch.clamp(torch.abs(lam - q_lam), max=1.0))

    def cos64(Xr, nr, q):
        q64 = torch.from_numpy(q.astype(np.float64)).to(dev)
        d = Xr @ q64
        den = nr * torch.sqrt(torch.dot(q64, q64))
        return torch.where(den > 1e-12, d / torch.clamp(den, min=1e-12), torch.zeros_like(d))

    def hybrid64(q, q_lam):
        cos = cos64(X64, n64, q)
        score = blend64(cos, lam64, q_lam)
        in_top = torch.zeros_like(cos, dtype=torch.bool)
        in_top[so.topk_stable(score, K)[1]] = True
        high = cos > so.SEMANTIC_THRESHOLD
        top1 = torch.zeros_like(in_top)
        top1[torch.argmax(cos)] = True
        final = torch.where(high, cos, score)
        final = torch.where(top1 & ~high & ~in_top, cos, final)
        final = torch.where(in_top | high | top1, final, torch.full_like(final, -float("inf")))
        v, i = so.topk_stable(final, K)
        return i[None].cpu().numpy(), v[None].cpu().numpy()

    def banded64(q, q_lam):
        s_lam, s_idx = sl.sorted_lambdas_dev, sl.sorted_indices_dev
        w = min(BAND_WINDOW, s_lam.shape[0])
        pos = int(torch.searchsorted(s_lam, torch.tensor([q_lam], dtype=torch.float32, device=dev))[0])
        start = min(max(pos - w // 2, 0), s_lam.shape[0] - w)
        cand = s_idx[start:start + w]
        v, i = so.topk_stable(blend64(cos64(X64[cand], n64[cand], q), lam64[cand], q_lam), K)
        return cand[i][None].cpu().numpy(), v[None].cpu().numpy()

    def sorted_band(q_lam):
        """The band [λq − σ/2^p, λq + σ/2^p] (bounds in float32, as the
        index takes them), first k in (λ, id) order."""
        band = sl.std_dev / (2.0 ** gl.graph_params.p)
        lo, hi = np.float32(q_lam - band), np.float32(q_lam + band)
        ids = torch.nonzero((lam64 >= float(lo)) & (lam64 <= float(hi)))[:, 0]
        order = torch.sort(lam64[ids], stable=True)[1]
        return [(int(i), float(v)) for i, v in zip(ids[order][:K].cpu(), lam64[ids][order][:K].cpu())]

    def lists(res):
        return np.asarray([[i for i, _ in res]]), np.asarray([[v for _, v in res]])

    for name in ("hybrid", "banded", "linear_sorted", "k_nearest_by_lambda", "range"):
        plain_bad[name], calls[name] = [], []
    range_sizes = []
    for qi, r in enumerate(rows16):
        q = X[r]
        q_lam = aspace.prepare_query_item(q, gl)
        res, sec = _timed_call(lambda: aspace.search_lambda_aware_hybrid(q, q_lam, K))
        calls["hybrid"].append(sec * 1e3)
        plain_bad["hybrid"] += same_k_mismatches(*hybrid64(q, q_lam), *lists(res), TOL_SCORE)
        res, sec = _timed_call(lambda: aspace.search_lambda_banded(q, q_lam, K, window=BAND_WINDOW))
        calls["banded"].append(sec * 1e3)
        plain_bad["banded"] += same_k_mismatches(*banded64(q, q_lam), *lists(res), TOL_SCORE)
        res, sec = _timed_call(lambda: aspace.search_linear_sorted(q, gl, K))
        calls["linear_sorted"].append(sec * 1e3)
        if res != sorted_band(q_lam):
            plain_bad["linear_sorted"].append(f"query {qi}")
        res, sec = _timed_call(lambda: aspace.search_k_nearest_by_lambda(q, gl, K))
        calls["k_nearest_by_lambda"].append(sec * 1e3)
        smallest = torch.sort(torch.abs(lam64 - q_lam))[0][:K].cpu().numpy()
        if len(res) != K or np.abs(np.asarray([abs(v - q_lam) for _, v in res]) - smallest).max() > 1e-12:
            plain_bad["k_nearest_by_lambda"].append(f"query {qi}")
        res, sec = _timed_call(lambda: aspace.range_search(q, q_lam, RANGE_EPS))
        calls["range"].append(sec * 1e3)
        dist = q_lam - lam64
        want = set(torch.nonzero(dist <= RANGE_EPS)[:, 0].cpu().tolist())
        got_ids = {i for i, _ in res}
        edge = set(torch.nonzero(torch.abs(dist - RANGE_EPS) <= 1e-6)[:, 0].cpu().tolist())
        range_sizes.append(len(res))
        if (want ^ got_ids) - edge:
            plain_bad["range"].append(f"query {qi}: {len((want ^ got_ids) - edge)} ids differ")
    counts = kernels.launch_counts()
    check(not any(plain_bad.values()),
          f"lambda_search: against the float64 forms { {k: v[:2] for k, v in plain_bad.items()} }")
    others = {name: dict(ms_per_call_median=statistics.median(ms[1:]), ms_per_call=ms)
              for name, ms in calls.items()}
    others["banded"]["window"] = BAND_WINDOW
    others["range"].update(eps=RANGE_EPS, mean_result_size=float(np.mean(range_sizes)))
    emit(phase="lambda_search", card=card, n=N_MAIN, f=F_MAIN, batch=BATCH, k=K, ivf=ivf_info,
         queries=N_LAMBDA_QUERIES, searches=others, launches=counts,
         plain_mismatches={k: v[:5] for k, v in plain_bad.items()})
    aspace.ivf = None
    return counts


def pipeline_phase(dev, card):
    """Phase 15, ``pipeline`` (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from matternet_rs_tpu_torch import pipeline
    from matternet_rs_tpu_torch.ops import distance as dist
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.pipeline import run as prun
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_hd

    t0 = time.perf_counter()
    X = make_gaussian_hd(N_PIPELINE, 0.3).astype(np.float32)
    gen_s = time.perf_counter() - t0
    X64 = torch.from_numpy(X).to(dev).double()

    # The reference's default MST k = 8: stage A's force-assignment leaves
    # a few thick centroids (far rows absorbed) whose nearest are one
    # another, and Prim from node 0 misses them.
    a_out = pipeline.ClusteringStage(pipeline.ClusteringConfig(max_clusters=PIPELINE_CAPS[1]),
                                     dev).execute(X)
    b0 = pipeline.PreflightStage().execute(a_out.state)
    st = pipeline.CentroidState(b0.normalized_centroids, b0.variances, a_out.state.counts)
    mst8 = pipeline.MSTStage(pipeline.MSTConfig()).execute(st)
    default_k = dict(k=pipeline.MSTConfig().k_neighbors, cap=PIPELINE_CAPS[1],
                     nodes_in_mst=mst8.nodes_in_mst, order_length=len(mst8.centroid_order),
                     n_centroids=st.num_centroids,
                     thick_centroids=int((st.get_thickness() > 1.0).sum()),
                     thickness_max=float(st.get_thickness().max()))
    del a_out, b0, st, mst8

    def lam_float64(res):
        """Stage D recomputed in float64 on the card from the port's L."""
        L64 = res.laplacian.matrix.double()
        XL = X64 @ L64.T
        x_sq = X64 * X64
        ray = torch.clamp((X64 * XL).sum(-1) / (x_sq.sum(-1) + 1e-9), -1e6, 1e6)
        W = torch.clamp(-L64, min=0.0)
        e = torch.clamp(W.sum(1)[None] * x_sq - 2 * X64 * (X64 @ W.T) + x_sq @ W.T, min=0.0).sum(-1)
        return (ray + torch.clamp(e / (e.sum() + 1e-12), 0.0, 1.0)).cpu().numpy()

    runs = {}
    for cap in PIPELINE_CAPS:
        config = pipeline.PipelineConfig(clustering=pipeline.ClusteringConfig(max_clusters=cap),
                                         mst=pipeline.MSTConfig(k_neighbors=PIPELINE_MST_K))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        kernels.reset_launches()
        res, build_s = _timed_call(lambda: pipeline.build(X, config))
        counts = kernels.launch_counts()
        build_peak = torch.cuda.max_memory_allocated(dev) - base
        c = res.state.num_centroids
        lam_gap = float(np.max(np.abs(res.lambdas - lam_float64(res))
                               / np.maximum(np.abs(res.lambdas), 1.0)))
        # Stage C's least Bhattacharyya distance between two features'
        # profiles: the graph keeps an edge only below ln(1e9) ≈ 20.7.
        Df = dist.bhattacharyya_pairwise(res.state.to_feature_nodes().contiguous(),
                                         res.state.get_feature_variances().contiguous(),
                                         var_floor=pipeline.LaplacianConfig().variance_regularizer)
        Df.fill_diagonal_(float("inf"))
        Lm = res.laplacian.matrix
        sym_gap = float((Lm - Lm.T).abs().max())
        Lu = pipeline.LaplacianStage(pipeline.LaplacianConfig(normalize=False)).execute(res.state).matrix
        rowsum_gap = float(Lu.sum(1).abs().max())
        with tempfile.TemporaryDirectory() as tmp:
            (_, save_s) = _timed_call(lambda: prun.save_result(res, tmp, "pipeline"))
            back, load_s = _timed_call(lambda: prun.load_result_arrays(tmp, "pipeline"))
        round_trip = dict(
            means=bool(np.array_equal(back["means"], res.state.means.cpu().numpy().astype(np.float64))),
            variances=bool(np.array_equal(back["variances"],
                                          res.state.variances.cpu().numpy().astype(np.float64))),
            laplacian=bool(np.array_equal(back["laplacian"], Lm.cpu().numpy().astype(np.float64))),
            lambdas=bool(np.array_equal(back["lambdas"], res.lambdas)),
            order=bool(np.array_equal(back["order"], res.mst.centroid_order)))
        run = dict(cap=cap, mst_k=PIPELINE_MST_K, build_seconds=build_s, stage_seconds=res.timings,
                   n_centroids=c, nodes_in_mst=res.mst.nodes_in_mst,
                   trunk_length=int(len(res.mst.trunk_nodes)), tau=res.tau,
                   laplacian_nnz=res.laplacian.nnz, feature_pair_min_distance=float(Df.min()),
                   lambda_quantiles=[float(np.quantile(res.lambdas, q)) for q in (0, 0.5, 1)],
                   variance_reduction=res.kalman.variance_reduction,
                   lambda_max_rel_gap_vs_float64=lam_gap, build_peak_allocated_bytes=build_peak,
                   l_symmetry_gap=sym_gap, unnormalised_row_sum_gap=rowsum_gap,
                   save_seconds=save_s, load_seconds=load_s, round_trip=round_trip, launches=counts)
        tag = f"pipeline cap={cap}"
        check(res.mst.nodes_in_mst == c, f"{tag}: the MST reaches {res.mst.nodes_in_mst} of {c} centroids")
        check(np.all(np.isfinite(res.lambdas)) and res.lambdas.shape == (N_PIPELINE,), f"{tag}: bad λ")
        check(lam_gap <= TOL_LAMBDA, f"{tag}: stage D λ vs float64 {lam_gap}")
        check(res.tau == pipeline.compute_tau(res.lambdas, pipeline.TauMode.median()),
              f"{tag}: τ is not the median of λ")
        # W is symmetric exactly; the normalised L only up to the order of
        # its two scalings.
        check(sym_gap <= 1e-6 and float((Lu - Lu.T).abs().max()) == 0.0,
              f"{tag}: L is not symmetric ({sym_gap})")
        check(rowsum_gap <= 1e-5 * max(1.0, float(Lu.diagonal().abs().max())),
              f"{tag}: unnormalised L row sums {rowsum_gap}")
        check(all(round_trip.values()), f"{tag}: save/load not bit for bit {round_trip}")
        check(not any(counts.values()), f"{tag}: a kernel launched {counts}")
        if cap == PIPELINE_CAPS[0]:
            # The tiled pass at full size: its peak alone, and a block of
            # 256 rows against the untiled float64 form.
            mu, var = res.state.means, res.state.variances
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            D, pass_s = _timed_call(lambda: dist.bhattacharyya_pairwise(mu, var))
            pass_peak = torch.cuda.max_memory_allocated(dev) - base
            va = torch.clamp(var[:256, None].double(), min=dist.VAR_FLOOR)
            vb = torch.clamp(var[None].double(), min=dist.VAR_FLOOR)
            vbar = 0.5 * (va + vb)
            diff = mu[:256, None].double() - mu[None].double()
            m_terms = diff * diff / vbar
            D64 = 0.125 * m_terms.sum(-1) + 0.5 * (
                torch.log(vbar) - 0.5 * (torch.log(va) + torch.log(vb))).sum(-1)
            # Relative to the summands' magnitude: the log terms cancel (a
            # pair of near centroids has D ≪ Σ|terms|), in float32 as in
            # the reference.
            scale = 0.125 * m_terms.sum(-1) + 0.5 * (torch.log(vbar).abs() + 0.5 * (
                torch.log(va).abs() + torch.log(vb).abs())).sum(-1)
            pass_gap = float(((D[:256].double() - D64).abs() / torch.clamp(scale, min=1.0)).max())
            check(pass_gap <= TOL_LAMBDA, f"{tag}: tiled Bhattacharyya vs float64 {pass_gap}")
            run["bhattacharyya"] = dict(seconds=pass_s, peak_allocated_bytes=pass_peak,
                                        untiled_intermediate_bytes=4 * c * c * mu.shape[1],
                                        max_rel_gap_vs_float64_256_rows=pass_gap)
            del D, D64, diff, vbar, va, vb, m_terms, scale
        else:
            check(res.laplacian.nnz > 0 and res.tau > pipeline.taumode.TAU_FLOOR,
                  f"{tag}: the feature graph is empty (nnz {res.laplacian.nnz}, τ {res.tau})")
        runs[str(cap)] = run
        del res, Df, Lm, Lu
    emit(phase="pipeline", card=card, n=N_PIPELINE, f=X.shape[1],
         fixture="make_gaussian_hd(200_000, 0.3) (test_data.rs:118-192)",
         cut="N = 200,000 rather than 1M: stage A is the host scan",
         config=f"PipelineConfig(clustering=ClusteringConfig(max_clusters=cap), "
                f"mst=MSTConfig(k_neighbors={PIPELINE_MST_K})), the rest default",
         data_seconds=gen_s, default_k=default_k, runs=runs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import logging

    import importlib.util
    import tempfile

    from matternet_rs_tpu_torch import ArrowSpace, ArrowSpaceBuilder, GraphParams, buildcache, core, native
    from matternet_rs_tpu_torch import clustering as clus
    from matternet_rs_tpu_torch import prng
    from matternet_rs_tpu_torch.storage import shards
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
    specs = _cuda.specs() + [sp for sp in (native.spec(), native.shard_reader_spec()) if sp]
    buildcache.build(specs)
    _cuda.build_all()
    check(native.get_lib() is not None, "native clustering library did not load")
    check(native.get_shard_lib() is not None, "native shard reader did not load")
    ptxas = [
        line.strip() for log in buildcache.BUILD_LOG.values()
        for line in log.splitlines() if "registers" in line or "spill" in line
    ]
    emit(phase="build", seconds=time.perf_counter() - t0, card=card, ptxas=ptxas)

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
            select=tmk.select_topk_plain,
        )
        plain_mismatch += topk_mismatches(
            idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, TOL_SCORE
        )
    check(not self_fail, f"{len(self_fail)} queries miss their own row")
    check(not plain_mismatch, f"kernel vs plain route: {plain_mismatch[:3]}")
    for kname in ("taumode", "scores_tilemax", "subtile_topk"):
        check(main_counts[kname] > 0, f"kernel {kname} not launched on the main path")
    check(main_counts["subtile_topk"] == len(batches) and main_counts["gather_subtiles"] == 0,
          f"k={K}: the candidate stage must launch once a batch and kernel C never: {main_counts}")

    def traced(search, items=None):
        """:func:`profiled` over the timed batches, or ``items``."""
        return profiled(search, batches[1:] if items is None else items)

    # The exact tier's candidate stage against the selection chain it
    # replaced (kernel C's gather, the stable sorts), the same timed batches
    # in turns: stage, chain, chain, stage; then a profiled pass of each.
    def exact_search(route):
        def search(r):
            return aspace.search_batch(X[r], gl, k=K, alpha=ALPHA)
        if route == "stage":
            return search
        chain = functools.partial(fused_tilemax, select=tmk.select_topk_plain)

        def via_chain(r):
            so.fused_tilemax = chain
            try:
                return search(r)
            finally:
                so.fused_tilemax = fused_tilemax
        return via_chain

    fused_tilemax = so.fused_tilemax
    turns = {"stage": [], "chain": []}
    for route in ("stage", "chain", "chain", "stage"):
        search = exact_search(route)
        for r in batches[1:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            search(r)
            torch.cuda.synchronize()
            turns[route].append((time.perf_counter() - t1) * 1e3)
    stage_vs_chain = {route: dict(search_ms_per_batch_median=statistics.median(ms), search_ms_per_batch=ms,
                                  profile=traced(exact_search(route)))
                      for route, ms in turns.items()}
    for route in stage_vs_chain.values():
        route["profile"].pop("top_kernels")

    # Kernel C's path: k > 16 keeps the selection chain with kernel C.
    kernels.reset_launches()
    k40 = aspace.search_batch(X[batches[1]], gl, k=K_CHAIN, alpha=ALPHA)
    k40_counts = kernels.launch_counts()
    check(k40[0].shape == (BATCH, K_CHAIN) and np.array_equal(k40[0][:, :K], results[1][1]),
          f"k={K_CHAIN}: the first {K} ids differ from the k={K} search's")
    check(k40_counts["gather_subtiles"] == 1 and k40_counts["subtile_topk"] == 0,
          f"k={K_CHAIN}: kernel C must launch once and the candidate stage never: {k40_counts}")
    emit(phase="main", n=N_MAIN, f=F_MAIN, batch=BATCH, k=K, card=card,
         build_seconds=build_s, stage_seconds=builder.last_stage_timings,
         n_clusters=aspace.n_clusters, warmup_ms=batch_ms[0],
         search_ms_per_batch_median=statistics.median(batch_ms[1:]),
         search_ms_per_batch=batch_ms[1:], launches=main_counts,
         self_query_failures=self_fail[:10], plain_route_mismatches=plain_mismatch[:10],
         candidate_stage_vs_chain=stage_vs_chain, launches_at_k40=k40_counts)

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


    # -- 7. heuristics: the builder's default k on the headline data -------
    def bit_equal(a, b):
        """Same shape and the same float32 bits (NaN, inf and ±0 included)."""
        return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def blended(sp, Q, ql, ids):
        """f32 blended scores of rows ``ids [B, k]`` of space ``sp``."""
        dots = torch.sum(sp.data[ids] * Q[:, None, :], dim=-1)
        qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
        return tmk.blend(dots, sp.norms[ids] * qn[:, None], sp.lambdas[ids], ql[:, None], ALPHA)

    def search_batches(sp, sgl, Xh, batch_rows):
        """``search_batch`` over the batches (the first a warm-up): ms per
        batch, the outputs, the raw query λ, and the queries that miss
        their own row."""
        ms, outs, raws, missed = [], [], [], 0
        for r in batch_rows:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            idx, sc, raw = sp.search_batch(Xh[r], sgl, k=K, alpha=ALPHA, return_raw=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            check(idx.shape == (BATCH, K) and np.all(np.isfinite(sc)), "bad search output")
            missed += sum(int(r[b] not in idx[b]) for b in range(BATCH))
            outs.append((idx, sc))
            raws.append(raw)
        return ms, outs, raws, missed

    def checked_search(sp, sgl, Xh, batch_rows):
        """:func:`search_batches` plus the exact-score check and the plain
        route (the kernels' plain versions) under the near-tie rule."""
        ms, outs, raws, missed = search_batches(sp, sgl, Xh, batch_rows)
        mn_s = torch.tensor(sp.min_lambdas, device=dev)
        rg_s = torch.tensor(sp.range_lambdas, device=dev)
        score_err, plain_bad = 0.0, []
        for r, (idx, sc), raw in zip(batch_rows, outs, raws):
            Q = sp.data[torch.from_numpy(r).to(dev)]
            ql = torch.clamp((torch.from_numpy(raw).to(dev) - mn_s) / rg_s, 0.0, 1.0)
            ex = blended(sp, Q, ql, torch.from_numpy(idx).to(dev))
            score_err = max(score_err, float((torch.from_numpy(sc).to(dev) - ex).abs().max()))
            top_p, idx_p = so.fused_tilemax(
                sp.data, sp.norms, sp.lambdas, Q, ql, K + 1, alphas, so.DEFAULT_TILE,
                producer=tmk.scores_and_tilemax_plain, gather=tmk.gather_subtiles_plain,
                select=tmk.select_topk_plain,
            )
            plain_bad += topk_mismatches(idx_p.cpu().numpy(), top_p.cpu().numpy(), idx, sc, TOL_SCORE)
        return ms, outs, dict(self_query_failures=missed, max_score_err=score_err,
                              plain_route_mismatches=plain_bad[:10])

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    path_counts = {}          # launches of each new path, by phase
    (k_opt, radius, id_est), heur_s = timed(lambda: clus.compute_optimal_k(Xt, SEED_HEURISTICS))
    (k_min, k_max, _), bounds_s = timed(lambda: clus.step1_bounds(Xt, SEED_HEURISTICS))
    sample = np.random.default_rng(SEED_HEURISTICS).permutation(N_MAIN)[:1000]
    Xs = torch.from_numpy(X[sample]).to(dev)
    k0, omu = clus.kmeanspp_uniforms(SEED_HEURISTICS, k_opt)
    first = int(prng.randint(k0, (), 0, Xs.shape[0]))
    omu_t = torch.from_numpy(omu).to(dev)
    draws_s = timed(lambda: clus.kmeanspp_uniforms(SEED_HEURISTICS, k_opt))[1]
    # The k-means++ loop and Lloyd's iterations read nothing back from the
    # card: any synchronising call in them raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        init = clus.kmeanspp_steps(Xs, first, omu_t)
        enqueue_pp_s = time.perf_counter() - t
        clus.lloyd(Xs, init, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    init, kpp_s = timed(lambda: clus.kmeanspp_steps(Xs, first, omu_t))
    _, lloyd_s = timed(lambda: clus.lloyd(Xs, init, 20))
    hbuilder = (ArrowSpaceBuilder().with_lambda_graph(1.0, 6).with_sparsity_check(False)
                .with_sampling(None).with_seed(SEED_HEURISTICS))
    torch.cuda.synchronize()
    kernels.reset_launches()
    (haspace, hgl), hbuild_s = timed(lambda: hbuilder.build(X))
    hms, _, _, hmissed = search_batches(haspace, hgl, X, batches)
    path_counts["heuristics"] = kernels.launch_counts()
    emit(phase="heuristics", n=N_MAIN, f=F_MAIN, card=card, seed=SEED_HEURISTICS,
         k_min=k_min, k_max=k_max, intrinsic_dim=id_est, k_opt=k_opt, radius=radius,
         compute_optimal_k_seconds=heur_s, bounds_seconds=bounds_s,
         kmeanspp_host_draws_seconds=draws_s, kmeanspp_seconds=kpp_s,
         kmeanspp_enqueue_seconds=enqueue_pp_s, lloyd_20_iters_seconds=lloyd_s,
         build_seconds=hbuild_s, stage_seconds=hbuilder.last_stage_timings,
         build_k=hbuilder.cluster_max_clusters, build_radius=hbuilder.cluster_radius,
         n_clusters=haspace.n_clusters, warmup_ms=hms[0],
         search_ms_per_batch_median=statistics.median(hms[1:]), search_ms_per_batch=hms[1:],
         self_query_failures=hmissed, launches=path_counts["heuristics"])
    check(hbuilder.cluster_max_clusters == k_opt and hbuilder.cluster_radius == radius,
          f"heuristics: the build took k={hbuilder.cluster_max_clusters}, radius="
          f"{hbuilder.cluster_radius}, not {k_opt}, {radius}")
    check(k_min <= k_opt <= k_max, f"heuristics: k={k_opt} outside [{k_min}, {k_max}]")
    check(np.all(np.isfinite(haspace.lambdas.cpu().numpy())), "heuristics: non-finite λ")
    check(hmissed == 0, f"heuristics: {hmissed} queries miss their own row")
    for kname in ("taumode", "scores_tilemax", "subtile_topk"):
        check(path_counts["heuristics"][kname] > 0, f"heuristics: kernel {kname} not launched")
    del haspace, hgl, Xs

    # -- 8. jl: the JL projection through the builder --------------------
    Xj = make_energy_test_dataset(N_JL, F_JL, seed=SEED_JL).astype(np.float32)
    jrows = np.random.default_rng(8).choice(N_JL, BATCH * (N_BATCHES + 1), replace=False)
    jbatches = jrows.reshape(N_BATCHES + 1, BATCH)
    jbuilder = make_builder(N_JL).with_dims_reduction(True).with_seed(SEED_HEURISTICS)
    torch.cuda.synchronize()
    kernels.reset_launches()
    (jaspace, jgl), jbuild_s = timed(lambda: jbuilder.build(Xj))
    jms, jouts, jchecks = checked_search(jaspace, jgl, Xj, jbatches)
    path_counts["jl"] = kernels.launch_counts()
    proj = jaspace.projection
    check(jaspace.reduced_dim == JL_DIM and proj is not None and tuple(jgl.matrix.shape) == (JL_DIM, JL_DIM),
          f"jl: reduced_dim {jaspace.reduced_dim}, graph {tuple(jgl.matrix.shape)}, not {JL_DIM}")
    m_host, host_matrix_s = timed(lambda: prng.normal(prng.PRNGKey(proj.seed), (F_JL, JL_DIM))
                                  * np.float32(1.0 / np.sqrt(JL_DIM)))
    matrix_equal = bit_equal(proj.matrix(dev).cpu(), torch.from_numpy(m_host))
    Pj, project_s = timed(lambda: proj.project(jaspace.data))
    jplan = tk.taumode_plan_chosen(Pj)
    # Kernel A at the jl path's shape (the projected rows against the
    # r × r graph) against its plain version; the path's count is read.
    Lj = jgl.matrix.contiguous()
    tau_j = tmo.select_tau(Pj, tmo.TAU_MEDIAN)
    lam_k, lam_p = tk.taumode_lambdas_fused(Pj, Lj, tau_j), tk.taumode_lambdas_plain(Pj, Lj, tau_j)
    jlam_rel = float(((lam_k - lam_p).abs() / torch.clamp(lam_p.abs(), min=1.0)).max())
    del Pj, lam_k, lam_p
    jlam_finite = bool(torch.all(torch.isfinite(jaspace.lambdas)))
    emit(phase="jl", n=N_JL, f=F_JL, reduced_dim=jaspace.reduced_dim, card=card,
         cut="200,000 rows of a 1M-row, 768-wide corpus, for the run's time limit",
         build_seconds=jbuild_s, stage_seconds=jbuilder.last_stage_timings,
         n_clusters=jaspace.n_clusters, projection_seconds=project_s,
         projection_matrix_host_seconds=host_matrix_s, matrix_bit_equal_to_host=matrix_equal,
         taumode_plan_at_reduced_dim=jplan, taumode_kernel_vs_plain_max_rel=jlam_rel,
         lambda_finite=jlam_finite, warmup_ms=jms[0],
         search_ms_per_batch_median=statistics.median(jms[1:]), search_ms_per_batch=jms[1:],
         checks=jchecks, launches=path_counts["jl"])
    check(matrix_equal, "jl: the card's projection matrix is not prng.normal's, bit for bit")
    check(jlam_finite, "jl: non-finite λ")
    check(jlam_rel <= TOL_LAMBDA, f"jl: kernel A vs plain λ at r = {JL_DIM}: {jlam_rel}")
    check(jchecks["self_query_failures"] == 0, f"jl: {jchecks['self_query_failures']} queries miss their own row")
    check(jchecks["max_score_err"] <= TOL_SCORE, f"jl: returned scores off by {jchecks['max_score_err']}")
    check(not jchecks["plain_route_mismatches"], f"jl: kernel vs plain route: {jchecks['plain_route_mismatches'][:3]}")
    for kname in ("taumode", "scores_tilemax", "subtile_topk"):
        check(path_counts["jl"][kname] > 0, f"jl: kernel {kname} not launched")

    # -- 9. persist: a checkpoint of the jl index, reloaded on the card ----
    have_pyarrow = importlib.util.find_spec("pyarrow") is not None
    if have_pyarrow:
        from matternet_rs_tpu_torch.storage import parquet as spq

        with tempfile.TemporaryDirectory(prefix="mrs-checkpoint-") as tmp:
            _, save_s = timed(lambda: spq.save_checkpoint(jaspace, jgl, jbuilder, tmp, "jl"))
            disk = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
            torch.cuda.synchronize()
            kernels.reset_launches()
            (raspace, rgl), load_s = timed(lambda: spq.load_arrowspace(tmp, "jl", device="cuda"))
            pms, pouts, _, _ = search_batches(raspace, rgl, Xj, jbatches)
            path_counts["persist"] = kernels.launch_counts()
        same_ids = all(np.array_equal(a[0], b[0]) for a, b in zip(jouts, pouts))
        same_scores = all(np.array_equal(a[1].view(np.int32), b[1].view(np.int32))
                          for a, b in zip(jouts, pouts))
        same_lams = bit_equal(raspace.lambdas, jaspace.lambdas)
        lam_before = jaspace.prepare_query_item(Xj[jbatches[1][0]], jgl)
        raspace.drop_data()
        lam_after = raspace.prepare_query_item(Xj[jbatches[1][0]], rgl)
        emit(phase="persist", pyarrow="present", card=card, n=N_JL, f=F_JL,
             save_seconds=save_s, load_seconds=load_s, bytes_on_disk=disk,
             warmup_ms=pms[0], search_ms_per_batch_median=statistics.median(pms[1:]),
             search_ms_per_batch=pms[1:], ids_equal=same_ids, scores_bit_equal=same_scores,
             lambdas_bit_equal=same_lams, query_lambda_after_drop_data=lam_after,
             query_lambda_before=lam_before, launches=path_counts["persist"])
        check(same_ids and same_scores and same_lams,
              "persist: the reloaded index does not search bit for bit as the built one")
        check(lam_after == lam_before and raspace.data.shape[0] == 0,
              f"persist: λ after drop_data {lam_after} != {lam_before}")
        for kname in ("scores_tilemax", "subtile_topk"):
            check(path_counts["persist"][kname] > 0, f"persist: kernel {kname} not launched")
        del raspace, rgl
    else:
        emit(phase="persist", pyarrow="absent", card=card)

    # -- 10. shards: the raw shard store, streamed onto the card -----------
    with tempfile.TemporaryDirectory(prefix="mrs-shards-") as tmp:
        manifest, write_s = timed(lambda: shards.write_shards(Xj, tmp, rows_per_shard=SHARD_ROWS))
        reader = shards.stream_blocks(tmp, SHARD_BLOCK_ROWS)
        native_reader = reader.native
        parts, read_s = timed(lambda: [torch.from_numpy(b).to(dev) for b in reader])
        streamed_equal = bit_equal(torch.cat(parts), torch.from_numpy(Xj).to(dev))
        ids = jbatches[1]
        rows_equal = np.array_equal(shards.read_rows(tmp, ids), Xj[ids])
    nbytes = Xj.nbytes
    emit(phase="shards", card=card, n=N_JL, f=F_JL, rows_per_shard=SHARD_ROWS,
         block_rows=SHARD_BLOCK_ROWS, shard_rows=[sh["rows"] for sh in manifest["shards"]],
         bytes=nbytes, write_seconds=write_s, write_mb_s=nbytes / write_s / 1e6,
         read_to_card_seconds=read_s, read_to_card_mb_s=nbytes / read_s / 1e6,
         native_reader=native_reader, blocks=len(parts), streamed_bit_equal=streamed_equal,
         read_rows_equal=rows_equal,
         note="the read follows the write, so the files are likely in the page cache")
    check(native_reader, "shards: the native reader did not open")
    check(manifest["n_rows"] == N_JL and manifest["shards"][-1]["rows"] == N_JL % SHARD_ROWS,
          f"shards: manifest {manifest['shards']}")
    check(streamed_equal and rows_equal, "shards: streamed or fetched rows differ from X")
    del parts, jaspace, jgl

    def launches_by_path(kname, main):
        """A kernel row's launches: the main path's and each new path's."""
        per = {"main": main, **{p: c[kname] for p, c in path_counts.items()}}
        return sum(per.values()), per

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

    # -- 11. streaming: the out-of-core index at the sketch tier's scale ---
    from matternet_rs_tpu_torch.index import streaming as sti

    sketch_rows = []          # kernel rows of the sketch path, for the kernels line
    with tempfile.TemporaryDirectory(prefix="mrs-stream-") as sdir:
        n_s = N_STREAM
        free = shutil.disk_usage(sdir).free
        while n_s > sti.MAXFIRST_MIN_ROWS and stream_disk_bytes(n_s) > free:
            n_s -= STREAM_SHARD_ROWS
        check(stream_disk_bytes(n_s) <= free,
              f"streaming: {free} bytes free, {stream_disk_bytes(n_s)} needed at {n_s} rows")
        cut = None if n_s == N_STREAM else (
            f"{n_s:,} of {N_STREAM:,} rows: {free:,} bytes free on the temporary disk")
        rng_s = np.random.default_rng(SEED_STREAM)
        centres = (rng_s.standard_normal((STREAM_CENTRES, F_STREAM), dtype=np.float32) * 4.0)
        gen_s = [0.0]

        def corpus_blocks():
            for start in range(0, n_s, STREAM_SHARD_ROWS):
                t = time.perf_counter()
                m = min(STREAM_SHARD_ROWS, n_s - start)
                block = centres[rng_s.integers(0, STREAM_CENTRES, m)]
                block += rng_s.standard_normal((m, F_STREAM), dtype=np.float32)
                gen_s[0] += time.perf_counter() - t
                yield block

        t0 = time.perf_counter()
        shards.write_shards(corpus_blocks(), sdir, rows_per_shard=STREAM_SHARD_ROWS)
        store_bytes = n_s * F_STREAM * 4
        write_s = time.perf_counter() - t0 - gen_s[0]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        sidx = sti.StreamingIndex.build_from_store(
            sdir, GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False),
            max_clusters=STREAM_CLUSTERS, radius=25.0, block_rows=sti.DEFAULT_BLOCK_ROWS,
            sample_rows=STREAM_SAMPLE, emit_sketch=True)
        torch.cuda.synchronize()
        stream_build_s = time.perf_counter() - t0
        (_, sketch_s) = timed(lambda: sidx.build_sketch())
        X8s, mults_s, lams_s, valids_s = sidx._sketch
        sketch_bytes = sum(t.numel() * t.element_size() for t in sidx._sketch)
        # Queries: corpus rows, uploaded before the path runs.
        srows = np.sort(np.random.default_rng(9).choice(n_s, BATCH * (N_BATCHES + 1), replace=False))
        srows = np.random.default_rng(10).permutation(srows).reshape(N_BATCHES + 1, BATCH)
        Qs = [torch.from_numpy(shards.read_rows(sdir, r)).to(dev) for r in srows]
        modes = {"maxfirst_refined": (None, True), "maxfirst_sketch_only": (None, False),
                 "carry_refined": (False, True), "carry_sketch_only": (False, False)}

        def sketch_search(mode, Q):
            sidx.sketch_maxfirst, refine = modes[mode]
            try:
                return sidx.search_batch_sketch(Q, K, alpha=ALPHA, refine=refine)
            finally:
                sidx.sketch_maxfirst = None

        sk_ms = {m: [] for m in modes}
        sk_out = {}
        for m in modes:                            # one warm-up batch each
            sketch_search(m, Qs[0])
        for m in list(modes) + list(reversed(modes)):
            for i, Q in enumerate(Qs[1:]):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                sk_out[m, i] = sketch_search(m, Q)
                torch.cuda.synchronize()
                sk_ms[m].append((time.perf_counter() - t1) * 1e3)
        path_counts["streaming"] = kernels.launch_counts()
        flat_n = X8s.shape[0] * X8s.shape[1]
        check(sidx._sketch_fused_ok(BATCH, K, sidx._candidate_width(K, None)[1]),
              f"streaming: the auto route at {flat_n} flat rows does not take the maxima-first scan")
        for kname in ("taumode", "tilemax_only", "slab_dots"):
            check(path_counts["streaming"][kname] > 0, f"streaming: kernel {kname} not launched")
        profile_s = traced(lambda Q: sketch_search("maxfirst_refined", Q), items=Qs[1:])

        # Streamed exact scan, f32 and bf16, over two batches; recall of
        # each sketch mode against it on the same queries.
        exact, exact_ms = {}, {}
        for quant in (False, True):
            outs, ms = [], []
            for Q in Qs[1:3]:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                outs.append(sidx.search_batch(Q, K + 1, alpha=ALPHA, quantized=quant))
                ms.append((time.perf_counter() - t1) * 1e3)
            exact[quant], exact_ms[quant] = outs, ms
        recall = {m: sum(len(set(sk_out[m, i][0][b].tolist()) & set(exact[False][i][0][b, :K].tolist()))
                         for i in range(2) for b in range(BATCH)) / (2 * BATCH * K) for m in modes}
        bf16_recall = sum(len(set(exact[True][i][0][b, :K].tolist()) & set(exact[False][i][0][b, :K].tolist()))
                          for i in range(2) for b in range(BATCH)) / (2 * BATCH * K)

        # Check 1: kernel A on the first block against its plain version.
        blk0 = torch.from_numpy(shards.read_rows(sdir, np.arange(sti.DEFAULT_BLOCK_ROWS))).to(dev)
        L_s = sidx.gl.matrix.contiguous()
        tau_s = tmo.select_tau(blk0, sidx.taumode.mode, sidx.taumode.param)
        lam_a = tk.taumode_lambdas_fused(blk0, L_s, tau_s)
        lam_p = tk.taumode_lambdas_plain(blk0, L_s, tau_s)
        lam_a_rel = float(((lam_a - lam_p).abs() / torch.clamp(lam_p.abs(), min=1.0)).max())
        lam_file = np.fromfile(os.path.join(sdir, sti.LAMBDA_FILE), np.float32, count=sti.DEFAULT_BLOCK_ROWS)
        lam_file_rel = float(np.max(np.abs(lam_file - lam_p.cpu().numpy())
                                    / np.maximum(np.abs(lam_p.cpu().numpy()), 1.0)))
        stats_finite = bool(np.isfinite(sidx.min_lambdas) and np.isfinite(sidx.range_lambdas))

        # Checks 2 and 3: kernels D and E at the path's shapes.
        X8f, mult_f, lam_f = sidx._sketch_flat_views()
        Q1 = Qs[1]
        ql1 = sidx._query_lambdas(Q1)
        a1 = torch.full((BATCH,), ALPHA, device=dev)
        tile, subs = so.DEFAULT_TILE, so.RESCORE_SUBS
        ts_s = tile // subs
        ns_s = flat_n // ts_s
        kwd = dict(tile=tile, subs=subs)
        sub_k = rsk.tilemax_only(X8f, mult_f, lam_f, Q1, ql1, a1, rn=mult_f, mask_from=n_s, **kwd)
        n1 = STREAM_CHECK_ROWS
        d_first = float((rsk.tilemax_only(X8f[:n1], mult_f[:n1], lam_f[:n1], Q1, ql1, a1, rn=mult_f[:n1], **kwd)
                         - rsk.tilemax_only_plain(X8f[:n1], mult_f[:n1], lam_f[:n1], Q1, ql1, a1,
                                                  rn=mult_f[:n1], **kwd)).abs().max())
        t_last = (n_s // tile) * tile              # the tile that holds mask_from
        sl = slice(t_last, t_last + tile)
        last_k = rsk.tilemax_only(X8f[sl], mult_f[sl], lam_f[sl], Q1, ql1, a1, rn=mult_f[sl],
                                  mask_from=n_s - t_last, **kwd)
        last_p = rsk.tilemax_only_plain(X8f[sl], mult_f[sl], lam_f[sl], Q1, ql1, a1, rn=mult_f[sl],
                                        mask_from=n_s - t_last, **kwd)
        fin = torch.isfinite(last_p)
        d_last = float((last_k[fin] - last_p[fin]).abs().max())
        same_inf = bool(torch.equal(fin, torch.isfinite(last_k)))
        whole_past = -(-n_s // ts_s)               # first sub-tile wholly past n_items
        past_inf = bool(torch.all(sub_k[:, whole_past:] == -float("inf")))
        in_path = float((sub_k[:, t_last // ts_s:t_last // ts_s + subs] - last_k)[fin].abs().max())
        kk_s, C_s = sidx._candidate_width(K, None)
        c_s = min(ns_s, max(kk_s + so.SELECT_MARGIN, -(-C_s // ts_s)))
        sel_s = torch.sort(so.topk_stable(sub_k, c_s)[1], dim=1).values
        de = rsk.slab_dots(X8f, Q1, sel_s, ts_s, checked=True)
        dp = rsk.slab_dots_plain(X8f, Q1, sel_s, ts_s)
        rows_e = sel_s[:, :, None] * ts_s + torch.arange(ts_s, device=dev)
        scale_e = torch.linalg.norm(Q1, dim=1)[:, None, None] * torch.linalg.norm(X8f[rows_e].float(), dim=-1)
        err_e = float(((de - dp).abs() / torch.clamp(scale_e, min=1e-30)).max())

        # Kernel E's designs at this shape: launched alone, and inside the
        # maxima-first refined scan, in turns (ring, pair, pair, ring).
        out_e = torch.empty_like(de)
        e_alone = {"ring": [], "pair": []}
        e_scan = {"ring": [], "pair": []}
        slab_reader = so._slab_dots_checked

        def forced(design):
            def reader(X, Q, sel, ts):
                out = torch.empty((Q.shape[0], sel.shape[1], ts), dtype=torch.float32, device=X.device)
                rsk._slab_dots_launch(X, Q, sel, ts, out, design=design)
                return out
            return reader

        for design in ("ring", "pair", "pair", "ring"):
            e_alone[design].append(cuda_ms(lambda: rsk._slab_dots_launch(X8f, Q1, sel_s, ts_s, out_e,
                                                                          design=design), reps=20))
            so._slab_dots_checked = forced(design)
            try:
                for Q in Qs[1:]:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    sketch_search("maxfirst_refined", Q)
                    torch.cuda.synchronize()
                    e_scan[design].append((time.perf_counter() - t1) * 1e3)
            finally:
                so._slab_dots_checked = slab_reader
        sketch_plan_e = rsk.slab_dots_plan(BATCH, c_s, F_STREAM, torch.int8, x_addr=X8f.data_ptr(),
                                           ts=ts_s, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        sketch_plan_e_chosen = rsk.slab_dots_plan_chosen(X8f, BATCH, c_s, ts_s)

        # Check 4: with the most candidates the maxima-first scan takes (64
        # slabs), its refined results equal the carry scan's.
        C4 = so.MAX_RESCORE_SLABS * ts_s
        sidx.sketch_maxfirst = True
        try:
            check(sidx._sketch_fused_ok(BATCH, K, C4), "streaming: maxima-first refuses 64 slabs")
            mf4 = sidx.search_batch_sketch(Q1, K, alpha=ALPHA, candidates=C4)
            sidx.sketch_maxfirst = False
            cs4 = sidx.search_batch_sketch(Q1, K, alpha=ALPHA, candidates=C4)
        finally:
            sidx.sketch_maxfirst = None
        carry_equal = bool(np.array_equal(mf4[0], cs4[0]) and np.array_equal(mf4[1].view(np.int32),
                                                                               cs4[1].view(np.int32)))
        carry_overlap = float(np.mean(mf4[0] == cs4[0]))

        # Check 5: the streamed exact scan on the first rows against the
        # in-memory exact tier (same λ, same normalisation).
        sub = os.path.join(sdir, "first")
        os.makedirs(sub)
        man = shards.read_manifest(sdir)
        first_shards = man["shards"][:max(1, STREAM_CHECK_ROWS // STREAM_SHARD_ROWS)]
        n_first = sum(sh["rows"] for sh in first_shards)
        for sh in first_shards:
            os.symlink(os.path.join(sdir, sh["file"]), os.path.join(sub, sh["file"]))
        with open(os.path.join(sub, shards.MANIFEST), "w") as fh:
            json.dump({**man, "n_rows": n_first, "shards": first_shards}, fh)
        np.fromfile(os.path.join(sdir, sti.LAMBDA_FILE), np.float32, count=n_first).tofile(
            os.path.join(sub, sti.LAMBDA_FILE))
        meta = json.load(open(os.path.join(sdir, sti.INDEX_FILE)))
        with open(os.path.join(sub, sti.INDEX_FILE), "w") as fh:
            json.dump({**meta, "n_items": n_first}, fh)
        os.symlink(os.path.join(sdir, sti.GRAPH_FILE), os.path.join(sub, sti.GRAPH_FILE))
        first_idx = sti.StreamingIndex.load(sub)
        q_first = torch.from_numpy(shards.read_rows(sdir, srows[1] % n_first)).to(dev)
        st_ids, st_sc = first_idx.search_batch(q_first, K, alpha=ALPHA)
        X1 = torch.from_numpy(shards.read_rows(sdir, np.arange(n_first))).to(dev)
        lam1 = torch.clamp((torch.from_numpy(np.fromfile(os.path.join(sub, sti.LAMBDA_FILE), np.float32))
                            .to(dev) - sidx.min_lambdas) / sidx.range_lambdas, 0.0, 1.0)
        mem_ids, mem_sc = so.search_lambda_aware_tilemax(
            X1, torch.linalg.norm(X1, dim=1), lam1, q_first, first_idx._query_lambdas(q_first),
            K + 1, torch.full((BATCH,), ALPHA, device=dev))
        first_bad = topk_mismatches(mem_ids.cpu().numpy(), mem_sc.cpu().numpy(), st_ids, st_sc, TOL_SCORE)
        del X1, lam1, first_idx

        # Check 6: a reload (load + the sketch from sketch.bin) searches bit
        # for bit as before.
        re_idx = sti.StreamingIndex.load(sdir)
        re_idx.build_sketch()
        a6, b6 = sketch_search("maxfirst_refined", Q1), re_idx.search_batch_sketch(Q1, K, alpha=ALPHA)
        reload_equal = bool(np.array_equal(a6[0], b6[0]) and np.array_equal(a6[1].view(np.int32),
                                                                             b6[1].view(np.int32)))
        del re_idx

        # Check 7: no synchronising call from the query λ to the id download.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ql7 = sidx._query_lambdas(Q1)
            s7, i7 = sidx._sketch_candidates(Q1, ql7, kk_s, C_s, ALPHA)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del s7, i7

        # The kernel rows of the sketch path (the kernels line).
        ops_d = rsk._tilemax_only_operands(X8f, mult_f, lam_f, Q1, ql1, a1, rn=mult_f, mask_from=n_s, **kwd)
        Xb_s = X8f.to(torch.bfloat16)
        Qb_s = Q1.to(torch.bfloat16)
        bms, by = bound(flat_n * F_STREAM + 8 * flat_n + 4 * BATCH * F_STREAM + 4 * BATCH * ns_s,
                        2 * BATCH * flat_n * F_STREAM, PEAK_BF16_FLOP_S)
        d_all = max(d_first, d_last)
        sketch_rows.append(dict(
            name="tilemax_only_int8_sketch", route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:243",
            launches=path_counts["streaming"]["tilemax_only"], max_abs_err=d_all,
            ms=cuda_ms(lambda: rsk.tilemax_only(X8f, mult_f, lam_f, Q1, ql1, a1, rn=mult_f,
                                                mask_from=n_s, **kwd)),
            launch_ms=cuda_ms(lambda: rsk._tilemax_only_launch(ops_d), reps=20),
            launch_floor_ms=cuda_ms(lambda: sfk.empty_launch(dev), reps=20),
            plain_ms=cuda_ms(lambda: rsk.tilemax_only_plain(X8f[:n1], mult_f[:n1], lam_f[:n1], Q1, ql1, a1,
                                                            rn=mult_f[:n1], **kwd), reps=3),
            plain_rows=n1,
            bound_ms=bms, bound_by=by, library_ms=cuda_ms(lambda: torch.matmul(Qb_s, Xb_s.T), reps=3),
            shape=f"B={BATCH} N={flat_n} F={F_STREAM} subs={subs} int8 mask_from={n_s}",
            library="torch.matmul(Q bf16, X bf16ᵀ) over the flat sketch (the product alone)",
            plain="the plain version over the first plain_rows flat rows (its [B, N] scores)",
        ))
        del Xb_s
        check(d_all <= TOL_SCORE and same_inf and past_inf and in_path <= TOL_SCORE,
              f"streaming: kernel D int8 vs plain {d_first}, {d_last}, -inf {same_inf}/{past_inf}, "
              f"path {in_path}")
        distinct = int(torch.unique(sel_s).numel())
        bms, by = bound(distinct * ts_s * F_STREAM + 4 * BATCH * F_STREAM + 4 * BATCH * c_s * ts_s
                        + 8 * BATCH * c_s, 2 * BATCH * c_s * ts_s * F_STREAM, PEAK_BF16_FLOP_S)
        sketch_rows.append(dict(
            name="slab_dots_int8_sketch", route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:417",
            launches=path_counts["streaming"]["slab_dots"], max_abs_err=err_e,
            ms=cuda_ms(lambda: rsk.slab_dots(X8f, Q1, sel_s, ts_s, checked=True), reps=20),
            launch_ms=cuda_ms(lambda: rsk._slab_dots_launch(X8f, Q1, sel_s, ts_s, out_e), reps=20),
            launch_floor_ms=cuda_ms(lambda: sfk.empty_launch(dev), reps=20),
            plain_ms=cuda_ms(lambda: rsk.slab_dots_plain(X8f, Q1, sel_s, ts_s), reps=5),
            bound_ms=bms, bound_by=by, library_ms=None,
            design=sketch_plan_e["design"], ring_launch_ms=e_alone["ring"], pair_launch_ms=e_alone["pair"],
            shape=f"B={BATCH} c={c_s} ts={ts_s} F={F_STREAM} int8 flat={flat_n} distinct_slabs={distinct}",
            err_scale="cosine (|Δd|/(‖q‖·‖x‖))",
        ))
        check(err_e <= TOL_SCORE, f"streaming: kernel E int8 vs plain {err_e} on the cosine scale")
        emit(phase="streaming", card=card, n=n_s, f=F_STREAM, cut=cut, shard_rows=STREAM_SHARD_ROWS,
             centres=STREAM_CENTRES, block_rows=sti.DEFAULT_BLOCK_ROWS, batch=BATCH, k=K,
             candidates=C_s, slabs=c_s,
             store_bytes=store_bytes, generate_seconds=gen_s[0], store_write_seconds=write_s,
             store_write_mb_s=store_bytes / write_s / 1e6,
             build_seconds=stream_build_s, build_timings=sidx.build_timings,
             lambda_pass_mb_s=store_bytes / sidx.build_timings["lambda_pass_s"] / 1e6,
             build_sketch_seconds=sketch_s, sketch_device_bytes=sketch_bytes,
             sketch_ms_per_batch_median={m: statistics.median(v) for m, v in sk_ms.items()},
             sketch_ms_per_batch=sk_ms, profile_maxfirst_refined=profile_s,
             recall_at_10_vs_exact=recall, bf16_stream_recall_at_10=bf16_recall,
             exact_ms_per_batch={"f32": exact_ms[False], "bf16": exact_ms[True]},
             exact_mb_s={"f32": [store_bytes / ms * 1e-3 for ms in exact_ms[False]],
                         "bf16": [store_bytes / ms * 1e-3 for ms in exact_ms[True]]},
             kernel_e_designs=dict(launch_ms=e_alone, scan_ms_per_batch=e_scan,
                                   scan_ms_per_batch_median={d: statistics.median(v) for d, v in e_scan.items()}),
             checks=dict(kernel_a_vs_plain_rel=lam_a_rel, lambda_file_vs_plain_rel=lam_file_rel,
                         stats_finite=stats_finite, kernel_d_first_rows=d_first, kernel_d_last_tile=d_last,
                         kernel_d_past_n_items_inf=past_inf, kernel_e_rel=err_e,
                         maxfirst_equals_carry_at_64_slabs=carry_equal, maxfirst_carry_id_overlap=carry_overlap,
                         exact_vs_in_memory_first_rows=first_bad[:5], first_rows=n_first,
                         reload_bit_equal=reload_equal, no_sync_maxfirst=True),
             launches=path_counts["streaming"])
        check(lam_a_rel <= TOL_LAMBDA and lam_file_rel <= TOL_LAMBDA and stats_finite,
              f"streaming: kernel A vs plain {lam_a_rel}, λ file {lam_file_rel}, stats finite {stats_finite}")
        check(carry_equal, f"streaming: maxima-first refined ≠ carry refined (id overlap {carry_overlap})")
        check(not first_bad, f"streaming: exact scan vs in-memory tier: {first_bad[:3]}")
        check(reload_equal, "streaming: the reloaded index does not search bit for bit as before")
        del sidx, X8s, mults_s, lams_s, valids_s, X8f, mult_f, lam_f, Qs, blk0
        torch.cuda.empty_cache()

    # -- 12. energy: the energy pipeline at the reference benchmark's size --
    energy_counts = energy_phase(dev, card)
    path_counts["energy"] = {k: sum(c[k] for c in energy_counts.values()) for k in kernels.LAUNCHES}

    # -- 13–15. items, lambda_search, pipeline ---------------------------
    items_counts = items_phase(dev, card, aspace, gl, X, batches[1])
    path_counts["items"] = {k: sum(c[k] for c in items_counts.values()) for k in kernels.LAUNCHES}
    exact_ids = [res[1] for res in results]
    path_counts["lambda_search"] = lambda_search_phase(dev, card, aspace, gl, X, batches, exact_ids)
    pipeline_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 16. kernels against their plain versions -----------------------
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

    # The heuristics build (F = 128) and the jl build (r = 384) take the
    # kernel's ≤ 512-feature range, this row's.
    tau_launches, tau_by_path = launches_by_path("taumode", main_counts["taumode"])
    lam_row("taumode_lambda", "matternet_rs_tpu/ops/pallas/taumode_fused.py:79",
            Xt, gl.matrix.contiguous(), tau_launches)
    rows_out[-1]["launches_by_path"] = tau_by_path
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
    b_launches, b_by_path = launches_by_path("scores_tilemax", main_counts["scores_tilemax"])
    rows_out.append(dict(
        name="scores_tilemax", route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
        replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:492",
        launches=b_launches, launches_by_path=b_by_path, max_abs_err=err_b,
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
    s3 = s_k.view(BATCH, ns, ts)
    for c_g in (c, min(ns, K_CHAIN + so.SELECT_MARGIN)):     # the shapes of k = 10 and k = 40
        sel = torch.sort(so.topk_stable(m_k, c_g)[1], dim=1).values
        g_k = tmk.gather_subtiles(s_k, sel, ts)
        g_p = tmk.gather_subtiles_plain(s_k, sel, ts)
        check(bool(torch.equal(g_k, g_p)), f"gather_subtiles c={c_g}: kernel vs plain")
    sel = torch.sort(so.topk_stable(m_k, c)[1], dim=1).values
    err_c = float((tmk.gather_subtiles(s_k, sel, ts) - tmk.gather_subtiles_plain(s_k, sel, ts)).abs().max())
    gidx = sel[:, :, None].expand(BATCH, c, ts)
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
        launches_at_k40=k40_counts["gather_subtiles"],
    ))

    # The candidate stage on the same batch: kernel B's scores and maxima,
    # the ragged tail as fused_tilemax scores it.
    tail = so._batched_scores(Xt[n0:], norms[n0:], lams[n0:], Q, ql, alphas)
    nr = tail.shape[1]
    stage_args = (s3, m_k, tail, N_MAIN, K, so.SELECT_MARGIN)
    top_k, idx_k = tmk.select_topk(*stage_args)
    top_p, idx_p = tmk.select_topk_plain(*stage_args, gather=lambda sel: tmk.gather_subtiles_plain(s_k, sel, ts))
    check(bool(torch.equal(idx_k, idx_p)) and bit_equal(top_k, top_p), "subtile_topk: kernel vs plain")
    lib_t = _cuda.library("tilemax")
    top_o, idx_o = torch.empty_like(top_k), torch.empty_like(idx_k)
    stream = _cuda.stream_ptr(dev)

    def stage_launch():
        _cuda.check(lib_t, lib_t.mrs_subtile_topk(
            s3.data_ptr(), m_k.data_ptr(), tail.data_ptr(), BATCH, ns, nr, c, K,
            top_o.data_ptr(), idx_o.data_ptr(), stream), "subtile_topk kernel")

    full = torch.cat([s_k, tail], dim=1)
    bms, by = bound(4 * BATCH * (ns + c * ts + nr) + 12 * BATCH * K, 0)
    h_launches, h_by_path = launches_by_path("subtile_topk", main_counts["subtile_topk"])
    rows_out.append(dict(
        name="subtile_topk", route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
        replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:622",
        launches=h_launches, launches_by_path=h_by_path,
        max_abs_err=float((top_k - top_p).abs().max()),
        ms=cuda_ms(lambda: tmk.select_topk(*stage_args), reps=20),
        launch_ms=cuda_ms(stage_launch, reps=20),
        launch_floor_ms=cuda_ms(lambda: sfk.empty_launch(dev), reps=20),
        plain_ms=cuda_ms(lambda: tmk.select_topk_plain(
            *stage_args, gather=lambda sel: tmk.gather_subtiles_plain(s_k, sel, ts)), reps=20),
        chain_ms=cuda_ms(lambda: tmk.select_topk_plain(
            *stage_args, gather=lambda sel: tmk.gather_subtiles(s_k, sel, ts)), reps=20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.topk(full, K, dim=1), reps=20),
        shape=f"B={BATCH} ns={ns} c={c} ts={ts} tail={nr} k={K}",
        replaces_also="matternet_rs_tpu/ops/search.py:290 (_tilemax_select, the XLA selection around the gather)",
        chain="the selection chain with kernel C as its gather",
        library="torch.topk over the full [B, n] score plane (no id tie-break)",
        launch_floor="an empty kernel, timed the same way",
    ))
    log = buildcache.BUILD_LOG.get("tilemax")
    resources["subtile_topk"] = dict(ptxas=ptxas_resources(log, "subtile_topk_kernel"))
    check(log is None or resources["subtile_topk"]["ptxas"] is not None,
          "subtile_topk: no ptxas report in the build log")
    del s_k, s_p, s3, full, tail

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
        d_by_path = {"rescored": tier_counts[tier]["tilemax_only"],
                     "energy": energy_counts.get(tier, {}).get("tilemax_only", 0),
                     "items": items_counts.get(tier, {}).get("tilemax_only", 0)}
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:243",
            launches=sum(d_by_path.values()), launches_by_path=d_by_path, max_abs_err=err_d,
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

    # Kernel E in both row modes at the 1M × 128 shape. The maxima-first
    # tiers read f32 rows (one block a pair); int8 rows take the ring and
    # come from phase streaming's sketch, so that row carries the wrapper's
    # count and its own mode's count (phase streaming's) beside it; its row
    # at the sketch's own shape is slab_dots_int8_sketch. The main path
    # calls the wrapper with checked=True (no read-back of the slab ids),
    # and so is it timed here.
    e_by_path = {"rescored": sum(tier_counts[t]["slab_dots"] for t in scan_of),
                 "energy": energy_counts["bf16x3_rescored"]["slab_dots"],
                 "items": path_counts["items"]["slab_dots"]}
    e_launches = sum(e_by_path.values())
    qnorm = torch.linalg.norm(Q, dim=1)
    floor_ms = cuda_ms(lambda: sfk.empty_launch(dev), reps=20)
    for label, Xr, sel_e, peak, mode_launches, entry in (
        ("slab_dots_f32", Xt, sels["bf16x3_rescored"], PEAK_F32_FLOP_S, e_launches, "slab_dots_kernelILb0E"),
        ("slab_dots_int8", X8, sels["int8_rescored"], PEAK_BF16_FLOP_S, path_counts["streaming"]["slab_dots"],
         "slab_dots_ring_kernel"),
    ):
        de, dp = rsk.slab_dots(Xr, Q, sel_e, ts_r, checked=True), rsk.slab_dots_plain(Xr, Q, sel_e, ts_r)
        rows_e = sel_e[:, :, None] * ts_r + torch.arange(ts_r, device=dev)
        scale = qnorm[:, None, None] * torch.linalg.norm(Xr.float(), dim=1)[rows_e]
        err_e = float(((de - dp).abs() / torch.clamp(scale, min=1e-30)).max())
        plan_e = rsk.slab_dots_plan(BATCH, c_r, F_MAIN, Xr.dtype, x_addr=Xr.data_ptr(), ts=ts_r, sms=sms)
        distinct = int(torch.unique(sel_e).numel())
        bms, by = bound(distinct * ts_r * F_MAIN * Xr.element_size() + 4 * BATCH * F_MAIN
                        + 4 * BATCH * c_r * ts_r + 8 * BATCH * c_r,
                        2 * BATCH * c_r * ts_r * F_MAIN, peak)
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/rescored.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:417",
            launches=e_launches, launches_by_path=e_by_path, max_abs_err=err_e,
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
        record_resources(label, "rescored", entry, plan_e, rsk.slab_dots_plan_chosen(Xr, BATCH, c_r, ts_r))
    rows_out += sketch_rows
    record_resources("slab_dots_int8_sketch", "rescored", "slab_dots_ring_kernel",
                     sketch_plan_e, sketch_plan_e_chosen)

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
                        sel_e[:, -1] = EDGE_SLABS_E - 1          # the last whole slab
                        per = max(1, PLAIN_GATHER_BYTES // (c_e * ts_e * f_e * 4))
                        rows_e = sel_e[:, :, None] * ts_e + torch.arange(ts_e, device=dev)
                        scale = torch.linalg.norm(Qe, dim=1)[:, None, None] * xnorm[rows_e]
                        for Xv in (Xr, Xo):
                            ref = torch.cat([rsk.slab_dots_plain(Xv, Qe[q0:q0 + per], sel_e[q0:q0 + per], ts_e)
                                             for q0 in range(0, b_e, per)])
                            got = rsk.slab_dots(Xv, Qe, sel_e, ts_e, checked=True)
                            gap = float(((got - ref).abs() / torch.clamp(scale, min=1e-30)).max())
                            plan = rsk.slab_dots_plan(b_e, c_e, f_e, Xv.dtype, x_addr=Xv.data_ptr(),
                                                      ts=ts_e, sms=sms)
                            what = (f"slab_dots F={f_e} ts={ts_e} c={c_e} B={b_e} {Xv.dtype} "
                                    f"{'offset' if Xv is Xo else 'aligned'} {plan['reads']}")
                            edge.append(dict(case=what, max_rel_err=gap))
                            check(gap <= TOL_SCORE, f"{what}: kernel vs plain {gap} on the cosine scale")
                            check(plan == rsk.slab_dots_plan_chosen(Xv, b_e, c_e, ts_e), f"{what}: unexpected plan")
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
    # The candidate stage at edge cases, bit for bit against the chain:
    # every kind with every B, k and tail (ns = 64), every sub-tile selected
    # (c = ns), maxima staged in two chunks (ns = 5000), and scores and
    # maxima one element off 16 bytes (the element-wise loaders; a tail of
    # 1 or 2,047 columns puts every row but the first there too).
    gen_h = torch.Generator(device=dev).manual_seed(15)

    def stage_scores(b_e, ns_e, nr_e, kind):
        n_e = ns_e * 256 + nr_e
        u = torch.rand((b_e, n_e), device=dev, generator=gen_h)
        v = torch.randn((b_e, n_e), device=dev, generator=gen_h)
        if kind == "equal":
            v = torch.full_like(v, 0.25)
        elif kind == "zeros":
            v = torch.where(u < 0.5, -0.0, 0.0)
        elif kind == "fills":
            v = torch.where(u < 0.5, -float("inf"), v)
        elif kind == "nan":
            v = torch.where(u < 0.01, float("nan"), v)
        main = v[:, :ns_e * 256].contiguous()
        tmax = main.view(b_e, ns_e, 256).amax(dim=2)
        if kind == "offset":
            main, tmax = misaligned(main), misaligned(tmax)
        return main.view(b_e, ns_e, 256), tmax, (v[:, ns_e * 256:].contiguous() if nr_e else None), n_e

    stage_cases = [(b_e, 64, nr_e, kind, k_e) for kind in EDGE_KINDS_H for b_e in EDGE_B_H
                   for nr_e in EDGE_NR_H for k_e in EDGE_K_H]
    stage_cases += [(b_e, ns_e, nr_e, kind, 16) for ns_e in (1, 8) for kind in ("random", "equal")
                    for b_e in EDGE_B_H for nr_e in EDGE_NR_H]
    stage_cases += [(7, 5000, 576, "random", k_e) for k_e in EDGE_K_H]
    for b_e, ns_e, nr_e, kind, k_e in stage_cases:
        main_e, tmax_e, tail_e, n_e = stage_scores(b_e, ns_e, nr_e, kind)
        tk_, ik_ = tmk.select_topk(main_e, tmax_e, tail_e, n_e, k_e, so.SELECT_MARGIN)
        tp_, ip_ = tmk.select_topk_plain(main_e, tmax_e, tail_e, n_e, k_e, so.SELECT_MARGIN)
        same = bool(torch.equal(ik_, ip_)) and bit_equal(tk_, tp_)
        what = (f"subtile_topk B={b_e} ns={ns_e} c={min(ns_e, k_e + so.SELECT_MARGIN)} tail={nr_e} "
                f"k={k_e} {kind}")
        edge.append(dict(case=what, bit_equal=same))
        check(same, f"{what}: kernel vs plain")
    torch.cuda.synchronize()
    emit(phase="kernels", card=card, rows=len(rows_out), resources=resources, edge_cases=edge)

    emit(phase="total", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
