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
   launched; the query λ is one launch of the query kernel a batch. The three timed batches then run again through that stage and
   through the selection chain it replaced (kernel C's gather and the
   stable sorts), in turns (chain, stage, stage, chain), each route also
   once under ``torch.profiler``: ms per batch, device-busy ms and idle
   share of each go on the phase's line; the same at k = 100 (the wide
   design of the stage). Then one search each at k = 40 and k = 100
   launches the stage once and kernel C never, and one at k = 200 takes
   the chain: kernel C once, the stage never; the first ten ids of each
   are the k = 10 search's, and the k = 100 search's ids and score bits
   are the chain's.
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
   step of phase 13, phases 14 and 15, each step of phases 16–19, each
   check of phase 20, and read just after each; every kernel of a path
   must have launched. The kernel rows of A, B, C and the candidate stage
   add the launches of phases 7–9, 11–14 and 16–20 to phase 2's
   (``launches_by_path``; kernel A's F = 768 launches of phase 19's store
   build go to its wide row); those of D and E add phases 12's, 13's,
   16's, 18's, 19's and 20's to phase 3's (E's int8 row phase 20's sketch
   check to phase 11's), and the sketch rows phase 16's and 19's streaming
   steps to phase 11's; kernel F's rows form (row ``spmv_ell (rows)``) has
   phase 19's launches.
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
   term 1e-9·(1 − cos) at a cosine tolerance of 1e-5); each full-scan
   batch launches ``energy_window`` once (the window route: both indexes
   keep their sorted λ on the card) and neither ``energy_scan`` nor
   ``search_fused_merge``, a banded one none (counted around each route). The same on the
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
16. serve — the HTTP serving layer (``serve.py``), for the users who serve
   an in-memory index. On phase 2's index: (1) an ``IndexService`` with a
   5 s window and ``max_batch`` 256 gets 256 requests (corpus rows of seed
   49, the six alphas 0.5–0.95, k = 10) placed in its queue under its lock,
   so the collector cuts them as one batch: one dispatch, kernel B and the
   candidate stage launched once each, every answer bit for bit the direct
   ``search_batch`` of the same rows and alpha vector; the same on
   ``bf16x3_rescored`` and ``int8_rescored`` (D and E once each); each
   tier twice, in turns, its dispatch and queue wait (``metrics()``) beside
   the direct call's ms. (2) An
   HTTP burst at the reference's defaults (2 ms window, ``max_batch``
   256): 256 client threads POST 8 requests each over loopback, 2,048
   corpus rows with the six alphas, three in four on the exact tier and
   one in four on ``bf16x3_rescored``, 16 exact ones at k = 40 (the wide
   candidate stage; kernel C never).
   Every status 200; each top-1 the query's own row or a score at least
   its own blended score less 1e-5; each answer the direct
   ``search_batch`` of its query, alpha, tier and k under the same-k rule
   (1e-5). The line carries wall seconds, requests/s, dispatches, batch
   occupancy and ``metrics()``'s p50/p99 of latency, queue wait and
   dispatch, the same for the traffic's first 512 requests from 16
   clients (the same checks), and a ``torch.profiler`` pass over a second
   burst of the whole traffic (device-busy ms, idle share, top kernels).
   (3) The error paths over HTTP with the
   reference's statuses and texts (wrong width, NaN, bad JSON, a null
   alpha, an unknown tier, ``bf16_rescored`` → 400; a zero query → 422;
   an unknown path → 404; a full queue on a ``max_queue_depth=1`` service,
   its two dispatch slots held and one request queued under the lock →
   429 with ``Retry-After: 1``). (4) Inside phase 12, on its index: 256
   ``/search_energy`` requests from 32 clients on the full scan and with
   ``energy_candidates="auto"``, each the direct ``search_energy_batch``
   under the same-k rule at 1e-14, and 256 ``/search`` requests (B and the
   candidate stage). (5) Inside phase 11, before its store goes: a
   ``StreamingIndexService`` over the 10M index's sketch, 256 requests
   refined and 256 sketch-only queued together, each bit for bit
   ``search_batch_sketch`` (D and E once each). (6) Every service closed;
   a request after ``close()`` raises.
17. cli — ``python -m matternet_rs_tpu_torch`` in subprocesses (each run
   through a runner that writes the process's launch counts at exit), for
   the users who start the system from the shell: ``build`` of phase 2's
   rows saved as ``.npy`` (250 clusters, radius 25; kernel A must launch),
   ``info``, ``search`` of 4 rows (each its own top-1), and ``serve`` on a
   free port: ``/health`` polled, then 16 POSTs each bit for bit the
   in-process search of the same checkpoint loaded on the card; the
   server is then terminated. Seconds of each process and the
   checkpoint's bytes.
18. models — the façades, for the users who fit a model: ``EigenIndex(eps=1.0,
   k=6, max_clusters=250, radius=25.0).fit`` on phase 2's rows (kernel A
   must launch; ``lambdas`` a host array of N finite values in [0, 1]),
   ``query_batch`` of 256 rows on every servable tier (each query's own
   row first, or a first at least as good within 1e-5); ``EnergyIndex``
   at 200,000 × 128 (seed 43; 16 queries find their own rows); and
   ``SurffaceModel`` on phase 15's fixture at cap 3,000 with MST k = 32.
   Fit seconds and launches; the two cuts are listed in the line's
   ``cut``.
19. mesh — the device-mesh layer (``parallel/``) with 4 slots placed on
   the one card (the card listed four times: each slot launches the
   kernels with its own rows and ``mask_from``) and with 1 slot. Inside
   phase shards, on its 200,000 × 768 store: ``distributed_build_from_store``
   over 4 slots (kernel A's F = 768 route per slot) and a 256-query search
   (each query's own row first); then ``distributed.initialize`` with NCCL
   at world size 1 and the same build and search on its 1-slot mesh,
   every collective through ``torch.distributed``: λ and results equal.
   Inside phase streaming, on its 10M × 96 index: ``ShardedSketch`` over 4
   slots — the carry scan per slot (the auto route: 2.6M flat rows a slot,
   under the 4M crossover), sketch-only and refined, bit for bit the
   single-card carry scan; maxima-first forced per slot (D and E launch 4
   times), recall@10 against the single-card maxima-first tier and the
   carry scan (≥ 0.95 refined); ``hbm_bytes_per_device``; one request
   through ``StreamingIndexService(mesh=...)``, the single-card carry
   scan's answer.
   After phase models, on phase 2's index: ``from_arrowspace`` at D = 1
   and D = 4; the exact ``search_batch`` of phase 2's timed batches (k = 10,
   α = 0.7) against phase 2's results, bit for bit where they are and
   under the near-tie rule otherwise (the line says which), kernel B and
   the candidate stage once a slot, also at k = 40 (the wide design;
   kernel C never);
   ``bf16x3_rescored`` and ``int8_rescored`` at D = 4 (D and E once a slot,
   recall@10 against the exact ids); ms a batch of the single card, D = 1
   and D = 4 in turns, with a ``torch.profiler`` pass of each; the merge's
   own time; kernels B and D on the last slot's rows (the padding past its
   ``mask_from``) against their plain versions; ``distributed_build`` from
   4 host blocks of the 1M rows (serial centroids): λ against the
   single-card index of the same rows and graph (1e-5·max(|λ|, 1)), Lloyd
   timed apart; ``spectral_embedding``'s graph and solve at 100,000 × 128
   over 4 slots with ``reverse_k="auto"`` (no dropped reverse edge; LOBPCG
   residuals under 0.1 × the largest eigenvalue, the reference's bound at
   16k nodes; kernel F's rows form once a slot per operator application,
   bit for bit its plain version; the edge list's bytes and the assembly's
   peak allocation); ``pipeline.build(mesh=...)`` at phase pipeline's size
   (cap 3,000, MST k = 32): λ against stage D on one device from the same
   Laplacian; the CLI's ``build-distributed`` and ``serve --streaming --mesh
   1`` each in its own process (the served answer's top-1 the query's own
   row), and ``serve --streaming --mesh 4`` on one card failing with the
   reference's ``ValueError`` (skipped, and said so, with 4 cards or more). No multi-card collective is measured: the
   machine has one card.
20. ties — the adversarial exact-tie corpora of the reference's
   ``tests/test_fuzz_invariants.py`` through the kernels, by the normal
   entry points (``tie_checks``; ``tests/test_torch_ties_gpu.py`` runs the
   same checks at a smaller size, ``tests/test_torch_fuzz_tie_corpora.py``
   on the CPU's plain versions). Corpora (``tie_corpus``): integer
   coordinates in [−level, level], so that every dot is exact in f32, bf16
   and int8 and every tie is a true tie; a quarter of the rows exact
   duplicates of others; λ in quarters; the rows at offsets < 16 of every
   256-row sub-tile one row (row 0) with one λ, so that a quarter of each
   256-query batch (``search_batch``'s queries are corpus rows, the first
   quarter row 0) meets a tie group in every sub-tile. At 1,000,000 × 128,
   levels 2, 3 and 17 (an index each, ``ArrowSpace.from_items`` with the
   quantised λ and a 64-centroid graph for the query λ): the exact tier at
   k = 10 (kernel B and ``subtile_topk``'s warp lists), 40 and 100 (its
   wide design; the line counts the queries whose list overflowed into the
   radix select, replayed from the plain scores by the kernel's own rule,
   ``wide_stage_radix_rows``) and 200 (the chain with kernel C), and
   ``bf16x3_rescored``, ``int8_rescored`` and ``bf16_rescored`` at k = 10
   and 40 (kernel D in its three modes, kernel E on f32 rows); at level 2
   also ``mask_from``: 3,000 zero rows after the corpus whose λ is each
   query's (λ = 0.125, α = 0.1, so unmasked each would score 0.9, above
   every real row) through the routes a mesh slot runs (the exact tier and
   the three rescored tiers), and the sketch's maxima-first scan (kernel E
   on int8 rows) with its last 3,000 rows past ``n_items``, and kernel G
   (``search_fused``, its own entry point) on the row-normalised corpus,
   whose identical rows still tie. At 40,960 rows,
   F = 128, 256, 512 and 1,536 (the fused wide-F envelope), level 3: the
   exact tier and the three rescored tiers at k = 10. On 4 mesh slots on
   the card, 262,145 rows (3 padded rows on the last slot, their λ the hub
   queries', α = 0.1): the exact, bf16x3 and int8 rescored tiers. Each check
   holds the reference's contract (``tie_faults``: ids in range, never a
   padded row, distinct, carrying their flat scores within 2e-5; each at or
   above the flat k-th less the tier's margin, 0.03 for int8; on the exact
   scans the score multiset is the flat top-k's within 2e-5 and a tie-free
   k-th gives the flat ids), the kernel route against the plain route
   (the exact tier under the near-tie rule at k + 1, ``bit_equal_plain``
   saying whether ids and score bits agree; the rescored tiers under the
   same-k rule where both select the same slabs, elsewhere a near tie at
   the c-th maximum), padded rows that would win unmasked, and its kernels'
   launches (B and the stage, or C at k = 200; D and E; G's scan and
   merge). One line per
   check: corpus, k, tier, rows whose k-th and (k+1)-th flat scores tie,
   launches, the radix rows, ok and faults; then a summary line.
21. kernels — each kernel against its plain PyTorch version on the inputs
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
   ``torch.topk`` over the full [B, n] plane, no id tie-break), the chain
   timed first; the same rows at k = 40 and k = 100 (``subtile_topk_wide_k40``,
   ``_k100``: the wide design, its launch plan held to the library's);
   kernel C's row has its only route's shape, k = 200 (c = 204), and the
   k = 200 search's launch; C is also held bit for bit at c = 14. The stage
   is held bit for bit (values and ids) against the chain
   at random, all-equal, ±0.0-only, half −inf and 1% NaN scores and at
   scores and maxima one element off 16 bytes, for B in {1, 7, 256}, k in
   {1, 10, 16} and tails of 0, 1 and 2,047 columns (64 sub-tiles); with
   every sub-tile selected (1 and 8 sub-tiles); and with the maxima staged
   in two chunks (5,000 sub-tiles); the wide design at k in {17, 40, 100,
   128} with every kind (and scores whose large values lie in 31 threads'
   positions), B and tail on 140 sub-tiles, with every sub-tile selected,
   and at the 10M-row index's 39,056 sub-tiles, each at the list cap the
   wrapper passes and at a cap of 0 (every selection through the radix
   select). The rows of kernels E and F carry ``launch_ms``
   (the kernel alone) and ``launch_floor_ms`` (the same empty kernel).
   Their launch plans (held equal to the library's) and ptxas reports go to the phase's
   line. Kernel F is held bit for bit at every n in {1, 31, 16384} with
   every k in {1, 14, 40} and m in {1, 15, 16, 17, 256}, both forms, with
   rows of empty slots only, empty slots at −1 or naming a row of inf that
   no live slot names. Kernel E is held at every F
   in {1, 3, 96, 100, 128, 768, 2048} with ts in {128, 256}, c in {1, 14},
   B in {1, 7, 256}, f32 and int8 rows (the ring where it applies), X
   aligned and 4 bytes off, each query's last slab the corpus's last whole
   one; ids out of range give exactly their NaN slices. The query kernel
   (``query_lambda_rows``: τ, the closed form and the fold in one launch)
   has a row at each (B, F) in {256, 1024} × {128, 96}, median τ: its
   wrapper, its C entry alone, 200 launches back to back, the plain chain
   it replaced, its launch plan and ptxas report.
   The energy window route's designs (``window_designs``, a
   ``window_designs`` line): its C entry alone, cold L2, B = 256, k = 10,
   on the energy cell's law (phase 12's index and batch) and the energy JL
   cell's (``jl_window_law``: 1M × 1536 rows of ``centres256``, each on its
   centre's λ), in the design the port builds and in variants compiled
   from the same source (``_cuda.variant``): no narrow tile (the design
   before them) and narrow tiles of 4 and 16 queries, in turns; each
   variant's ids and distances bit for bit ``energy_scan`` + G's merge's,
   its tally (band pairs, dot pairs, the narrow tiles' share).

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
K_WIDE = (40, 100)            # k of the wide candidate stage (16 < k ≤ 128)
K_CHAIN = 200                 # a k past the stage's 128: the selection chain with kernel C
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
EDGE_K_WIDE = (17, 40, 100, 128)
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
# Phase serve: the alphas of its mixed traffic, each one-dispatch tier with
# the kernels it must launch once, the HTTP burst (clients × requests
# each, of which SERVE_K40 at k = 40), the energy step's clients.
SEED_SERVE = 49
SERVE_ALPHAS = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
SERVE_ONE_DISPATCH = ((False, ("scores_tilemax", "subtile_topk")),
                      ("bf16x3_rescored", ("tilemax_only", "slab_dots")),
                      ("int8_rescored", ("tilemax_only", "slab_dots")))
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_K40, SERVE_ENERGY_CLIENTS = 256, 8, 16, 32
SERVE_FEW_CLIENTS, SERVE_FEW_REQUESTS = 16, 512
# Phase cli: the rows it builds (phase 2's; never cut below 200,000), the
# build's clusters, the searched rows and the POSTs to the served index.
N_CLI, CLI_CLUSTERS, CLI_QUERIES, CLI_POSTS = 1_000_000, 250, 4, 16
# Phase models: every tier query_batch serves, and the EnergyIndex rows
# (cut from the energy benchmark's 1M for the run's time limit).
MODEL_TIERS = (False, True, "auto", "int8", "int8_rescored", "int8_auto", "bf16x3_rescored")
N_MODELS_ENERGY = 200_000
# The steps of phases serve and models whose kernel-D launches scan in each
# mode (the burst's maxima-first requests are all bf16x3_rescored; "auto"
# and "int8_auto" take int8 rows where they take the maxima-first scan).
SERVE_D_STEPS = {"bf16x3_rescored": ("one_dispatch_bf16x3_rescored", "burst", "burst_few_clients",
                                     "burst_profiled"),
                 "int8_rescored": ("one_dispatch_int8_rescored",), "bf16_rescored": ()}
MODELS_D_STEPS = {"bf16x3_rescored": ("query_batch_bf16x3_rescored",),
                  "int8_rescored": ("query_batch_int8_rescored", "query_batch_int8_auto", "query_batch_auto"),
                  "bf16_rescored": ()}


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
    energy-mode ``search_batch`` by tier and of ``search_energy_batch``'s
    routes (key ``"scans"``), each counted just before its batches and
    read just after; those of phase 16's energy step
    (:func:`serve_energy_step`, run here on this index); and, for phase
    ``kernels``'s energy scan row, this index's rows, norms and λ with one
    batch's queries and query λ."""
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

    scan_counts = {k: 0 for k in kernels.LAUNCHES}
    scan_bad_counts = []

    def routed(fn, items):
        """Times ``fn`` over ``items``; its route; one ``energy_window`` a
        full-scan batch (both indexes keep a sorted view on the card), no
        ``energy_scan`` and no merge, none of them a banded one."""
        before, launched = banded_calls[0], kernels.launch_counts()
        ms, outs = over(fn, items)
        route = "banded" if banded_calls[0] > before else "full scan"
        now = kernels.launch_counts()
        d = {k: now[k] - launched[k] for k in now}
        want = len(items) if route == "full scan" else 0
        if d["energy_window"] != want or d["energy_scan"] or d["search_fused_merge"]:
            scan_bad_counts.append((route, len(items), d["energy_window"], d["energy_scan"],
                                    d["search_fused_merge"]))
        for k in scan_counts:
            scan_counts[k] += d[k]
        return ms, outs, route

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
        Q1 = torch.from_numpy(X[batches[1]]).to(dev)
        ql1 = em._batch_query_lambdas(aspace.sub_centroids, aspace._subcentroid_lambdas_dev(),
                                      aspace._energy_query(Q1))
        scan_inputs = (aspace.data, aspace.item_norms, aspace.lambdas, Q1, ql1,
                       *em._window_view(aspace))
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
        check(not scan_bad_counts and scan_counts["energy_window"] > 0,
              f"energy: (route, batches, energy_window, energy_scan, search_fused_merge) launched "
              f"otherwise than one window a full-scan batch: {scan_bad_counts}")

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
         scan_launches=scan_counts, search_batch=tier_info, scan_profile=scan_profile,
         checkpoint=ckpt, store=store)
    serve_counts = serve_energy_step(dev, card, aspace, gl, X)
    del aspace, gl, X
    torch.cuda.empty_cache()
    return {**tier_counts, "scans": scan_counts}, serve_counts, scan_inputs


WINDOW_VARIANTS = (0, 4, 8, 16)   # narrow widths timed (0: no narrow tile, the earlier design)


def jl_window_law(dev, n=1_000_000, f=1536, b=BATCH, seed=2**31 + 27):
    """The energy JL cell's λ layout at its size, for the window route:
    rows of the ``centres256`` law, each on its centre's λ (256 distinct
    values, groups of ≈ 3,900 rows, as the cell's items carry their
    sub-centroid's), and ``b`` held-out rows of the law on their centres'
    λ, so that a batch of 256 falls into ≈ 160 bands of 1–6 queries.
    Returns (X, norms, λ, sorted λ, sorted ids, Q, query λ) on ``dev``."""
    import torch

    from portbench.corpora import centres256

    c = centres256.centres(f, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    levels = torch.sort(torch.rand(centres256.N_CENTRES, generator=g, device=dev))[0]

    def law(m, chunk=1 << 18):
        lab = torch.randint(0, centres256.N_CENTRES, (m,), generator=g, device=dev)
        out = torch.empty((m, f), device=dev)
        for s0 in range(0, m, chunk):
            s1 = min(m, s0 + chunk)
            out[s0:s1] = torch.randn((s1 - s0, f), generator=g, device=dev)
            out[s0:s1] += c[lab[s0:s1]]
        return out, levels[lab]

    X, lam = law(n)
    Q, ql = law(b)
    return (X, torch.sqrt(torch.sum(X * X, dim=1)), lam, *torch.sort(lam, stable=True), Q, ql)


def window_designs(dev, flush, laws, rounds=7):
    """Phase ``kernels``'s window designs (module docstring): per law
    (label → ``jl_window_law``'s tuple), per narrow width of
    ``WINDOW_VARIANTS``, the C entry's median ms over ``rounds`` cold-L2
    launches taken in turns, bit equality with ``energy_scan`` + G's merge
    and one launch's tally."""
    import torch

    from matternet_rs_tpu_torch.ops.kernels import _cuda
    from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
    from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk

    built = esk.narrow_width()
    libs = {w: _cuda.library("energy_window") if w == built
            else _cuda.variant("energy_window", f"WINDOW_NARROW_W={w}") for w in WINDOW_VARIANTS}
    grid = sfk.blocks_per_wave(dev)
    out = dict(built_narrow_w=built)
    for label, (X, norms, lam, s_lam, s_idx, Q, ql) in laws.items():
        (n, f), b = X.shape, Q.shape[0]
        want_i, want_d = esk.energy_topk(X, norms, lam, Q, ql, K)
        _, ws_len, _ = esk._window_sizes(libs[built])
        qn = esk.query_norms(Q)
        ws = torch.empty(ws_len, dtype=torch.int64, device=dev)
        pv = torch.empty((b, grid, K), dtype=torch.float32, device=dev)
        pi = torch.empty((b, grid, K), dtype=torch.int32, device=dev)
        vals = torch.empty((b, K), dtype=torch.float32, device=dev)
        ids = torch.empty((b, K), dtype=torch.int32, device=dev)
        tally = torch.zeros(len(esk.TALLY_NAMES), dtype=torch.int64, device=dev)

        def launch(lib):
            rc = lib.mrs_energy_window(
                X.data_ptr(), norms.data_ptr(), s_lam.data_ptr(), s_idx.data_ptr(), Q.data_ptr(),
                qn.data_ptr(), ql.data_ptr(), n, f, b, K, grid, ws.data_ptr(), pv.data_ptr(),
                pi.data_ptr(), vals.data_ptr(), ids.data_ptr(), tally.data_ptr(),
                _cuda.stream_ptr(dev))
            _cuda.check(lib, rc, "energy window kernel")

        rows = {}
        for w, lib in libs.items():
            tally.zero_()
            launch(lib)
            t = dict(zip(esk.TALLY_NAMES, tally.tolist()))
            same = bool(torch.equal(ids.long(), want_i)
                        and torch.equal((-vals).view(torch.int32), want_d.view(torch.int32)))
            check(same, f"window designs, {label}: narrow width {w} not bit for bit energy_scan's")
            check(t["narrow_dot_pairs"] == 0 if w == 0 else t["narrow_dot_pairs"] <= t["dot_pairs"],
                  f"window designs, {label}, W={w}: tally {t}")
            rows[w] = dict(bit_equal=same, band_pairs=t["band_pairs"], dot_pairs=t["dot_pairs"],
                           narrow_dot_pairs=t["narrow_dot_pairs"],
                           fill_pct=100.0 * t["band_pairs"] / max(1, t["dot_pairs"]),
                           narrow_share_pct=100.0 * t["narrow_dot_pairs"] / max(1, t["dot_pairs"]),
                           ms=[])
        for _ in range(rounds):
            for w, lib in libs.items():
                launch(lib)
                flush.zero_()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                launch(lib)
                e.record()
                e.synchronize()
                rows[w]["ms"].append(s.elapsed_time(e))
        for r in rows.values():
            r["launch_ms"] = statistics.median(r["ms"])
        out[label] = dict(shape=f"B={b} N={n} F={f} k={K}", **{f"W={w}": r for w, r in rows.items()})
    return out


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


def http_get(url, timeout=120):
    """``(status, JSON body)`` of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_post(url, doc=None, raw=None, timeout=300):
    """``(status, JSON body, headers)`` of a POST of ``doc`` (or the bytes
    ``raw``)."""
    import urllib.error
    import urllib.request

    body = raw if raw is not None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def queued_together(svc, pendings, timeout=300):
    """Place ``pendings`` in the service's queue under its lock, so the
    collector cuts them together (a full ``max_batch``, or a backlog past
    ``adaptive_min_backlog``), then wait for every answer."""
    with svc._cv:
        svc._queue.extend(pendings)
        svc.queue_depth_peak = max(svc.queue_depth_peak, len(svc._queue))
        svc._cv.notify_all()
    for p in pendings:
        check(p.done.wait(timeout), "serve: a queued request was never answered")
    return pendings


def results_of(pending):
    """A request's answer as ``(ids [1, k], scores [1, k])`` arrays."""
    import numpy as np

    return (np.asarray([[r["index"] for r in pending.result]]),
            np.asarray([[r["score"] for r in pending.result]], np.float32))


def answers_bit_equal(pendings, idx, sc):
    """Each request's ids and score bits equal the direct call's row."""
    import numpy as np

    for p, i, s in zip(pendings, idx, sc):
        got_i, got_s = results_of(p)
        if not (np.array_equal(got_i[0], i) and np.array_equal(got_s[0].view(np.int32), s.view(np.int32))):
            return False
    return True


def http_burst(base, docs, clients, path="/search"):
    """POST each of ``docs`` from ``clients`` threads (each its share, in
    order): ``[(status, body)]`` in the order of ``docs`` and the wall
    seconds."""
    import threading

    out = [None] * len(docs)
    per = -(-len(docs) // clients)

    def client(c):
        for i in range(c * per, min(len(docs), (c + 1) * per)):
            code, body, _ = http_post(base + path, docs[i])
            out[i] = (code, body)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        check(not t.is_alive(), "serve: a client thread did not finish")
    return out, time.perf_counter() - t0


def blocked_dispatch(svc):
    """Make the service's dispatches wait for the returned event; the list
    counts the dispatches that reached the wait."""
    import threading

    release, entered = threading.Event(), []
    run = svc._run_batch

    def blocking(*a, **kw):
        entered.append(1)
        release.wait(600)
        return run(*a, **kw)

    svc._run_batch = blocking
    return release, entered


def wait_for(cond, what, timeout=120):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.002)


def serve_phase(dev, card, aspace, gl, X):
    """Phase 16, ``serve`` (module docstring), steps 1–3 and 6, on phase 2's
    index. Returns the launches of each step, each counted from 0 just
    before it and read just after."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import serve as sv
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops.kernels.tilemax import blend
    from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

    counts, services, servers = {}, [], []
    rng = np.random.default_rng(SEED_SERVE)
    rows = rng.choice(N_MAIN, BATCH, replace=False)
    alphas = np.asarray([SERVE_ALPHAS[i % len(SERVE_ALPHAS)] for i in range(BATCH)], np.float32)
    mn, rg = float(aspace.min_lambdas), float(aspace.range_lambdas)

    def own_scores(rows_, alphas_):
        """Each query's f32 blended score against its own row."""
        _, _, raw = aspace.search_batch(X[rows_], gl, 1, alphas_, return_raw=True)
        rt = torch.from_numpy(np.asarray(rows_)).to(dev)
        ql = torch.clamp((torch.from_numpy(raw).to(dev) - mn) / rg, 0.0, 1.0)
        Q = aspace.data[rt]
        qn = torch.sqrt(torch.sum(Q * Q, dim=-1))
        return blend(torch.sum(Q * Q, dim=-1), aspace.norms[rt] * qn, aspace.lambdas[rt], ql,
                     torch.from_numpy(np.asarray(alphas_, np.float32)).to(dev)).cpu().numpy()

    def start(svc):
        services.append(svc)
        srv = sv.serve(svc, port=0, block=False)
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    try:
        # -- 1. one dispatch for 256 mixed-alpha requests, by tier, in turns
        # (each tier, then each again in reverse order), beside the direct
        # search_batch of the same rows and alpha vector.
        svc = sv.IndexService(aspace, gl, batch_window_ms=5000, max_batch=BATCH)
        services.append(svc)
        one = {str(t): dict(ms=[], dispatch_ms=[], queue_wait_ms=[], direct_ms=[], launches=[],
                            bit_equal=True) for t, _ in SERVE_ONE_DISPATCH}
        for tier, kern in list(SERVE_ONE_DISPATCH) + list(reversed(SERVE_ONE_DISPATCH)):
            pend = [sv._Pending(svc._validate(X[r]), K, float(a), False, "blend", quantized=tier)
                    for r, a in zip(rows, alphas)]
            svc.reset_metrics()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            queued_together(svc, pend)
            ms = (time.perf_counter() - t0) * 1e3
            c = kernels.launch_counts()
            key = f"one_dispatch_{tier or 'exact'}"
            counts[key] = {k: v + counts.get(key, {}).get(k, 0) for k, v in c.items()}
            m = svc.metrics()
            errors = [repr(p.error) for p in pend if p.error is not None]
            check(not errors, f"serve {tier}: {errors[:2]}")
            (idx, sc), direct_s = _timed_call(lambda: aspace.search_batch(X[rows], gl, K, alphas,
                                                                          quantized=tier))
            same = answers_bit_equal(pend, idx, sc)
            rec = one[str(tier)]
            rec["ms"].append(ms)
            rec["dispatch_ms"].append(m["dispatch_p50_ms"])
            rec["queue_wait_ms"].append(m["queue_wait_p50_ms"])
            rec["direct_ms"].append(direct_s * 1e3)
            rec["launches"].append({k: v for k, v in c.items() if v})
            rec["bit_equal"] &= same
            check(svc.n_batches == 1, f"serve {tier}: {svc.n_batches} dispatches for one queue fill")
            check(all(c[k] == 1 for k in kern), f"serve {tier}: launches {c}, want each of {kern} once")
            check(same, f"serve {tier}: answers differ from the direct search_batch")

        # -- 2. an HTTP burst at the reference's defaults -----------------
        burst_svc = sv.IndexService(aspace, gl)
        base = start(burst_svc)
        n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
        brows = rng.choice(N_MAIN, n_req, replace=False)
        tiers = [("bf16x3_rescored" if i % 4 == 3 else False) for i in range(n_req)]
        ks = [K_WIDE[0] if i % (n_req // SERVE_K40) == 0 else K for i in range(n_req)]
        balphas = [SERVE_ALPHAS[i % len(SERVE_ALPHAS)] for i in range(n_req)]
        docs = [{"query": X[r].tolist(), "k": k, "alpha": a, "quantized": t}
                for r, k, a, t in zip(brows, ks, balphas, tiers)]
        # Each request's direct search_batch (at its tier, k and alpha, in
        # batches of 256) and its own row's blended score.
        direct = [None] * n_req
        groups = {}
        for i, (t, k) in enumerate(zip(tiers, ks)):
            groups.setdefault((t, k), []).append(i)
        for (t, k), members in groups.items():
            for s0 in range(0, len(members), BATCH):
                part = members[s0:s0 + BATCH]
                idx, sc = aspace.search_batch(X[brows[part]], gl, k,
                                              np.asarray([balphas[i] for i in part], np.float32),
                                              quantized=t)
                for j, i in enumerate(part):
                    direct[i] = (idx[j:j + 1], sc[j:j + 1])
        own = own_scores(brows, np.asarray(balphas, np.float32))

        def verify(answers, what):
            """Every status 200; each top-1 the own row or a score at least
            its own less 1e-5; each answer the direct one under the same-k
            rule."""
            codes = [code for code, _ in answers]
            check(all(code == 200 for code in codes),
                  f"serve {what}: statuses {sorted(set(codes))}: {[b for c, b in answers if c != 200][:2]}")
            bad_top, bad_direct = [], []
            for i, (_, body) in enumerate(answers):
                res = body["results"]
                gi = np.asarray([[r["index"] for r in res]])
                gs = np.asarray([[r["score"] for r in res]], np.float32)
                if gi[0, 0] != brows[i] and gs[0, 0] < own[i] - TOL_SCORE:
                    bad_top.append(int(brows[i]))
                bad_direct += same_k_mismatches(*direct[i], gi, gs, TOL_SCORE)
            check(not bad_top, f"serve {what}: {len(bad_top)} top-1 neither the own row nor its score")
            check(not bad_direct, f"serve {what}: answers vs direct search_batch: {bad_direct[:3]}")

        def burst_metrics(svc_, answers, wall):
            m = svc_.metrics()
            return dict(requests=len(answers), wall_seconds=wall, requests_per_s=len(answers) / wall,
                        batches_dispatched=svc_.n_batches,
                        **{k: m.get(k) for k in ("batch_occupancy", "latency_p50_ms", "latency_p99_ms",
                                                 "queue_wait_p50_ms", "queue_wait_p99_ms",
                                                 "dispatch_p50_ms", "dispatch_p99_ms", "latency_window",
                                                 "queue_depth_peak")})

        torch.cuda.synchronize()
        kernels.reset_launches()
        burst_svc.reset_metrics()
        answers, wall = http_burst(base, docs, SERVE_CLIENTS)
        c_burst = counts["burst"] = kernels.launch_counts()
        burst = burst_metrics(burst_svc, answers, wall)
        verify(answers, "burst")
        for kname in ("scores_tilemax", "subtile_topk", "tilemax_only", "slab_dots"):
            check(c_burst[kname] > 0, f"serve burst: kernel {kname} not launched")
        check(c_burst["gather_subtiles"] == 0, f"serve burst: the k={K_WIDE[0]} requests launched kernel C")
        # The same traffic's first SERVE_FEW_REQUESTS from SERVE_FEW_CLIENTS
        # threads: fewer Python threads in the process.
        burst_svc.reset_metrics()
        kernels.reset_launches()
        few_answers, few_wall = http_burst(base, docs[:SERVE_FEW_REQUESTS], SERVE_FEW_CLIENTS)
        counts["burst_few_clients"] = kernels.launch_counts()
        few = dict(clients=SERVE_FEW_CLIENTS, **burst_metrics(burst_svc, few_answers, few_wall))
        verify(few_answers, "few-client burst")
        burst_svc.reset_metrics()
        kernels.reset_launches()
        profile_ = profiled(lambda _: http_burst(base, docs, SERVE_CLIENTS), [None])
        counts["burst_profiled"] = kernels.launch_counts()
        profile_["batches_dispatched"] = burst_svc.n_batches
        profile_["metrics"] = burst_svc.metrics()

        # -- 3. error paths over HTTP ----------------------------------
        q0 = X[rows[0]].tolist()
        nan_body = b'{"query": [NaN' + b", 1" * (F_MAIN - 1) + b"]}"
        cases = [
            ("wrong dimension", "/search", {"query": [1.0, 2.0]}, None, 400,
             f"Query dimension 2 doesn't match index dimension {F_MAIN}"),
            ("NaN", "/search", None, nan_body, 400, "query item has non-finite values"),
            ("bad JSON", "/search", None, b'{"query": [1.0,', 400, "bad JSON body: "),
            ("alpha null", "/search", {"query": q0, "alpha": None}, None, 400, "'alpha' must be a number"),
            ("unknown tier", "/search", {"query": q0, "quantized": "int9"}, None, 400,
             "unknown or unserved quantized tier 'int9'"),
            ("bf16_rescored", "/search", {"query": q0, "quantized": "bf16_rescored"}, None, 400,
             "unknown or unserved quantized tier 'bf16_rescored'"),
            ("zero query", "/search", {"query": [0.0] * F_MAIN}, None, 422, "query raw λ is 0.0"),
            ("unknown path", "/nope", {"query": q0}, None, 404, "unknown path /nope"),
        ]
        errors = {}
        for name, path, doc, raw, want, text in cases:
            code, body, _ = http_post(base + path, doc, raw)
            errors[name] = dict(status=code, error=body.get("error", "")[:120])
            check(code == want and body.get("error", "").startswith(text),
                  f"serve {name}: {code} {body}, want {want} '{text}…'")
        code, body = http_get(base + "/nope")
        check(code == 404, f"serve GET /nope: {code}")
        # 429: a max_queue_depth=1 service with both dispatch slots held and
        # one request queued under the lock.
        full_svc = sv.IndexService(aspace, gl, max_queue_depth=1, batch_window_ms=1.0)
        release, entered = blocked_dispatch(full_svc)
        full_base = start(full_svc)
        held = [sv._Pending(full_svc._validate(X[r]), K, ALPHA, False, "blend") for r in rows[:3]]
        try:
            for i, p in enumerate(held[:2]):
                with full_svc._cv:
                    full_svc._queue.append(p)
                    full_svc._cv.notify_all()
                wait_for(lambda: len(entered) == i + 1, f"dispatch {i + 1} of the 429 check")
            with full_svc._cv:
                full_svc._queue.append(held[2])
            code, body, headers = http_post(full_base + "/search", {"query": q0})
        finally:
            release.set()
        for p in held:
            check(p.done.wait(300) and p.error is None, f"serve 429: a held request failed: {p.error}")
        errors["full queue"] = dict(status=code, error=body.get("error", ""),
                                    retry_after=headers.get("Retry-After"))
        check(code == 429 and headers.get("Retry-After") == "1"
              and body.get("error") == "queue depth 1 at the admission bound (1); retry with backoff",
              f"serve full queue: {code} {body} {headers.get('Retry-After')}")

        # -- 6. close ------------------------------------------------------
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        servers.clear()
        for s in services:
            s.close()
        closed = []
        for s in services:
            try:
                s.search(X[rows[0]], k=K)
                closed.append(False)
            except RuntimeError as exc:
                closed.append("closed" in str(exc))
        check(all(closed), f"serve: a closed service answered: {closed}")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for s in services:
            s.close()

    emit(phase="serve", step="in_memory", card=card, n=N_MAIN, f=F_MAIN, k=K, alphas=SERVE_ALPHAS,
         one_dispatch=one,
         burst=dict(clients=SERVE_CLIENTS, per_client=SERVE_PER_CLIENT,
                    bf16x3_share=tiers.count("bf16x3_rescored") / n_req, k40_requests=ks.count(K_WIDE[0]),
                    **burst, launches=c_burst, profile=profile_),
         burst_few_clients=few, errors=errors, closed_services=len(services))
    return counts


def serve_energy_step(dev, card, aspace, gl, X):
    """Phase 16's energy step, on phase 12's index: ``/search_energy`` on
    the full scan and with ``energy_candidates="auto"``, and ``/search``
    through kernel B and the candidate stage. Returns the launches."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import energymaps as em
    from matternet_rs_tpu_torch import serve as sv
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches

    rows = np.random.default_rng(SEED_SERVE + 1).choice(len(X), BATCH, replace=False)
    counts, out = {}, {}
    for cand in (None, "auto"):
        svc = sv.IndexService(aspace, gl, energy_candidates=cand)
        srv = sv.serve(svc, port=0, block=False)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            docs = [{"query": X[r].tolist(), "k": K} for r in rows]
            torch.cuda.synchronize()
            kernels.reset_launches()
            answers, wall = http_burst(base, docs, SERVE_ENERGY_CLIENTS, path="/search_energy")
            counts[f"search_energy_{cand}"] = kernels.launch_counts()
            check(all(code == 200 for code, _ in answers), f"serve energy ({cand}): non-200 answers")
            c = counts[f"search_energy_{cand}"]
            check(c["energy_scan"] == c["search_fused_merge"] == 0
                  and (cand is not None or c["energy_window"] == svc.n_batches),
                  f"serve energy ({cand}): {c['energy_window']} energy windows, "
                  f"{c['energy_scan']} energy scans, {c['search_fused_merge']} merges, "
                  f"{svc.n_batches} batches")
            idx, dist = em.search_energy_batch(aspace, X[rows], gl, K, candidates=cand)
            bad = []
            for j, (_, body) in enumerate(answers):
                gi = np.asarray([[r["index"] for r in body["results"]]])
                gd = np.asarray([[r["distance"] for r in body["results"]]])
                bad += same_k_mismatches(idx[j:j + 1], dist[j:j + 1], gi, gd, ENERGY_TIE_TOL)
            out[f"search_energy_{cand}"] = dict(wall_seconds=wall, requests_per_s=len(docs) / wall,
                                               batches=svc.n_batches, metrics=svc.metrics(),
                                               mismatches=bad[:3])
            check(not bad, f"serve energy ({cand}): vs search_energy_batch: {bad[:3]}")
            if cand is None:
                # /search on the energy index: kernel B and the candidate stage.
                docs = [{"query": X[r].tolist(), "k": K, "alpha": ALPHA} for r in rows]
                b0 = svc.n_batches
                torch.cuda.synchronize()
                kernels.reset_launches()
                answers, wall = http_burst(base, docs, SERVE_ENERGY_CLIENTS)
                c = counts["search"] = kernels.launch_counts()
                check(all(code == 200 for code, _ in answers), "serve energy /search: non-200 answers")
                idx, sc = aspace.search_batch(X[rows], gl, K, ALPHA)
                bad = []
                for j, (_, body) in enumerate(answers):
                    gi = np.asarray([[r["index"] for r in body["results"]]])
                    gs = np.asarray([[r["score"] for r in body["results"]]], np.float32)
                    bad += same_k_mismatches(idx[j:j + 1], sc[j:j + 1], gi, gs, TOL_SCORE)
                out["search"] = dict(wall_seconds=wall, batches=svc.n_batches - b0, launches=c,
                                     mismatches=bad[:3])
                check(not bad, f"serve energy /search: vs search_batch: {bad[:3]}")
                for kname in ("scores_tilemax", "subtile_topk"):
                    check(c[kname] > 0, f"serve energy /search: kernel {kname} not launched")
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
    emit(phase="serve", step="energy", card=card, n=len(X), requests=BATCH,
         clients=SERVE_ENERGY_CLIENTS, **out, launches=counts)
    return counts


def serve_streaming_step(dev, card, sidx, queries):
    """Phase 16's streaming step, on phase 11's index: a
    ``StreamingIndexService`` over its resident sketch, 256 requests
    refined and 256 sketch-only, each placed in the queue together and
    held bit for bit against ``search_batch_sketch``. Returns the launches."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import serve as sv
    from matternet_rs_tpu_torch.ops import kernels

    alphas = np.asarray([SERVE_ALPHAS[i % len(SERVE_ALPHAS)] for i in range(BATCH)], np.float32)
    t0 = time.perf_counter()
    svc = sv.StreamingIndexService(sidx, batch_window_ms=5000, max_batch=BATCH)
    start_s = time.perf_counter() - t0
    counts, out = {}, {}
    try:
        for approx in (False, True):
            mode = "sketch_only" if approx else "refined"
            pend = [sv._Pending(svc._validate(q), K, float(a), approx, "blend")
                    for q, a in zip(queries, alphas)]
            torch.cuda.synchronize()
            kernels.reset_launches()
            t1 = time.perf_counter()
            queued_together(svc, pend)
            ms = (time.perf_counter() - t1) * 1e3
            c = counts[mode] = kernels.launch_counts()
            errors = [repr(p.error) for p in pend if p.error is not None]
            check(not errors, f"serve streaming {mode}: {errors[:2]}")
            idx, sc = sidx.search_batch_sketch(queries, K, alphas, refine=not approx)
            same = answers_bit_equal(pend, idx, sc)
            out[mode] = dict(ms=ms, launches=c, bit_equal=same)
            check(same, f"serve streaming {mode}: answers differ from search_batch_sketch")
            check(c["tilemax_only"] == 1 and c["slab_dots"] == 1,
                  f"serve streaming {mode}: kernels D and E must launch once each: {c}")
        info = svc.info()
    finally:
        svc.close()
    emit(phase="serve", step="streaming", card=card, n=sidx.n_items, f=sidx.n_features,
         requests=BATCH, service_start_seconds=start_s, info_keys=sorted(info), **out)
    return counts


# The CLI's runner: ``python -m matternet_rs_tpu_torch`` (the package's
# ``__main__`` run as the main module) with its kernel launch counts
# written to the file named by the first argument at exit, also when
# stopped by SIGTERM.
CLI_RUNNER = """\
import atexit, json, runpy, signal, sys
from matternet_rs_tpu_torch.ops import kernels
out = sys.argv.pop(1)
def dump():
    with open(out, "w") as f:
        json.dump(kernels.launch_counts(), f)
atexit.register(dump)
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
sys.argv[0] = "matternet_rs_tpu_torch"
runpy.run_module("matternet_rs_tpu_torch", run_name="__main__", alter_sys=True)
"""


def cli_phase(dev, card, X):
    """Phase 17, ``cli`` (module docstring), on phase 2's rows. Returns the
    launches of each subcommand's process."""
    import socket
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from matternet_rs_tpu_torch.storage import parquet as pq

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    n_cli = N_CLI
    cut = None if n_cli == len(X) else f"{n_cli:,} of {len(X):,} rows for the run's time limit"
    counts, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="mrs-cli-") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "data.npy", X[:n_cli])
        qrows = np.random.default_rng(SEED_SERVE + 2).choice(n_cli, CLI_QUERIES + CLI_POSTS, replace=False)
        np.save(tmp / "q.npy", X[qrows[:CLI_QUERIES]])
        idx_dir = tmp / "idx"

        def run(name, args, timeout):
            """One subcommand's process: its JSON output (``info`` prints the
            metadata file, several lines; the others one line last)."""
            cfile = tmp / f"{name}.counts.json"
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", CLI_RUNNER, str(cfile), *args], cwd=repo,
                                 env=env, capture_output=True, text=True, timeout=timeout)
            seconds[name] = time.perf_counter() - t0
            check(out.returncode == 0, f"cli {name}: rc {out.returncode}: {out.stderr[-2000:]}")
            counts[name] = json.loads(cfile.read_text())
            return json.loads(out.stdout if name == "info" else out.stdout.strip().splitlines()[-1])

        built = run("build", ["build", str(tmp / "data.npy"), "--out", str(idx_dir), "--name", "cli",
                              "--max-clusters", str(CLI_CLUSTERS), "--radius", "25"], 900)
        check(built["status"] == "built" and built["n_items"] == n_cli, f"cli build: {built}")
        check(counts["build"]["taumode"] > 0, f"cli build: kernel A not launched: {counts['build']}")
        ckpt_bytes = sum(p.stat().st_size for p in idx_dir.iterdir())
        meta = run("info", ["info", str(idx_dir), "--name", "cli"], 300)
        check(meta["arrowspace"]["nitems"] == n_cli, "cli info: wrong item count")
        found = run("search", ["search", str(idx_dir), "--name", "cli", "--query", str(tmp / "q.npy"),
                               "--k", str(K)], 600)
        tops = [row[0]["index"] for row in found["results"]]
        check(tops == qrows[:CLI_QUERIES].tolist(), f"cli search: top-1 {tops}, want {qrows[:CLI_QUERIES]}")

        # serve: poll /health, POST, compare with the checkpoint searched here.
        aspace_c, gl_c = pq.load_arrowspace(idx_dir, "cli")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cfile = tmp / "serve.counts.json"
        t0 = time.perf_counter()
        err_path = tmp / "serve.stderr"
        with open(err_path, "w") as err:
            proc = subprocess.Popen([sys.executable, "-c", CLI_RUNNER, str(cfile), "serve", str(idx_dir),
                                     "--name", "cli", "--port", str(port)], cwd=repo, env=env,
                                    stdout=subprocess.DEVNULL, stderr=err)
        base = f"http://127.0.0.1:{port}"
        try:
            healthy = False
            while not healthy:
                check(proc.poll() is None, f"cli serve exited: {err_path.read_text()[-2000:]}")
                check(time.perf_counter() - t0 < 600, "cli serve: no /health within 600 s")
                try:
                    healthy = http_get(base + "/health", timeout=5)[1]["status"] == "ok"
                except OSError:
                    time.sleep(0.2)
            seconds["serve_ready"] = time.perf_counter() - t0
            bad = []
            for j, r in enumerate(qrows[CLI_QUERIES:]):
                a = SERVE_ALPHAS[j % len(SERVE_ALPHAS)]
                code, body, _ = http_post(base + "/search", {"query": X[r].tolist(), "k": K, "alpha": a})
                ids, sc = aspace_c.search_batch(X[r], gl_c, K, np.float32([a]))
                got = (np.asarray([x["index"] for x in body.get("results", [])]),
                       np.asarray([x["score"] for x in body.get("results", [])], np.float32))
                if code != 200 or not (np.array_equal(got[0], ids[0])
                                       and np.array_equal(got[1].view(np.int32), sc[0].view(np.int32))):
                    bad.append(int(r))
            check(not bad, f"cli serve: answers differ from the in-process search for rows {bad}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        seconds["serve"] = time.perf_counter() - t0
        counts["serve"] = json.loads(cfile.read_text())
        del aspace_c, gl_c
    torch.cuda.empty_cache()
    emit(phase="cli", card=card, n=n_cli, f=X.shape[1], cut=cut, clusters=CLI_CLUSTERS,
         seconds=seconds, checkpoint_bytes=ckpt_bytes, build=built, posts=CLI_POSTS,
         queries=CLI_QUERIES, launches=counts)
    return counts


def models_phase(dev, card, X):
    """Phase 18, ``models`` (module docstring). Returns the launches of
    each step and, for kernels D and E, of each tier."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import pipeline
    from matternet_rs_tpu_torch.models import EigenIndex, EnergyIndex, SurffaceModel
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset, make_gaussian_hd

    counts, out = {}, {}

    def fit(name, model, rows):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        model.fit(rows)
        torch.cuda.synchronize()
        counts[name] = kernels.launch_counts()
        return time.perf_counter() - t0

    # EigenIndex at the headline size, every servable tier.
    ei = EigenIndex(eps=1.0, k=6, max_clusters=250, radius=25.0)
    eigen_s = fit("eigen_fit", ei, X)
    lam = ei.lambdas
    check(isinstance(lam, np.ndarray) and lam.shape == (len(X),) and np.all(np.isfinite(lam))
          and lam.min() >= 0.0 and lam.max() <= 1.0, "models: EigenIndex.lambdas is not N values in [0, 1]")
    check(counts["eigen_fit"]["taumode"] > 0, "models: EigenIndex.fit did not launch kernel A")
    rows = np.random.default_rng(SEED_SERVE + 3).choice(len(X), BATCH, replace=False)
    sp = ei.aspace
    _, _, raw = sp.search_batch(X[rows], ei.gl, 1, ALPHA, return_raw=True)
    rt = torch.from_numpy(rows).to(dev)
    ql = torch.clamp((torch.from_numpy(raw).to(dev) - sp.min_lambdas) / sp.range_lambdas, 0.0, 1.0)
    own = _blended(sp, sp.data[rt], ql, rt[:, None])[:, 0].cpu().numpy()
    tiers = {}
    for tier in MODEL_TIERS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        idx, sc = ei.query_batch(X[rows], k=K, quantized=tier)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = counts[f"query_batch_{tier}"] = kernels.launch_counts()
        first = idx[:, 0] == rows
        tied = ~first & (sc[:, 0] >= own - TOL_SCORE)
        tiers[str(tier)] = dict(ms=ms, own_row_first=int(first.sum()), tied_first=int(tied.sum()),
                                launches=c)
        check(bool(np.all(first | tied)), f"models: query_batch({tier!r}): {int((~first & ~tied).sum())} "
              "queries whose own row is not first (nor tied with the first)")
    n_clusters = sp.n_clusters
    del ei, sp

    # EnergyIndex, cut to 200,000 rows.
    Xe = make_energy_test_dataset(N_MODELS_ENERGY, F_MAIN, seed=SEED_ENERGY).astype(np.float32)
    en = EnergyIndex(eps=1.0, k=6, max_clusters=max(64, int(2 * N_MODELS_ENERGY**0.5) // 8), radius=25.0)
    energy_s = fit("energy_fit", en, Xe)
    erows = rows[:N_ENERGY_SERIAL] % N_MODELS_ENERGY
    hits = [int(r) in [i for i, _ in en.query(Xe[r], k=K)] for r in erows]
    check(all(hits), f"models: EnergyIndex.query misses {hits.count(False)} own rows")
    check(en.lambdas.shape == (N_MODELS_ENERGY,) and np.all(np.isfinite(en.lambdas)),
          "models: EnergyIndex.lambdas")
    del en, Xe

    # SurffaceModel on phase pipeline's fixture at cap 3,000, MST k = 32.
    Xp = make_gaussian_hd(N_PIPELINE, 0.3).astype(np.float32)
    sm = SurffaceModel(config=pipeline.PipelineConfig(
        clustering=pipeline.ClusteringConfig(max_clusters=PIPELINE_CAPS[1]),
        mst=pipeline.MSTConfig(k_neighbors=PIPELINE_MST_K)))
    surf_s = fit("surfface_fit", sm, Xp)
    check(isinstance(sm.centroids, np.ndarray) and sm.centroids.shape[1] == Xp.shape[1]
          and sm.lambdas.shape == (N_PIPELINE,) and np.all(np.isfinite(sm.lambdas)),
          "models: SurffaceModel's centroids or λ")
    out = dict(eigen=dict(n=len(X), fit_seconds=eigen_s, n_clusters=n_clusters, tiers=tiers),
               energy=dict(n=N_MODELS_ENERGY, fit_seconds=energy_s, own_row_hits=sum(hits),
                           queries=len(hits)),
               surfface=dict(n=N_PIPELINE, cap=PIPELINE_CAPS[1], mst_k=PIPELINE_MST_K,
                             fit_seconds=surf_s, centroids=int(sm.centroids.shape[0])))
    del sm, Xp
    torch.cuda.empty_cache()
    emit(phase="models", card=card, **out, launches=counts,
         cut=[f"EnergyIndex at {N_MODELS_ENERGY:,} of 1,000,000 rows",
              f"SurffaceModel at {N_PIPELINE:,} rows, cap {PIPELINE_CAPS[1]:,}: the run's time limit"])
    return counts


MESH_SLOTS = 4                # slots placed on the one card (the card listed 4 times)
MESH_SPECTRAL_N, MESH_SPECTRAL_K, MESH_LOBPCG_ITERS = 100_000, 8, 100
MESH_LLOYD_ITERS = 10
MESH_STORE_CLUSTERS = 111     # phase jl's build at 200,000 × 768 takes 111 clusters
MESH_CLI_ROWS = 200_000       # the CLI's store: phase 2's first rows


def _mesh(dev, d):
    """``d`` slots on ``dev`` (the device listed ``d`` times)."""
    from matternet_rs_tpu_torch.parallel import make_mesh

    return make_mesh(d, devices=[dev] * d)


def _counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: ``(output, seconds, counts)``."""
    import torch

    from matternet_rs_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, kernels.launch_counts()


def _same_rows(ref_i, ref_s, got_i, got_s):
    """``("bit-equal", [])`` when ids and score bits agree, else
    ``("near-tie rule", failures)`` under the same-k rule at 1e-5."""
    import numpy as np

    from matternet_rs_tpu_torch.utils.parity import same_k_mismatches

    ref_s, got_s = np.asarray(ref_s, np.float32), np.asarray(got_s, np.float32)
    if np.array_equal(ref_i, got_i) and np.array_equal(ref_s.view(np.int32), got_s.view(np.int32)):
        return "bit-equal", []
    return "near-tie rule", same_k_mismatches(ref_i, ref_s, got_i, got_s, TOL_SCORE)


def _recall(got, ref):
    import numpy as np

    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(got.tolist(), ref.tolist())]))


def mesh_store_step(dev, card, store, Xj, qrows):
    """Phase mesh, the store build (inside phase shards, on its store)."""
    import socket

    import numpy as np
    import torch

    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.parallel import distributed, make_mesh
    from matternet_rs_tpu_torch.storage import shards

    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)
    kw = dict(k_clusters=MESH_STORE_CLUSTERS, radius=25.0)
    counts, secs = {}, {}
    sa, secs["store_build_d4"], counts["store_build_d4"] = _counted(
        lambda: shards.distributed_build_from_store(store, params, mesh=_mesh(dev, MESH_SLOTS), **kw))
    Q = Xj[qrows]
    (ids4, sc4), secs["store_search_d4"], counts["store_search_d4"] = _counted(
        lambda: sa.search_batch(Q, K))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = distributed.initialize(f"localhost:{port}", 1, 0)
    try:
        mesh1 = make_mesh(1)
        backend = torch.distributed.get_backend()
        check(mesh1.spans_processes and backend == "nccl", f"mesh: the group is {backend}")
        sa1, secs["store_build_nccl"], counts["store_build_nccl"] = _counted(
            lambda: shards.distributed_build_from_store(store, params, mesh=mesh1, **kw))
        (ids1, sc1), secs["store_search_nccl"], counts["store_search_nccl"] = _counted(
            lambda: sa1.search_batch(Q, K))
        lam4, lam1 = sa.lambdas.gather()[:len(Xj)], sa1.lambdas.gather()[:len(Xj)]
    finally:
        distributed.shutdown()
    lam_rel = float(((lam4 - lam1).abs() / torch.clamp(lam1.abs(), min=1.0)).max())
    rule, bad = _same_rows(ids1, sc1, ids4, sc4)
    self_found = float(np.mean(ids4[:, 0] == qrows))
    out = dict(nccl=info, backend=backend, lambda_d4_vs_nccl_d1_max_rel=lam_rel,
               lambda_bit_equal=bool(torch.equal(lam4, lam1)), results_d4_vs_nccl_d1=rule,
               self_top1=self_found, n=sa.n_items, f=int(sa.X.shape[1]),
               min_lambdas=sa.min_lambdas, range_lambdas=sa.range_lambdas)
    check(lam_rel <= TOL_LAMBDA, f"mesh store: λ at D=4 vs the NCCL D=1 build {lam_rel}")
    check(not bad, f"mesh store: D=4 vs NCCL D=1 results: {bad[:3]}")
    check(self_found == 1.0, f"mesh store: top-1 is the query row for {self_found:.3f} of rows")
    for step in ("store_build_d4", "store_build_nccl"):
        check(counts[step]["taumode"] > 0, f"mesh {step}: kernel A not launched")
    check(counts["store_search_d4"]["scores_tilemax"] == MESH_SLOTS,
          f"mesh store search: kernel B launches {counts['store_search_d4']}")
    emit(phase="mesh", step="store", card=card, slots=MESH_SLOTS, seconds=secs,
         launches=counts, **out)
    del sa, sa1
    torch.cuda.empty_cache()
    return counts


def mesh_sketch_step(dev, card, sidx, Qs):
    """Phase mesh, the sharded sketch (inside phase streaming, on its
    index)."""
    import torch

    from matternet_rs_tpu_torch import serve as tsv
    from matternet_rs_tpu_torch.parallel import ShardedSketch

    counts, secs, out = {}, {}, {}
    mesh = _mesh(dev, MESH_SLOTS)
    sk, secs["place"], _ = _counted(lambda: ShardedSketch(sidx, mesh))
    Q = Qs[1]

    def single(maxfirst, refine):
        sidx.sketch_maxfirst = maxfirst
        try:
            return sidx.search_batch_sketch(Q, K, alpha=ALPHA, refine=refine)
        finally:
            sidx.sketch_maxfirst = None

    for refine in (False, True):
        tag = "refined" if refine else "sketch_only"
        sk.sketch_maxfirst = None
        sk.search_batch(Qs[0], K, ALPHA, refine=refine)
        (gi, gs), secs[f"carry_{tag}"], counts[f"carry_{tag}"] = _counted(
            lambda: sk.search_batch(Q, K, ALPHA, refine=refine))
        ri, rs = single(False, refine)
        out[f"carry_{tag}_vs_single_card_carry"] = _same_rows(ri, rs, gi, gs)[0]
        check(out[f"carry_{tag}_vs_single_card_carry"] == "bit-equal",
              f"mesh sketch: the sharded carry scan ({tag}) is not the single card's bit for bit")
        check(counts[f"carry_{tag}"]["tilemax_only"] == 0, "mesh sketch: the carry scan launched D")
        sk.sketch_maxfirst = True
        sk.search_batch(Qs[0], K, ALPHA, refine=refine)
        (fi, _), secs[f"maxfirst_{tag}"], counts[f"maxfirst_{tag}"] = _counted(
            lambda: sk.search_batch(Q, K, ALPHA, refine=refine))
        mi, _ = single(None, refine)
        out[f"maxfirst_{tag}_recall10_vs_single_card_maxfirst"] = _recall(fi, mi)
        out[f"maxfirst_{tag}_recall10_vs_carry"] = _recall(fi, ri)
        c = counts[f"maxfirst_{tag}"]
        check(c["tilemax_only"] == MESH_SLOTS and c["slab_dots"] == MESH_SLOTS,
              f"mesh sketch maxima-first ({tag}): D/E launches {c}")
    out["hbm_bytes_per_device"] = sk.hbm_bytes_per_device
    out["single_card_sketch_bytes"] = sum(t.numel() * t.element_size() for t in sidx._sketch)
    check(out["maxfirst_refined_recall10_vs_carry"] >= 0.95,
          f"mesh sketch: maxima-first refined recall {out['maxfirst_refined_recall10_vs_carry']}")
    del sk
    torch.cuda.empty_cache()
    # One request through the service over the sharded sketch.
    t0 = time.perf_counter()
    svc = tsv.StreamingIndexService(sidx, mesh=mesh)
    try:
        secs["service_start"] = time.perf_counter() - t0
        info = svc.info()
        q = Q[3].cpu().numpy()
        res, secs["served_request"], counts["served"] = _counted(lambda: svc.search(q, k=K))
        sidx.sketch_maxfirst = False            # the sharded auto route: the carry scan
        try:
            ri, _ = sidx.search_batch_sketch(q[None], K, alpha=0.7)
        finally:
            sidx.sketch_maxfirst = None
        check(info["mesh_devices"] == MESH_SLOTS and [r["index"] for r in res] == ri[0].tolist(),
              f"mesh service: {info['mesh_devices']} slots, answer {[r['index'] for r in res]}")
    finally:
        svc.close()
    emit(phase="mesh", step="sketch", card=card, n=sidx.n_items, f=sidx.n_features,
         slots=MESH_SLOTS, seconds=secs, launches=counts, **out)
    torch.cuda.empty_cache()
    return counts


def mesh_phase(dev, card, aspace, gl, X, batches, results):
    """Phase mesh (module docstring) on phase 2's index and rows. Returns
    the launches of each step and the arguments of one slot's kernel-F
    rows call (for the kernels line)."""
    import socket
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from matternet_rs_tpu_torch import ArrowSpace, pipeline
    from matternet_rs_tpu_torch import __main__ as cli
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
    from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.parallel import knn_graph as kg
    from matternet_rs_tpu_torch.parallel import make_mesh
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.parallel.search import merge_topk
    from matternet_rs_tpu_torch.pipeline import spectral
    from matternet_rs_tpu_torch.storage import shards
    from matternet_rs_tpu_torch.utils.fixtures import make_gaussian_hd

    counts, secs, out = {}, {}, {}
    n = aspace.nitems
    meshes = {d: _mesh(dev, d) for d in (1, MESH_SLOTS)}
    sas = {d: ShardedArrowSpace.from_arrowspace(aspace, gl, mesh=m) for d, m in meshes.items()}
    sa4 = sas[MESH_SLOTS]

    # 1. The exact tier at D = 1 and D = 4 against phase 2's results.
    agree = {}
    for d, sa in sas.items():
        sa.search_batch(X[batches[0]], K, ALPHA)
        agree[f"d{d}"] = []
        for i, (r, idx, sc, _) in enumerate(results[1:], 1):
            (gi, gs), _, c = _counted(lambda: sa.search_batch(X[r], K, ALPHA))
            counts[f"exact_d{d}_batch{i}"] = c
            rule, bad = _same_rows(idx, sc, gi, gs)
            check(not bad, f"mesh exact D={d} batch {i}: {bad[:3]}")
            check(c["scores_tilemax"] == d and c["subtile_topk"] == d and c["gather_subtiles"] == 0,
                  f"mesh exact D={d}: launches {c}")
            agree[f"d{d}"].append(rule)
    out["exact_vs_single_card"] = agree
    (_, _), _, counts["exact_k40"] = _counted(lambda: sa4.search_batch(X[batches[1]], K_WIDE[0], ALPHA))
    check(counts["exact_k40"]["subtile_topk"] == MESH_SLOTS and counts["exact_k40"]["gather_subtiles"] == 0,
          f"mesh k={K_WIDE[0]}: the wide stage must launch once a slot and kernel C never: {counts['exact_k40']}")

    # 2. The rescored tiers at D = 4: recall@10 against the exact ids.
    out["recall10_vs_exact"] = {}
    for tier in ("bf16x3_rescored", "int8_rescored"):
        sa4.search_batch(X[batches[0]], K, ALPHA, quantized=tier)
        rec = []
        for i, (r, idx, _, _) in enumerate(results[1:], 1):
            (gi, _), _, c = _counted(lambda: sa4.search_batch(X[r], K, ALPHA, quantized=tier))
            counts[f"{tier}_d{MESH_SLOTS}_batch{i}"] = c
            check(c["tilemax_only"] == MESH_SLOTS and c["slab_dots"] == MESH_SLOTS,
                  f"mesh {tier}: launches {c}")
            rec.append(_recall(gi, idx))
        out["recall10_vs_exact"][tier] = float(np.mean(rec))
    check(out["recall10_vs_exact"]["bf16x3_rescored"] >= MIN_RECALL_BF16X3,
          f"mesh bf16x3_rescored recall {out['recall10_vs_exact']}")

    # 3. ms a batch in turns (single card, D = 1, D = 4, then back), a
    # profile of each route, and the merge's own time.
    routes = {"single_card": lambda r: aspace.search_batch(X[r], gl, k=K, alpha=ALPHA),
              "d1": lambda r: sas[1].search_batch(X[r], K, ALPHA),
              f"d{MESH_SLOTS}": lambda r: sa4.search_batch(X[r], K, ALPHA)}
    ms = {k: [] for k in routes}
    for name in list(routes) + list(reversed(routes)):
        for r in batches[1:]:
            _, s, _ = _counted(lambda: routes[name](r))
            ms[name].append(s * 1e3)
    out["ms_per_batch"] = {k: statistics.median(v) for k, v in ms.items()}
    out["profile"] = {k: profiled(fn, batches[1:]) for k, fn in routes.items()}
    s_m = torch.randn((BATCH, MESH_SLOTS * K), device=dev)
    i_m = torch.randint(0, n, (BATCH, MESH_SLOTS * K), device=dev)
    merge_ms = []
    for _ in range(21):
        st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        st.record()
        merge_topk(s_m, i_m, K)
        en.record()
        en.synchronize()
        merge_ms.append(st.elapsed_time(en))
    out["merge_ms"] = statistics.median(merge_ms[1:])

    # Kernels B and D on the last slot's rows (the padding past mask_from)
    # against their plain versions.
    last = MESH_SLOTS - 1
    Xl, nl, ll = (a.shards[last] for a in (sa4.X, sa4.norms, sa4.lambdas))
    per = sa4.X.per
    mf = n - last * per
    Q = torch.from_numpy(X[batches[1]]).to(dev)
    ql = sa4.prepare_query_lambdas_batch(Q)
    al = torch.full((BATCH,), ALPHA, device=dev)
    sk_, mk_ = tmk.scores_and_tilemax(Xl, nl, ll, Q, ql, al, mask_from=mf)
    sp_, mp_ = tmk.scores_and_tilemax_plain(Xl, nl, ll, Q, ql, al, mask_from=mf)
    fin = torch.isfinite(sp_)
    X8, mult = (a.shards[last] for a in sa4._ensure_int8())
    md = rsk.tilemax_only(X8, nl, ll, Q, ql, al, subs=so.RESCORE_SUBS, rn=mult, mask_from=mf)
    mdp = rsk.tilemax_only_plain(X8, nl, ll, Q, ql, al, subs=so.RESCORE_SUBS, rn=mult, mask_from=mf)
    fin_d = torch.isfinite(mdp)
    out["slot_kernels"] = dict(
        slot=last, rows=per, mask_from=mf,
        scores_tilemax_max_abs_err=float((sk_[fin] - sp_[fin]).abs().max()),
        scores_masked_alike=bool(torch.equal(torch.isfinite(sk_), fin)),
        tilemax_only_int8_max_abs_err=float((md[fin_d] - mdp[fin_d]).abs().max()),
        maxima_masked_alike=bool(torch.equal(torch.isfinite(md), fin_d)))
    sk_chk = out["slot_kernels"]
    check(sk_chk["scores_tilemax_max_abs_err"] <= TOL_SCORE and sk_chk["scores_masked_alike"]
          and sk_chk["tilemax_only_int8_max_abs_err"] <= TOL_SCORE and sk_chk["maxima_masked_alike"],
          f"mesh slot kernels: {sk_chk}")
    del sk_, mk_, sp_, mp_, md, mdp, X8, mult

    # 4. distributed_build from 4 host blocks (serial centroids): λ against
    # the single-card index of the same rows and graph; Lloyd timed apart.
    blocks = np.array_split(X, 4)
    params = GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False)
    kw = dict(k_clusters=max(64, int(2 * n ** 0.5) // 8), radius=25.0)
    sb, secs["distributed_build_serial"], counts["distributed_build_serial"] = _counted(
        lambda: ShardedArrowSpace.distributed_build(blocks, params, mesh=meshes[MESH_SLOTS], **kw))
    one = ArrowSpace.from_items(X, device=dev)
    _, secs["single_card_lambda"], _ = _counted(lambda: one.compute_taumode(sb.gl))
    lam_m, lam_1 = sb.lambdas.gather()[:n], one.lambdas
    out["distributed_build"] = dict(
        lambda_max_rel=float(((lam_m - lam_1).abs() / torch.clamp(lam_1.abs(), min=1.0)).max()),
        lambda_bit_equal=bool(torch.equal(lam_m, lam_1)),
        graph_equals_the_builders=bool(torch.equal(sb.gl.matrix, gl.matrix)),
        stats_mesh=[sb.min_lambdas, sb.range_lambdas], stats_single=[one.min_lambdas,
                                                                     one.range_lambdas])
    check(out["distributed_build"]["lambda_max_rel"] <= TOL_LAMBDA,
          f"mesh distributed_build: λ vs the single card {out['distributed_build']}")
    check(counts["distributed_build_serial"]["taumode"] == MESH_SLOTS,
          f"mesh distributed_build: kernel A launches {counts['distributed_build_serial']}")
    del one, sb, lam_m, lam_1
    _, secs["distributed_build_lloyd"], counts["distributed_build_lloyd"] = _counted(
        lambda: ShardedArrowSpace.distributed_build(blocks, params, mesh=meshes[MESH_SLOTS],
                                                    centroids="lloyd",
                                                    lloyd_iters=MESH_LLOYD_ITERS, **kw))
    del blocks
    torch.cuda.empty_cache()

    # 5. The spectral embedding at 100,000 × 128 over 4 slots.
    ss = ShardedArrowSpace.from_shards([X[:MESH_SPECTRAL_N]], gl, mesh=meshes[MESH_SLOTS])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ell, secs["knn_ell"], counts["knn_ell"] = _counted(
        lambda: kg.distributed_knn_ell_laplacian(ss.mesh, ss.X, ss.n_items, gl.graph_params,
                                                 reverse_k="auto"))
    peak = torch.cuda.max_memory_allocated(dev) - base
    (vals, _, res), secs["lobpcg"], counts["lobpcg"] = _counted(
        lambda: kg.distributed_lobpcg(ss.mesh, ell, MESH_SPECTRAL_K, iters=MESH_LOBPCG_ITERS,
                                      return_residuals=True))
    scale = max(abs(float(vals[-1])), 1e-3)
    # Every block the solver's matvec applies to slot 1's rows, from a
    # second solve outside the timed and counted one, held bit for bit
    # against the plain version on the same block.
    per = ell.indices.per
    applied, launch = [], fk.spmv_ell

    def capturing(idx, w, Vl, d=None, row0=0, *, checked=False):
        got = launch(idx, w, Vl, d, row0, checked=checked)
        if row0 == per:
            applied.append((Vl.clone(), got.clone()))
        return got

    fk.spmv_ell = capturing
    try:
        kg.distributed_lobpcg(ss.mesh, ell, MESH_SPECTRAL_K, iters=MESH_LOBPCG_ITERS)
    finally:
        fk.spmv_ell = launch
    slot_ops = (ell.indices.shards[1], ell.weights.shards[1])
    rows_unequal = [i for i, (Vb, got) in enumerate(applied) if not torch.equal(
        got, fk.spmv_ell_plain(*slot_ops, Vb, ell.diag.shards[1], per))]
    rows_args = slot_ops + (applied[len(applied) // 2][0], ell.diag.shards[1], per)
    out["spectral"] = dict(
        n=MESH_SPECTRAL_N, k=MESH_SPECTRAL_K, iters=MESH_LOBPCG_ITERS,
        dropped_reverse_edges=ell.dropped_reverse_edges, ell_width=int(ell.indices.shape[1]),
        edge_list_bytes=ell.edge_list_bytes, knn_ell_peak_bytes=int(peak),
        eigenvalues=vals.tolist(), residuals=res.tolist(), residual_bound=0.1 * scale,
        spmv_ell_rows_blocks=len(applied), spmv_ell_rows_unequal=rows_unequal[:5])
    del applied
    check(ell.dropped_reverse_edges == 0, "mesh spectral: reverse edges dropped under auto")
    check(float(np.max(res)) < 0.1 * scale and bool(np.all(np.diff(vals) >= -1e-4)),
          f"mesh spectral: residuals {res.tolist()} vs {0.1 * scale}, eigenvalues {vals.tolist()}")
    check(out["spectral"]["spmv_ell_rows_blocks"] == MESH_LOBPCG_ITERS + 1 and not rows_unequal,
          f"mesh spectral: kernel F rows vs plain on slot 1's LOBPCG blocks "
          f"({len(rows_unequal)} unequal of {out['spectral']['spmv_ell_rows_blocks']})")
    check(counts["lobpcg"]["spmv_ell"] == MESH_SLOTS * (MESH_LOBPCG_ITERS + 2),
          f"mesh lobpcg: kernel F launches {counts['lobpcg']}")
    del ss, ell
    torch.cuda.empty_cache()

    # 6. pipeline.build(mesh=...) at phase pipeline's size, cap 3,000, MST
    # k = 32: λ against stage D on one device from the same Laplacian.
    Xp = make_gaussian_hd(N_PIPELINE, 0.3).astype(np.float32)
    cfg = pipeline.PipelineConfig(
        clustering=pipeline.ClusteringConfig(max_clusters=PIPELINE_CAPS[1]),
        mst=pipeline.MSTConfig(k_neighbors=PIPELINE_MST_K))
    pres, secs["pipeline_d4"], counts["pipeline"] = _counted(
        lambda: pipeline.build(Xp, cfg, mesh=meshes[MESH_SLOTS]))
    check(pres.state.means.shape[1] == Xp.shape[1], "mesh pipeline: stage A projected the rows")
    lam_one = spectral.compute_tau_mode(pres.laplacian, Xp, *Xp.shape)
    out["pipeline"] = dict(
        n=N_PIPELINE, cap=PIPELINE_CAPS[1], mst_k=PIPELINE_MST_K,
        lambda_bit_equal=bool(np.array_equal(pres.lambdas, lam_one)),
        lambda_max_rel=float(np.max(np.abs(pres.lambdas - lam_one) / np.maximum(np.abs(lam_one), 1.0))),
        tau=pres.tau, stage_d_seconds=pres.timings["D:spectral"])
    check(out["pipeline"]["lambda_max_rel"] <= TOL_LAMBDA, f"mesh pipeline: {out['pipeline']}")
    del Xp, pres

    # 7. The CLI, each subcommand in its own process: build-distributed on
    # a store of phase 2's first rows, then serve --streaming --mesh 1 on
    # the store it saved; --mesh 4 on one card must fail as the
    # reference's make_mesh does.
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    with tempfile.TemporaryDirectory(prefix="mrs-mesh-cli-") as tmp:
        tmp = Path(tmp)
        shards.write_shards(X[:MESH_CLI_ROWS], tmp / "store", rows_per_shard=65_536)
        qrow = int(batches[1][0]) % MESH_CLI_ROWS
        np.save(tmp / "q.npy", X[qrow])
        cfile = tmp / "bd.counts.json"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", CLI_RUNNER, str(cfile), "build-distributed",
                              str(tmp / "store"), "--n-devices", "1", "--k-clusters", "64",
                              "--cluster-radius", "25", "--save-store", str(tmp / "saved"),
                              "--query", str(tmp / "q.npy")],
                             cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        secs["cli_build_distributed"] = time.perf_counter() - t0
        check(run.returncode == 0, f"mesh cli build-distributed: {run.stderr[-2000:]}")
        built = json.loads(run.stdout.strip().splitlines()[-1])
        counts["cli_build_distributed"] = json.loads(cfile.read_text())
        check(built["n_devices"] == 1 and built["query_top"][0]["index"] == qrow,
              f"mesh cli build-distributed: {built}")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cfile = tmp / "serve.counts.json"
        err_path = tmp / "serve.stderr"
        t0 = time.perf_counter()
        with open(err_path, "w") as err:
            proc = subprocess.Popen([sys.executable, "-c", CLI_RUNNER, str(cfile), "serve",
                                     str(tmp / "saved"), "--streaming", "--mesh", "1", "--port",
                                     str(port)], cwd=repo, env=env, stdout=subprocess.DEVNULL,
                                    stderr=err)
        base_url = f"http://127.0.0.1:{port}"
        try:
            healthy = False
            while not healthy:
                check(proc.poll() is None, f"mesh cli serve exited: {err_path.read_text()[-2000:]}")
                check(time.perf_counter() - t0 < 300, "mesh cli serve: no /health within 300 s")
                try:
                    healthy = http_get(base_url + "/health", timeout=5)[1]["status"] == "ok"
                except OSError:
                    time.sleep(0.2)
            secs["cli_serve_ready"] = time.perf_counter() - t0
            code, body, _ = http_post(base_url + "/search", {"query": X[qrow].tolist(), "k": K})
            check(code == 200 and body["results"][0]["index"] == qrow,
                  f"mesh cli serve: {code} {str(body)[:300]}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        counts["cli_serve"] = json.loads(cfile.read_text())
        # With MESH_SLOTS cards or more the mesh would build and serve()
        # would block: the check runs only where it must fail.
        n_cards = torch.cuda.device_count()
        if n_cards < MESH_SLOTS:
            try:
                cli.main(["serve", str(tmp / "saved"), "--streaming", "--mesh", str(MESH_SLOTS)])
                mesh4 = "no error"
            except ValueError as e:
                mesh4 = str(e)
    check_name = f"serve --streaming --mesh {MESH_SLOTS} on {n_cards} card(s)"
    if n_cards >= MESH_SLOTS:
        print(json.dumps({"phase": "mesh", "check": check_name, "skipped": "enough cards"}),
              flush=True)
    else:
        try:
            make_mesh(MESH_SLOTS)
            out["make_mesh4"] = "no error"
        except ValueError as e:
            out["make_mesh4"] = str(e)
        out["cli_serve_mesh4_on_one_card"] = mesh4
        want = f"requested {MESH_SLOTS} devices, only {n_cards} available"
        print(json.dumps({"phase": "mesh", "check": check_name, "error": mesh4, "expected": want}),
              flush=True)
        check(mesh4 == want and out["make_mesh4"] == want,
              f"mesh: --mesh {MESH_SLOTS} / make_mesh({MESH_SLOTS}) on {n_cards} card(s) gave "
              f"{mesh4!r}, {out['make_mesh4']!r}")
    del sas, sa4
    torch.cuda.empty_cache()
    emit(phase="mesh", step="index", card=card, n=n, f=X.shape[1], slots=MESH_SLOTS, seconds=secs,
         launches={k: {n_: v for n_, v in c.items() if v} for k, c in counts.items()}, **out)
    return counts, rows_args


TIE_N, TIE_F, TIE_B = 1_000_000, 128, 256
TIE_LEVELS = (2, 3, 17)       # coordinates in [−level, level]: f32, bf16 and int8 dots are exact
TIE_N_WIDE = 40_960           # ≥ FUSED_TILEMAX_MIN_N: 20 tiles of the fused producer
TIE_F_WIDE = (128, 256, 512, 1536)
TIE_KS = (10, 40, 100, 200)   # warp lists, the wide design twice, the chain with kernel C
TIE_K_RESCORED = (10, 40)     # k = 100 passes the rescored tiers' 64-slab cap
TIE_TIERS = ("bf16x3_rescored", "int8_rescored", "bf16_rescored")
TIE_INT8_MARGIN = 0.03        # the int8 scan's margin (tests/test_fuzz_invariants.py)
TIE_TOL = 2e-5                # the reference's score tolerance there
TIE_HUB = 16                  # rows at offsets < 16 of every 256-row sub-tile are one row
TIE_HUB_SHARE = 4             # the first quarter of a batch queries that row
TIE_MASK_ALPHA, TIE_MASK_LAMBDA, TIE_PAD = 0.1, 0.125, 3_000
TIE_MESH_N = 262_145          # 4 slots of 65,537 rows: 3 padded rows on the last
SEED_TIES = 50


def tie_corpus(n, f, level, seed, hub=TIE_HUB):
    """An adversarial exact-tie corpus: integer coordinates in [−level,
    level] (every dot exact), a quarter of the rows exact duplicates of
    others scattered over the corpus, λ in quarters; the rows at offsets <
    ``hub`` of every 256-row sub-tile are row 0 with row 0's λ, a tie group
    in every sub-tile. Returns ``(X float32 [n, f], λ float32 [n])``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.integers(-level, level + 1, (n, f), dtype=np.int8)
    X[rng.integers(0, n, n // 4)] = X[rng.integers(0, n, n // 4)]
    lams = (rng.integers(0, 4, n) / 4.0).astype(np.float32)
    hub_rows = np.flatnonzero(np.arange(n) % 256 < hub)
    X[hub_rows] = X[0]
    lams[hub_rows] = lams[0]
    return X.astype(np.float32), lams


def tie_query_rows(n, b, seed):
    """Corpus rows to query: the first quarter the hub row 0, the rest at
    random."""
    import numpy as np

    rows = np.random.default_rng(seed).integers(0, n, b)
    rows[:b // TIE_HUB_SHARE] = 0
    return rows


def tie_faults(sref, ids, top, margin=None, tol=TIE_TOL):
    """The reference's tie contract (``tests/test_fuzz_invariants.py``) for
    ``ids``/``top [B, k]`` against the flat scores ``sref [B, n]`` of the
    real rows: ids in range (no padded row) and distinct, each returned
    score its id's flat score (``tol`` plus 1e-6 relative), each id's flat
    score at least the flat k-th less ``margin`` and ``tol``. With
    ``margin=None`` (an exact scan) the scores are also the flat top-k's
    (within ``tol``) and a row whose k-th score has no near tie returns the
    flat top-k's ids. Returns ``(faults, rows whose k-th and (k+1)-th flat
    scores are equal bit for bit)``."""
    import torch

    b, n = sref.shape
    k = ids.shape[1]
    vals, fidx = torch.topk(sref, min(k + 1, n), dim=1)
    faults = []
    outside = (ids < 0) | (ids >= n)
    if bool(outside.any()):
        faults.append(f"{int(outside.sum())} ids outside the {n} real rows")
    ids_c = ids.clamp(0, n - 1)
    srt = torch.sort(ids_c, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        faults.append("repeated ids")
    carried = torch.gather(sref, 1, ids_c)
    gap = (top - carried).abs()
    if not bool((gap <= tol + 1e-6 * carried.abs()).all()):
        faults.append(f"returned scores off their ids' flat scores by {float(gap.max()):.3g}")
    if not bool((carried >= (vals[:, k - 1] - (margin or 0.0) - tol)[:, None]).all()):
        faults.append("an id below the flat k-th score less the margin")
    tied = int((vals[:, k - 1] == vals[:, k]).sum()) if n > k else 0
    if margin is None:
        ft = vals[:, :k]
        err = float((torch.sort(top, dim=1, descending=True).values - ft).abs().max())
        if err > tol:
            faults.append(f"score multiset off the flat top-k by {err:.3g}")
        near = (ft[:, :-1] - ft[:, 1:] <= 2 * tol).any(dim=1)
        if n > k:
            near |= vals[:, k - 1] - vals[:, k] <= 2 * tol
        if bool((~near).any()) and not torch.equal(torch.sort(ids[~near], dim=1).values,
                                                   torch.sort(fidx[~near, :k], dim=1).values):
            faults.append("ids off the flat top-k's where the k-th score has no near tie")
    return faults, tied


def wide_stage_radix_rows(smain, submax, tail, k, margin, cap, threads):
    """Queries whose wide candidate stage (``subtile_topk_wide_kernel``, 16
    < k ≤ 128) finds more entries at a bar than its list of ``cap`` holds,
    so that its exact radix select chooses: the kernel's two selections
    (``select_best`` in ``csrc/tilemax.cu``, as the numpy model in
    ``tests/test_torch_exact_candidates.py`` states them: the sub-tiles by
    the thread bests' bar, the candidates by the c-th best maximum's score,
    the thread bests' bar where that lists fewer than k or more than
    ``cap``) replayed from the plain producer's scores ``smain [B, n0]``,
    maxima ``submax [B, ns]`` and ``tail``."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops.kernels.search_fused import order_keys

    b, ns = submax.shape
    ts = smain.shape[1] // ns
    c = min(ns, k + margin)
    _, best = so.topk_stable(submax, c)
    hint_v = torch.gather(submax, 1, best[:, -1:]).cpu().numpy()
    sel = torch.sort(best, dim=1).values
    cand = torch.gather(smain.view(b, ns, ts), 1, sel[:, :, None].expand(b, c, ts)).reshape(b, c * ts)
    gid = (sel[:, :, None] * ts + torch.arange(ts, device=sel.device)).reshape(b, c * ts)
    if tail is not None and tail.shape[1]:
        cand = torch.cat([cand, tail], dim=1)
        gid = torch.cat([gid, (ns * ts + torch.arange(tail.shape[1], device=gid.device)).expand(b, -1)], dim=1)

    def radix(keys, kk, hint):
        span = 4 * threads
        padded = np.concatenate([keys, np.zeros((b, (-keys.shape[1]) % span), np.uint64)], axis=1)
        own = np.sort(padded.reshape(b, -1, threads, 4).max(axis=(1, 3)), axis=1)[:, threads - kk]
        m = np.zeros(b, np.int64) if hint is None else (keys >= hint[:, None]).sum(axis=1)
        bar = np.zeros(b, np.uint64) if hint is None else hint
        bar = np.where(((m < kk) | (m > cap)) & ((m < kk) | (own > bar)), own, bar)
        return (keys >= bar[:, None]).sum(axis=1) > cap

    max_keys = order_keys(submax.cpu().numpy(), np.broadcast_to(np.arange(ns, dtype=np.int32), (b, ns)))
    hint = order_keys(hint_v, np.zeros((b, 1), np.int32))[:, 0] & np.uint64(0xFFFFFFFF00000000)
    keys = order_keys(cand.cpu().numpy(), gid.cpu().numpy().astype(np.int32))
    return int((radix(max_keys, c, None) | radix(keys, k, hint)).sum())


QUERY_SHAPES = ((256, 128), (1024, 128), (256, 96), (1024, 96))   # (B, F) of the entry's cells


def query_lambda_rows(dev, cuda_ms, launches, by_path) -> list[dict]:
    """Phase kernels' rows of the query kernel (``mrs_taumode_query``) at
    ``QUERY_SHAPES``, τ = median, on a λ-graph Laplacian of F features:
    ``ms`` its wrapper, ``launch_ms`` its C entry alone on outputs made
    once (both over cold-L2 launches, ``cuda_ms``), ``warm_launch_ms`` the
    mean of 200 launches back to back, ``plain_ms`` the plain chain
    (``taumode_query_lambdas_plain``: ``select_tau``'s sort, the seven
    products, the tail and the fold), ``bound_ms`` 7·B·F² FMAs at the f32
    peak; raw λ within 1e-5·max(|λ|, 1) of the plain version and the fold
    bit for bit torch's on the kernel's raw."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import buildcache
    from matternet_rs_tpu_torch.graph import GraphParams
    from matternet_rs_tpu_torch.ops import laplacian as tlap
    from matternet_rs_tpu_torch.ops import taumode as tmo
    from matternet_rs_tpu_torch.ops.kernels import _cuda
    from matternet_rs_tpu_torch.ops.kernels import taumode as tk

    lib, stream = _cuda.library("taumode"), _cuda.stream_ptr(dev)
    mn, rng = 0.0123456789, 0.876543219
    rows = []
    for b, f in QUERY_SHAPES:
        nodes = np.random.default_rng(f).normal(size=(f, 30)).astype(np.float32)
        L = tlap.build_laplacian_matrix(torch.from_numpy(nodes).to(dev),
                                        GraphParams(eps=0.9, k=5, topk=5, sparsity_check=False))
        L = L.matrix.float().contiguous()
        X = torch.from_numpy(np.random.default_rng(b + f).normal(size=(b, f)).astype(np.float32)).to(dev)
        args = (X, L, tmo.TAU_MEDIAN, 0.0, mn, rng)
        raw, q = tk.taumode_query_lambdas(*args)
        raw_p, _ = tk.taumode_query_lambdas_plain(*args)
        rel = float(((raw - raw_p).abs() / torch.clamp(raw_p.abs(), min=1.0)).max())
        fold = torch.clamp((raw - torch.tensor(mn, device=dev)) / torch.tensor(rng, device=dev), 0.0, 1.0)
        check(rel <= TOL_LAMBDA, f"taumode_query B={b} F={f}: kernel vs plain λ {rel}")
        check(bool(torch.equal(q, fold)), f"taumode_query B={b} F={f}: the fold is not torch's")
        out_raw, out_q = torch.empty_like(raw), torch.empty_like(q)
        k0, k1 = tk.tau_ranks(f, tmo.TAU_MEDIAN)

        def launch():
            rc = lib.mrs_taumode_query(X.data_ptr(), L.data_ptr(), b, f, tmo.TAU_MEDIAN, tk.TAU_FLOOR,
                                       k0, k1, mn, rng, out_raw.data_ptr(), out_q.data_ptr(), stream)
            _cuda.check(lib, rc, "taumode query kernel")

        launch()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(200):
            launch()
        e.record()
        e.synchronize()
        bms, by = bound(4 * (b * f + f * f + 2 * b), 7 * 2 * b * f * f)
        rows.append(dict(
            name=f"taumode_query_b{b}_f{f}", route="cuda", source="matternet_rs_tpu_torch/csrc/taumode.cu",
            replaces="none: the reference's query λ below 32,768 rows is XLA's closed form "
                     "(matternet_rs_tpu/ops/taumode.py taumode_lambdas_auto) and a fold in the search",
            launches=launches, launches_by_path=by_path, max_rel_err=rel,
            ms=cuda_ms(lambda: tk.taumode_query_lambdas(*args), reps=21),
            launch_ms=cuda_ms(launch, reps=21), warm_launch_ms=s.elapsed_time(e) / 200,
            plain_ms=cuda_ms(lambda: tk.taumode_query_lambdas_plain(*args), reps=5),
            bound_ms=bms, bound_by=by, library_ms=None, plan=tk.taumode_query_plan_chosen(b, f),
            ptxas=ptxas_resources(buildcache.BUILD_LOG.get("taumode"),
                                  f"taumode_query_kernelILi{tk.taumode_query_plan_chosen(b, f)['rows']}E"),
            launch_note="ms and launch_ms include writing back the L2 lines the flush left dirty",
            shape=f"B={b} F={f} median τ", arithmetic="f32 FFMA (bound: 7·B·F² FMAs at 67 TFLOP/s)",
        ))
    return rows


def tie_checks(dev, n_main=TIE_N, levels=TIE_LEVELS, n_wide=TIE_N_WIDE, f_wide=TIE_F_WIDE,
               mesh_n=TIE_MESH_N, b=TIE_B, seed=SEED_TIES):
    """Phase ties' checks on ``dev`` (module docstring): ``(records,
    launches)``, a record a check with its ``faults`` (empty when it
    passed), and the launches of all the checks' searches by kernel. On the
    CPU the same entry points run the kernels' plain versions and no launch
    is asked for; ``mesh_n=None`` leaves the mesh out."""
    import numpy as np
    import torch

    from matternet_rs_tpu_torch import ArrowSpace, GraphParams, core
    from matternet_rs_tpu_torch.index import streaming as sti
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import laplacian as lap
    from matternet_rs_tpu_torch.ops import scores as score_ops
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops._mm import mm
    from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.parallel import make_mesh
    from matternet_rs_tpu_torch.parallel.index import ShardedArrowSpace
    from matternet_rs_tpu_torch.utils.parity import same_k_mismatches, topk_mismatches

    cuda = dev.type == "cuda"
    records, totals = [], dict.fromkeys(kernels.LAUNCHES, 0)
    exact_need = {True: ("scores_tilemax", "subtile_topk"), False: ("scores_tilemax", "gather_subtiles")}
    rescored_need = ("tilemax_only", "slab_dots")

    def counted(fn):
        if cuda:
            torch.cuda.synchronize(dev)
        kernels.reset_launches()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        counts = kernels.launch_counts()
        for kn, v in counts.items():
            totals[kn] += v
        return out, counts

    def record(corpus, k, tier, faults, tied, counts, need, **extra):
        launches = {kn: counts[kn] for kn in need}
        if cuda:
            faults = faults + [f"kernel {kn} not launched" for kn, v in launches.items() if v == 0]
        records.append(dict(corpus=corpus, k=k, tier=tier, rows_tied_at_k=tied, launches=launches,
                            ok=not faults, faults=faults[:3], **extra))

    def t(a):
        return torch.from_numpy(a).to(dev)

    def index(X, lams):
        aspace = ArrowSpace.from_items(t(X), device=dev)
        aspace.update_lambdas(t(lams))
        gl = lap.build_laplacian_from_k_cluster(
            aspace.data[TIE_HUB:TIE_HUB + 64], GraphParams(eps=1.0, k=6, topk=6, sparsity_check=False),
            n_items=X.shape[0])
        return aspace, gl

    def scan_of(aspace, tier):
        if tier == "int8_rescored":
            return aspace._ensure_int8()
        return (aspace.data if tier == "bf16x3_rescored" else aspace._scan_corpus(True)), None

    def slabs_agree(Xscan, rn, norms, lams, Q, ql, a, c, mask_from=None):
        """Rows whose kernel D selects the plain version's c slabs, and rows
        that select others without a near tie at the c-th maximum."""
        kw = dict(subs=so.RESCORE_SUBS, rn=rn, mask_from=mask_from)
        mk = rsk.tilemax_only(Xscan, norms, lams, Q, ql, a, **kw)
        mp = rsk.tilemax_only_plain(Xscan, norms, lams, Q, ql, a, **kw)
        sel_k = torch.sort(so.topk_stable(mk, c)[1], dim=1).values
        top_m, sel_p = so.topk_stable(mp, c + 1)
        same = torch.all(sel_k == torch.sort(sel_p[:, :c], dim=1).values, dim=1)
        unexplained = ~same & ((top_m[:, c - 1] - top_m[:, c]).abs() > TOL_SCORE)
        return same.cpu().numpy(), int(unexplained.sum())

    def searched(aspace, gl, Q, k, tier):
        (idx, sc, raw), counts = counted(lambda: aspace.search_batch(
            Q, gl, k=k, alpha=ALPHA, quantized=tier, return_raw=True, allow_low_recall=True))
        mn = torch.tensor(aspace.min_lambdas, dtype=torch.float32, device=dev)
        rng = torch.tensor(aspace.range_lambdas, dtype=torch.float32, device=dev)
        return idx, sc, torch.clamp((t(raw) - mn) / rng, 0.0, 1.0), counts

    def exact_check(name, aspace, gl, Qn, k, radix=False):
        X, norms, lams = aspace.data, aspace.norms, aspace.lambdas
        idx, sc, ql, counts = searched(aspace, gl, Qn, k, False)
        Q = t(Qn)
        a = torch.full((Q.shape[0],), ALPHA, dtype=torch.float32, device=dev)
        faults, tied = tie_faults(so._batched_scores(X, norms, lams, Q, ql, a), t(idx), t(sc))
        top_p, idx_p = so.fused_tilemax(X, norms, lams, Q, ql, k + 1, a, so.DEFAULT_TILE,
                                        producer=tmk.scores_and_tilemax_plain,
                                        gather=tmk.gather_subtiles_plain, select=tmk.select_topk_plain)
        top_p, idx_p = top_p.cpu().numpy(), idx_p.cpu().numpy()
        faults += topk_mismatches(idx_p, top_p, idx, sc, TOL_SCORE)[:2]
        extra = dict(bit_equal_plain=bool(np.array_equal(idx, idx_p[:, :k])
                                          and np.array_equal(sc.view(np.int32), top_p[:, :k].view(np.int32))))
        if radix:
            n0 = (X.shape[0] // so.DEFAULT_TILE) * so.DEFAULT_TILE
            smain, submax = tmk.scores_and_tilemax_plain(X, norms, lams, Q, ql, a)
            tail = so._batched_scores(X[n0:], norms[n0:], lams[n0:], Q, ql, a)
            extra["radix_rows"] = wide_stage_radix_rows(smain, submax, tail, k, so.SELECT_MARGIN,
                                                        tmk.WIDE_CAP, tmk.WIDE_THREADS)
        record(name, k, "exact", faults, tied, counts, exact_need[k <= tmk.TOPK_MAX_K_WIDE], **extra)

    def rescored_check(name, aspace, gl, Qn, k, tier):
        X, norms, lams = aspace.data, aspace.norms, aspace.lambdas
        idx, sc, ql, counts = searched(aspace, gl, Qn, k, tier)
        Q = t(Qn)
        a = torch.full((Q.shape[0],), ALPHA, dtype=torch.float32, device=dev)
        margin = TIE_INT8_MARGIN if tier == "int8_rescored" else None
        faults, tied = tie_faults(so._batched_scores(X, norms, lams, Q, ql, a), t(idx), t(sc), margin)
        Xscan, rn = scan_of(aspace, tier)
        cand = aspace._int8_cand(k, None)
        pidx, ptop = so.fused_scan_rescored(Xscan, X, norms, lams, Q, ql, k, cand, a, scan_rn=rn,
                                            producer=rsk.tilemax_only_plain,
                                            slab_reader=rsk.slab_dots_plain)
        c = max(k + so.SELECT_MARGIN, -(-cand // (so.DEFAULT_TILE // so.RESCORE_SUBS)))
        same, unexplained = slabs_agree(Xscan, rn, norms, lams, Q, ql, a, c)
        faults += same_k_mismatches(pidx.cpu().numpy()[same], ptop.cpu().numpy()[same],
                                    idx[same], sc[same], TOL_SCORE)[:2]
        if unexplained:
            faults.append(f"{unexplained} rows select other slabs without a near tie")
        record(name, k, tier, faults, tied, counts, rescored_need,
               slab_selection_differs_rows=int((~same).sum()))

    def mask_checks(name, aspace, Qn):
        """``mask_from`` on one device: 3,000 zero rows after the corpus,
        their λ every query's (λ = 0.125, α = 0.1), so that unmasked each
        scores 0.9, above every real row (at most 0.1 + 0.9·0.875); through
        the routes a mesh slot runs (``core._routed_batched_search`` and
        ``core._rescored_tier`` with ``mask_from``) and the sketch's
        maxima-first scan (kernel E on int8 rows) with its last 3,000 rows
        past ``n_items``."""
        X, norms, lams = aspace.data, aspace.norms, aspace.lambdas
        n, f = X.shape
        Q = t(Qn)
        ql = torch.full((Q.shape[0],), TIE_MASK_LAMBDA, dtype=torch.float32, device=dev)
        a = torch.full_like(ql, TIE_MASK_ALPHA)
        zeros = torch.zeros(TIE_PAD, dtype=torch.float32, device=dev)
        Xp = torch.cat([X, zeros[:, None].expand(TIE_PAD, f)])
        normsp = torch.cat([norms, zeros])
        lamsp = torch.cat([lams, zeros + TIE_MASK_LAMBDA])
        sref = so._batched_scores(X, norms, lams, Q, ql, a)
        won = int((torch.topk(so._batched_scores(Xp, normsp, lamsp, Q, ql, a), 10, dim=1).indices
                   >= n).any(dim=1).sum())
        k = 10
        cand = aspace._int8_cand(k, None)
        c = max(k + so.SELECT_MARGIN, -(-cand // (so.DEFAULT_TILE // so.RESCORE_SUBS)))
        for tier in (False,) + TIE_TIERS:
            if tier is False:
                (idx, top), counts = counted(lambda: core._routed_batched_search(
                    Xp, normsp, lamsp, Q, ql, k, a, mask_from=n))
                faults, tied = tie_faults(sref, idx, top)
                top_p, idx_p = so.fused_tilemax(Xp, normsp, lamsp, Q, ql, k + 1, a, so.DEFAULT_TILE,
                                                mask_from=n, producer=tmk.scores_and_tilemax_plain,
                                                gather=tmk.gather_subtiles_plain,
                                                select=tmk.select_topk_plain)
                faults += topk_mismatches(idx_p.cpu().numpy(), top_p.cpu().numpy(), idx.cpu().numpy(),
                                          top.cpu().numpy(), TOL_SCORE)[:2]
                need, differs = exact_need[True], 0
            else:
                Xs, rn = {"int8_rescored": lambda: core.quantize_rows(Xp),
                          "bf16x3_rescored": lambda: (Xp, None),
                          "bf16_rescored": lambda: (Xp.to(torch.bfloat16), None)}[tier]()
                (idx, top), counts = counted(lambda: core._rescored_tier(
                    Xs, Xp, normsp, lamsp, Q, ql, k, cand, a, scan_rn=rn, mask_from=n))
                faults, tied = tie_faults(sref, idx, top,
                                          TIE_INT8_MARGIN if tier == "int8_rescored" else None)
                pidx, ptop = so.fused_scan_rescored(Xs, Xp, normsp, lamsp, Q, ql, k, cand, a,
                                                    scan_rn=rn, mask_from=n,
                                                    producer=rsk.tilemax_only_plain,
                                                    slab_reader=rsk.slab_dots_plain)
                same, unexplained = slabs_agree(Xs, rn, normsp, lamsp, Q, ql, a, c, mask_from=n)
                faults += same_k_mismatches(pidx.cpu().numpy()[same], ptop.cpu().numpy()[same],
                                            idx.cpu().numpy()[same], top.cpu().numpy()[same],
                                            TOL_SCORE)[:2]
                if unexplained:
                    faults.append(f"{unexplained} rows select other slabs without a near tie")
                need, differs = rescored_need, int((~same).sum())
            if not won:
                faults.append("no padded row would win unmasked")
            record(f"{name}, {TIE_PAD} padded rows", k, "exact" if tier is False else tier, faults,
                   tied, counts, need, pad_rows_win_unmasked=won, slab_selection_differs_rows=differs)

        # The sketch's maxima-first scan: its flat rows end at a tile.
        n_flat = (n // so.DEFAULT_TILE) * so.DEFAULT_TILE
        n_items = n_flat - TIE_PAD
        X8, mult = aspace._ensure_int8()
        X8f, mult_f, lam_f = X8[:n_flat].clone(), mult[:n_flat].clone(), lams[:n_flat].clone()
        X8f[n_items:], mult_f[n_items:], lam_f[n_items:] = 0, 0.0, TIE_MASK_LAMBDA
        rows_out = 4 * k
        qn = torch.clamp(torch.sqrt(torch.sum(Q * Q, dim=-1)), min=1e-12)

        def sketch_scores(rows):
            cos = torch.clamp(mm(Q, X8f[:rows].to(torch.float32).T) * mult_f[:rows] / qn[:, None],
                              -1.0, 1.0)
            return score_ops.blend(cos, lam_f[None, :rows], ql[:, None], a[:, None])

        def sketch():
            return sti._sketch_maxfirst_topk(X8f, mult_f, lam_f, Q, ql, a, rows_out=rows_out,
                                             kfinal=k, n_items=n_items)

        (top, ids), counts = counted(sketch)
        won = int((torch.topk(sketch_scores(n_flat), k, dim=1).indices >= n_items).any(dim=1).sum())
        faults, tied = tie_faults(sketch_scores(n_items), ids[:, :k], top[:, :k])
        saved = rsk.tilemax_only, so._slab_dots_checked
        rsk.tilemax_only = rsk.tilemax_only_plain
        so._slab_dots_checked = lambda X_, Q_, sel, ts: rsk.slab_dots_plain(X_, Q_, sel, ts)
        try:
            ptop, pids = sketch()
        finally:
            rsk.tilemax_only, so._slab_dots_checked = saved
        c_s = min((n_flat // so.DEFAULT_TILE) * so.RESCORE_SUBS,
                  max(k + so.SELECT_MARGIN, -(-rows_out // (so.DEFAULT_TILE // so.RESCORE_SUBS))))
        same, unexplained = slabs_agree(X8f, mult_f, mult_f, lam_f, Q, ql, a, c_s, mask_from=n_items)
        faults += same_k_mismatches(pids[:, :k].cpu().numpy()[same], ptop[:, :k].cpu().numpy()[same],
                                    ids[:, :k].cpu().numpy()[same], top[:, :k].cpu().numpy()[same],
                                    TOL_SCORE)[:2]
        if unexplained:
            faults.append(f"{unexplained} rows select other slabs without a near tie")
        if not won:
            faults.append("no padded row would win unmasked")
        record(f"{name} sketch, {TIE_PAD} rows past n_items", k, "sketch_int8", faults, tied, counts,
               rescored_need, pad_rows_win_unmasked=won, slab_selection_differs_rows=int((~same).sum()))

    def streamed_check(name, aspace, gl, Qn):
        """Kernel G (``search_fused``, its own entry point) on the
        row-normalised corpus: identical rows stay identical, so the hub
        row's ties survive the normalisation."""
        from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk

        k = 10
        X, lams = aspace.data, aspace.lambdas
        Xn = X / torch.linalg.norm(X, dim=1, keepdim=True)
        Q = t(Qn)
        Qn_ = Q / torch.linalg.norm(Q, dim=1, keepdim=True)
        _, _, ql, _ = searched(aspace, gl, Qn, k, False)
        (ids, top), counts = counted(lambda: sfk.search_fused(Xn, lams, Qn_, ql, k, ALPHA))
        a = torch.full((Q.shape[0],), ALPHA, dtype=torch.float32, device=dev)
        ones = torch.ones(X.shape[0], dtype=torch.float32, device=dev)
        faults, tied = tie_faults(so._batched_scores(Xn, ones, lams, Qn_, ql, a), ids.long(), top)
        pidx, ptop = sfk.search_fused_plain(Xn, lams, Qn_, ql, k + 1, ALPHA)
        faults += topk_mismatches(pidx.cpu().numpy(), ptop.cpu().numpy(), ids.cpu().numpy(),
                                  top.cpu().numpy(), TOL_SCORE)[:2]
        record(f"{name} row-normalised", k, "search_fused", faults, tied, counts,
               ("search_fused", "search_fused_merge"))

    def mesh_checks(level):
        """The 4-slot mesh on one device: the last slot's 3 padded rows get
        the hub queries' λ and α = 0.1, so that each scores 0.9 against at
        most 0.1 + 0.9·0.75 for a real row, whose λ is a quarter or more
        from the query's."""
        X, lams = tie_corpus(mesh_n, TIE_F, level, seed + 300)
        aspace, gl = index(X, lams)
        sa = ShardedArrowSpace.from_arrowspace(aspace, gl, mesh=make_mesh(4, devices=[dev] * 4))
        Qn = X[tie_query_rows(mesh_n, b, seed + 301)]
        Q = t(Qn)
        ql = sa.prepare_query_lambdas_batch(Q)
        n_pad = sa.lambdas.shape[0]
        lam_all = torch.remainder(ql[0] + 0.25 * (1 + torch.arange(n_pad, device=dev) % 3), 1.0)
        lam_all[mesh_n:] = ql[0]
        per = sa.lambdas.per
        for i, shard in sa.lambdas.local():
            shard.copy_(lam_all[i * per:(i + 1) * per])
        a = torch.full((Q.shape[0],), TIE_MASK_ALPHA, dtype=torch.float32, device=dev)
        sref = so._batched_scores(aspace.data, aspace.norms, lam_all[:mesh_n], Q, ql, a)
        pads = torch.zeros(n_pad - mesh_n, dtype=torch.float32, device=dev)
        Xpad = torch.cat([aspace.data, pads[:, None].expand(-1, TIE_F)])
        won = int((torch.topk(so._batched_scores(Xpad, torch.cat([aspace.norms, pads]), lam_all, Q, ql, a),
                              10, dim=1).indices >= mesh_n).any(dim=1).sum())
        for tier in (False, "bf16x3_rescored", "int8_rescored"):
            (idx, sc), counts = counted(lambda: sa.search_batch(Qn, 10, alpha=TIE_MASK_ALPHA,
                                                                quantized=tier))
            faults, tied = tie_faults(sref, t(idx), t(sc),
                                      TIE_INT8_MARGIN if tier == "int8_rescored" else None)
            if not won:
                faults.append("no padded row would win unmasked")
            record(f"{mesh_n}x{TIE_F} level {level}, 4 slots, {n_pad - mesh_n} padded rows", 10,
                   "exact" if tier is False else tier, faults, tied, counts,
                   exact_need[True] if tier is False else rescored_need, pad_rows_win_unmasked=won)

    # -- the main path's size: one integer index a level ------------------
    for level in levels:
        X, lams = tie_corpus(n_main, TIE_F, level, seed + level)
        aspace, gl = index(X, lams)
        Qn = X[tie_query_rows(n_main, b, seed + 100 + level)]
        name = f"{n_main}x{TIE_F} level {level}"
        for k in TIE_KS:
            exact_check(name, aspace, gl, Qn, k, radix=tmk.TOPK_MAX_K < k <= tmk.TOPK_MAX_K_WIDE)
        for tier in TIE_TIERS:
            for k in TIE_K_RESCORED:
                rescored_check(name, aspace, gl, Qn, k, tier)
        if level == levels[0]:
            mask_checks(name, aspace, Qn)
            streamed_check(name, aspace, gl, Qn)
        del aspace, gl, X
    # -- the fused producer's wide-F envelope -----------------------------
    for f in f_wide:
        X, lams = tie_corpus(n_wide, f, 3, seed + f)
        aspace, gl = index(X, lams)
        Qn = X[tie_query_rows(n_wide, b, seed + 200 + f)]
        name = f"{n_wide}x{f} level 3"
        exact_check(name, aspace, gl, Qn, 10)
        for tier in TIE_TIERS:
            rescored_check(name, aspace, gl, Qn, 10, tier)
        del aspace, gl, X
    if mesh_n:
        mesh_checks(TIE_LEVELS[1])
    return records, totals


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
    from matternet_rs_tpu_torch.ops.kernels import energy_scan as esk
    from matternet_rs_tpu_torch.ops.kernels import rescored as rsk
    from matternet_rs_tpu_torch.ops.kernels import search_fused as sfk
    from matternet_rs_tpu_torch.ops.kernels import spmv_ell as fk
    from matternet_rs_tpu_torch.ops.kernels import taumode as tk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
    from matternet_rs_tpu_torch.utils.parity import ENERGY_TIE_TOL, same_k_mismatches, topk_mismatches

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
    check(main_counts["taumode_query"] == len(batches),
          f"the query λ must be one launch of the query kernel a batch: {main_counts}")

    def traced(search, items=None):
        """:func:`profiled` over the timed batches, or ``items``."""
        return profiled(search, batches[1:] if items is None else items)

    # The exact tier's candidate stage against the selection chain it
    # replaced (kernel C's gather, the stable sorts), the same timed batches
    # in turns: stage, chain, chain, stage; then a profiled pass of each.
    def exact_search(route, k=K):
        def search(r):
            return aspace.search_batch(X[r], gl, k=k, alpha=ALPHA)
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

    def stage_vs_chain_at(k):
        """Whole searches at k through the stage and through the chain, in
        turns (chain first), then a profiled pass of each route."""
        turns = {"chain": [], "stage": []}
        for route in ("chain", "stage", "stage", "chain"):
            search = exact_search(route, k)
            for r in batches[1:]:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                search(r)
                torch.cuda.synchronize()
                turns[route].append((time.perf_counter() - t1) * 1e3)
        out = {route: dict(search_ms_per_batch_median=statistics.median(ms), search_ms_per_batch=ms,
                           profile=traced(exact_search(route, k)))
               for route, ms in turns.items()}
        for route in out.values():
            route["profile"].pop("top_kernels")
        return out

    stage_vs_chain = {f"k{k}": stage_vs_chain_at(k) for k in (K, K_WIDE[1])}

    # The wide stage's path (16 < k ≤ 128): one launch, kernel C never; at
    # k = 100 the same ids and score bits as the chain's; kernel C's path
    # beyond 128.
    k_counts, k_res = {}, {}
    for kw in (*K_WIDE, K_CHAIN):
        kernels.reset_launches()
        k_res[kw] = aspace.search_batch(X[batches[1]], gl, k=kw, alpha=ALPHA)
        k_counts[kw] = kernels.launch_counts()
        check(k_res[kw][0].shape == (BATCH, kw) and np.array_equal(k_res[kw][0][:, :K], results[1][1]),
              f"k={kw}: the first {K} ids differ from the k={K} search's")
        stage, chain = (1, 0) if kw <= tmk.TOPK_MAX_K_WIDE else (0, 1)
        check(k_counts[kw]["subtile_topk"] == stage and k_counts[kw]["gather_subtiles"] == chain,
              f"k={kw}: the candidate stage must launch {stage} and kernel C {chain} times: {k_counts[kw]}")
    k100_chain = exact_search("chain", K_WIDE[1])(batches[1])
    k100_equal = bool(np.array_equal(k100_chain[0], k_res[K_WIDE[1]][0])
                      and np.array_equal(k100_chain[1].view(np.int32), k_res[K_WIDE[1]][1].view(np.int32)))
    check(k100_equal, f"k={K_WIDE[1]}: the stage's ids or score bits differ from the chain's")
    emit(phase="main", n=N_MAIN, f=F_MAIN, batch=BATCH, k=K, card=card,
         build_seconds=build_s, stage_seconds=builder.last_stage_timings,
         n_clusters=aspace.n_clusters, warmup_ms=batch_ms[0],
         search_ms_per_batch_median=statistics.median(batch_ms[1:]),
         search_ms_per_batch=batch_ms[1:], launches=main_counts,
         self_query_failures=self_fail[:10], plain_route_mismatches=plain_mismatch[:10],
         candidate_stage_vs_chain=stage_vs_chain, launches_at_k=k_counts,
         k100_bit_equal_to_chain=k100_equal)

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
        # Phase mesh's store build, on this store before it goes.
        mesh_store_counts = mesh_store_step(dev, card, tmp, Xj, jbatches[1])
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
        # Phase 16's streaming step on this index, before its store goes.
        del X8s, mults_s, lams_s, valids_s, X8f, mult_f, lam_f
        serve_stream_counts = serve_streaming_step(dev, card, sidx, shards.read_rows(sdir, srows[1]))
        # Phase mesh's sharded sketch, on this index before its store goes.
        mesh_sketch_counts = mesh_sketch_step(dev, card, sidx, Qs)
        for row, kname in zip(sketch_rows, ("tilemax_only", "slab_dots")):
            by_path = {"streaming": row["launches"],
                       "serve": sum(c[kname] for c in serve_stream_counts.values()),
                       "mesh": sum(c[kname] for c in mesh_sketch_counts.values())}
            row.update(launches=sum(by_path.values()), launches_by_path=by_path)
        del sidx, Qs, blk0
        torch.cuda.empty_cache()

    # -- 12. energy: the energy pipeline at the reference benchmark's size --
    energy_counts, serve_energy_counts, energy_scan_inputs = energy_phase(dev, card)
    path_counts["energy"] = {k: sum(c[k] for c in energy_counts.values()) for k in kernels.LAUNCHES}

    # -- 13–15. items, lambda_search, pipeline ---------------------------
    items_counts = items_phase(dev, card, aspace, gl, X, batches[1])
    path_counts["items"] = {k: sum(c[k] for c in items_counts.values()) for k in kernels.LAUNCHES}
    exact_ids = [res[1] for res in results]
    path_counts["lambda_search"] = lambda_search_phase(dev, card, aspace, gl, X, batches, exact_ids)
    pipeline_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 16–18. serve, cli, models -----------------------------------------
    serve_counts = serve_phase(dev, card, aspace, gl, X)
    cli_counts = cli_phase(dev, card, X)
    models_counts = models_phase(dev, card, X)

    def summed(*groups):
        return {k: sum(c[k] for g in groups for c in g.values()) for k in kernels.LAUNCHES}

    path_counts["serve"] = summed(serve_counts, serve_energy_counts, serve_stream_counts)
    path_counts["cli"] = summed(cli_counts)
    path_counts["models"] = summed(models_counts)
    # -- mesh: the device-mesh layer (its store and sketch steps ran inside
    # phases shards and streaming) ----------------------------------------
    mesh_counts, mesh_rows_args = mesh_phase(dev, card, aspace, gl, X, batches, results)
    # Kernel A's launches of the store build are F = 768's (the wide row);
    # the sketch's D and E launches are the sketch rows'.
    path_counts["mesh"] = summed(mesh_counts, mesh_store_counts)
    path_counts["mesh"]["taumode"] -= summed(mesh_store_counts)["taumode"]
    torch.cuda.empty_cache()

    # -- 20. ties: adversarial exact-tie corpora through the kernels --------
    t0 = time.perf_counter()
    tie_records, path_counts["ties"] = tie_checks(dev)
    for rec in tie_records:
        emit(phase="ties", **rec)
    tie_failed = [r for r in tie_records if not r["ok"]]
    radix_rows = sum(r.get("radix_rows", 0) for r in tie_records)
    emit(phase="ties", step="summary", card=card, checks=len(tie_records), failed=len(tie_failed),
         radix_rows=radix_rows, bit_equal_plain=sum(r.get("bit_equal_plain", False) for r in tie_records),
         seconds=time.perf_counter() - t0, launches=path_counts["ties"])
    check(not tie_failed, f"ties: {[(r['corpus'], r['k'], r['tier'], r['faults']) for r in tie_failed[:3]]}")
    check(radix_rows > 0, "ties: no query reached the wide candidate stage's radix select")
    torch.cuda.empty_cache()

    # -- 21. kernels against their plain versions -----------------------
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
    wide_by_path = {"wide": wide_counts["taumode"],
                    "mesh": summed(mesh_store_counts)["taumode"]}
    lam_row("taumode_lambda_wide_f", "matternet_rs_tpu/ops/pallas/taumode_fused.py:231",
            waspace.data, wgl.matrix.contiguous(), sum(wide_by_path.values()))
    rows_out[-1]["launches_by_path"] = wide_by_path
    rows_out += query_lambda_rows(dev, cuda_ms,
                                  *launches_by_path("taumode_query", main_counts["taumode_query"]))

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
    c_chain = min(ns, K_CHAIN + so.SELECT_MARGIN)           # kernel C's live shape: k = 200
    ts = tile // tmk.SUBS
    s3 = s_k.view(BATCH, ns, ts)
    for c_g in (c, c_chain):
        sel = torch.sort(so.topk_stable(m_k, c_g)[1], dim=1).values
        g_k = tmk.gather_subtiles(s_k, sel, ts)
        g_p = tmk.gather_subtiles_plain(s_k, sel, ts)
        check(bool(torch.equal(g_k, g_p)), f"gather_subtiles c={c_g}: kernel vs plain")
    err_c = float((g_k - g_p).abs().max())
    gidx = sel[:, :, None].expand(BATCH, c_chain, ts)
    c_launches, c_by_path = launches_by_path("gather_subtiles", k_counts[K_CHAIN]["gather_subtiles"])
    bms, by = bound(2 * 4 * BATCH * c_chain * ts + 8 * BATCH * c_chain, 0)
    rows_out.append(dict(
        name="gather_subtiles", route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
        replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:622",
        launches=c_launches, launches_by_path=c_by_path, max_abs_err=err_c,
        ms=cuda_ms(lambda: tmk.gather_subtiles(s_k, sel, ts), reps=20),
        plain_ms=cuda_ms(lambda: tmk.gather_subtiles_plain(s_k, sel, ts), reps=20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.gather(s3, 1, gidx), reps=20),
        shape=f"B={BATCH} c={c_chain} ts={ts} (k = {K_CHAIN}, its only route)",
    ))

    # The candidate stage on the same batch: kernel B's scores and maxima,
    # the ragged tail as fused_tilemax scores it; at k = 10 (warp lists)
    # and at k = 40 and 100 (the wide design). The chain with kernel C (the
    # route each k took before the stage) is timed first.
    tail = so._batched_scores(Xt[n0:], norms[n0:], lams[n0:], Q, ql, alphas)
    nr = tail.shape[1]
    full = torch.cat([s_k, tail], dim=1)
    floor_ms = cuda_ms(lambda: sfk.empty_launch(dev), reps=20)
    log = buildcache.BUILD_LOG.get("tilemax")

    def stage_row(kk, name, launches, by_path):
        c_s = min(ns, kk + so.SELECT_MARGIN)
        stage_args = (s3, m_k, tail, N_MAIN, kk, so.SELECT_MARGIN)

        def chain(gather):
            return tmk.select_topk_plain(*stage_args, gather=lambda sel: gather(s_k, sel, ts))

        chain_ms = cuda_ms(lambda: chain(tmk.gather_subtiles), reps=20)
        top_k, idx_k = tmk.select_topk(*stage_args)
        top_p, idx_p = chain(tmk.gather_subtiles_plain)
        check(bool(torch.equal(idx_k, idx_p)) and bit_equal(top_k, top_p), f"{name}: kernel vs plain")
        ops = tmk._subtile_topk_operands(*stage_args)      # the wrapper's checks and outputs, made once
        bms, by = bound(4 * BATCH * (ns + c_s * ts + nr) + 12 * BATCH * kk, 0)
        rows_out.append(dict(
            name=name, route="cuda", source="matternet_rs_tpu_torch/csrc/tilemax.cu",
            replaces="matternet_rs_tpu/ops/pallas/tilemax_fused.py:622",
            launches=launches, launches_by_path=by_path,
            max_abs_err=float((top_k - top_p).abs().max()),
            ms=cuda_ms(lambda: tmk.select_topk(*stage_args), reps=20),
            launch_ms=cuda_ms(lambda: tmk._subtile_topk_launch(*ops), reps=20),
            launch_floor_ms=floor_ms,
            plain_ms=cuda_ms(lambda: chain(tmk.gather_subtiles_plain), reps=20),
            chain_ms=chain_ms,
            bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(lambda: torch.topk(full, kk, dim=1), reps=20),
            shape=f"B={BATCH} ns={ns} c={c_s} ts={ts} tail={nr} k={kk}",
            design="warp lists in registers" if kk <= tmk.TOPK_MAX_K else "shared-memory lists, radix fallback",
            replaces_also="matternet_rs_tpu/ops/search.py:290 (_tilemax_select, the XLA selection around the gather)",
            chain="the selection chain with kernel C as its gather",
            library="torch.topk over the full [B, n] score plane (no id tie-break)",
            launch_floor="an empty kernel, timed the same way",
        ))
        entry = "subtile_topk_kernel" if kk <= tmk.TOPK_MAX_K else "subtile_topk_wide_kernel"
        resources[name] = dict(ptxas=ptxas_resources(log, entry))
        if kk > tmk.TOPK_MAX_K:
            record_resources(name, "tilemax", entry, tmk.subtile_topk_wide_plan(),
                             tmk.subtile_topk_wide_plan_chosen())
        check(log is None or resources[name]["ptxas"] is not None, f"{name}: no ptxas report in the build log")

    # One counter for both designs: serving and the mesh launch the stage
    # at k = 10 and at k = 40, counted in this row.
    stage_row(K, "subtile_topk", *launches_by_path("subtile_topk", main_counts["subtile_topk"]))
    for kk in K_WIDE:
        by_path = {f"main_k{kk}": k_counts[kk]["subtile_topk"]}
        if kk == K_WIDE[0]:
            by_path["mesh_k40"] = mesh_counts["exact_k40"]["subtile_topk"]
        stage_row(kk, f"subtile_topk_wide_k{kk}", sum(by_path.values()), by_path)
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
                     "items": items_counts.get(tier, {}).get("tilemax_only", 0),
                     "serve": sum(serve_counts[s]["tilemax_only"] for s in SERVE_D_STEPS[tier]),
                     "models": sum(models_counts[s]["tilemax_only"] for s in MODELS_D_STEPS[tier]),
                     "mesh": sum(c["tilemax_only"] for step, c in mesh_counts.items()
                                 if step.startswith(f"{tier}_d")),
                     "ties": sum(r["launches"].get("tilemax_only", 0) for r in tie_records
                                 if r["tier"] == tier or (tier, r["tier"]) == ("int8_rescored", "sketch_int8"))}
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
                 "items": path_counts["items"]["slab_dots"],
                 "serve": sum(c["slab_dots"] for c in serve_counts.values()),
                 "models": path_counts["models"]["slab_dots"],
                 "mesh": path_counts["mesh"]["slab_dots"],
                 "ties": path_counts["ties"]["slab_dots"]}
    e_launches = sum(e_by_path.values())
    tie_int8_rows = sum(r["launches"].get("slab_dots", 0) for r in tie_records if r["tier"] == "sketch_int8")
    qnorm = torch.linalg.norm(Q, dim=1)
    floor_ms = cuda_ms(lambda: sfk.empty_launch(dev), reps=20)
    for label, Xr, sel_e, peak, mode_launches, entry in (
        ("slab_dots_f32", Xt, sels["bf16x3_rescored"], PEAK_F32_FLOP_S, e_launches, "slab_dots_kernelILb0E"),
        ("slab_dots_int8", X8, sels["int8_rescored"], PEAK_BF16_FLOP_S,
         path_counts["streaming"]["slab_dots"] + tie_int8_rows, "slab_dots_ring_kernel"),
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

    # Kernel F's rows form on one mesh slot's rows of phase mesh's
    # 100,000-row graph and one block its LOBPCG applied to them (the solve
    # applies the form once a slot per product).
    idx_r, w_r, V_r, d_r, row0_r = mesh_rows_args
    got, ref = fk.spmv_ell(*mesh_rows_args, checked=True), fk.spmv_ell_plain(*mesh_rows_args)
    live_r = int((w_r != 0).sum())
    n_r, k_r = idx_r.shape
    m_r = V_r.shape[1]
    bms, by = bound(n_r * k_r * 8 + n_r * 4 + 2 * n_r * m_r * 4, 2 * live_r * m_r + 2 * n_r * m_r)
    out_r = torch.empty((n_r, m_r), device=dev)
    rows_out.append(dict(
        name="spmv_ell (rows)", route="cuda", source="matternet_rs_tpu_torch/csrc/spmv_ell.cu",
        replaces="matternet_rs_tpu/ops/pallas/spmv_ell.py:76", launches=path_counts["mesh"]["spmv_ell"],
        launches_by_path={"mesh": path_counts["mesh"]["spmv_ell"]},
        max_abs_err=float((got - ref).abs().max()),
        ms=cuda_ms(lambda: fk.spmv_ell(*mesh_rows_args, checked=True), reps=20),
        launch_ms=cuda_ms(lambda: fk._spmv_ell_launch(idx_r, w_r, V_r, d_r, out_r, row0_r), reps=20),
        plain_ms=cuda_ms(lambda: fk.spmv_ell_plain(*mesh_rows_args), reps=5),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=f"rows={n_r} of {V_r.shape[0]} k={k_r} m={m_r} row0={row0_r} live_slots={live_r}",
        library="none: torch.sparse.mm needs the slot's rows as a CSR matrix over all columns",
    ))
    check(bit_equal(got, ref), "spmv_ell (rows): kernel vs plain not bit for bit")
    del mesh_rows_args, got, ref, V_r

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
        launches=st_counts["search_fused"] + path_counts["ties"]["search_fused"],
        launches_by_path={"streamed": st_counts["search_fused"], "ties": path_counts["ties"]["search_fused"]},
        max_abs_err=err_g,
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
    # The merge also follows each energy scan (energy, serve and cli paths).
    merge_by_path = {"streamed": st_counts["search_fused_merge"],
                     **{p: c["search_fused_merge"] for p, c in path_counts.items()
                        if c["search_fused_merge"]}}
    flat_v = pv.view(BATCH, -1)
    bms, by = bound(8 * pv.numel() + 8 * BATCH * K, 0)
    rows_out.append(dict(
        name="search_fused_merge", route="cuda", source="matternet_rs_tpu_torch/csrc/search_fused.cu",
        replaces="matternet_rs_tpu/ops/pallas/search_fused.py:108",
        launches=sum(merge_by_path.values()), launches_by_path=merge_by_path,
        max_abs_err=float((mv - mv_p).abs().max()),
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
    # The energy scan (kernel G's scan with the energy epilogue) on phase
    # energy's index and one of its batches, against the path it replaced:
    # the [B, N] scores and a stable sort.
    eX, en, el, eQ, eql, es_lam, es_idx = energy_scan_inputs
    e_splits = sfk.default_splits(eX.shape[0], BATCH, dev)
    record_resources("energy_scan", "search_fused", "energy_scan_kernel",
                     sfk.scan_plan(eX, eQ, e_splits), sfk.scan_plan_chosen(eX, eQ, K, e_splits))
    ei, ed = esk.energy_topk(eX, en, el, eQ, eql, K)
    pi_e, pd_e = esk.energy_topk_plain(eX, en, el, eQ, eql, K)
    e_bad = same_k_mismatches(pi_e.cpu().numpy(), pd_e.cpu().numpy(), ei.cpu().numpy(),
                              ed.cpu().numpy(), ENERGY_TIE_TOL)
    eqn = esk.query_norms(eQ)
    # The result reads the dot of a pair only inside the tie band. Bytes:
    # λ and the norms once, the band's rows, the queries, the lists;
    # operations: the band's dots and three for each pair's |Δλ| and test.
    band = torch.abs(eql[:, None] - el[None, :]) < esk.TIE_EPS
    band_pairs, band_rows = int(band.sum()), int(band.any(dim=0).sum())
    del band
    bms, by = bound(8 * eX.shape[0] + 4 * (band_rows * eX.shape[1] + eQ.numel() + 2 * BATCH)
                    + 8 * BATCH * e_splits * sfk.K_PAD,
                    2 * band_pairs * eX.shape[1] + 3 * BATCH * eX.shape[0])
    e_by_path = {p: c["energy_scan"] for p, c in path_counts.items() if c["energy_scan"]}
    w_by_path = {p: c["energy_window"] for p, c in path_counts.items() if c["energy_window"]}
    rows_out.append(dict(
        name="energy_scan", route="cuda", source="matternet_rs_tpu_torch/csrc/search_fused.cu",
        replaces="matternet_rs_tpu/energymaps.py search_energy_batch's full scan (no TPU kernel: "
                 "the [B, N] scores and lax.top_k)",
        launches=sum(e_by_path.values()), launches_by_path=e_by_path,
        tie_band_pairs=band_pairs, tie_band_rows=band_rows,
        mismatches_vs_plain=e_bad[:3],
        ms=cuda_ms(lambda: esk.energy_topk(eX, en, el, eQ, eql, K)),
        launch_ms=cuda_ms(lambda: esk.scan_partials(eX, en, el, eQ, eqn, eql, K, e_splits)),
        plain_ms=cuda_ms(lambda: esk.energy_topk_plain(eX, en, el, eQ, eql, K), reps=3),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.matmul(eQ, eX.T)),
        shape=f"B={BATCH} N={eX.shape[0]} F={eX.shape[1]} k={K} splits={e_splits}",
        library="torch.matmul(Q, X.T): the product alone",
        plain="energymaps' full scan before the kernel: the [B, N] scores, then topk_stable",
    ))
    check(not e_bad, f"energy_scan: kernel vs plain: {e_bad[:3]}")
    # The window route on the same batch: the scan's answer bit for bit, its
    # tally, and its launch alone beside energy_scan's; then both on one λ
    # for every row and query (the window's degenerate case: one band of N).
    def window_row(label, lam_s, idx_s, lam_i, ql_w):
        esk.reset_window_tally(dev)
        wi, wd = esk.energy_topk_window(eX, en, lam_s, idx_s, eQ, ql_w, K)
        si, sd = esk.energy_topk(eX, en, lam_i, eQ, ql_w, K)
        same = bool(torch.equal(wi, si) and torch.equal(wd.view(torch.int32), sd.view(torch.int32)))
        tally = esk.window_tally(dev)
        scan_ms = cuda_ms(lambda: esk.scan_partials(eX, en, lam_i, eQ, eqn, ql_w, K, e_splits))
        window_ms = cuda_ms(lambda: esk.energy_topk_window(eX, en, lam_s, idx_s, eQ, ql_w, K))
        check(same, f"{label}: window vs energy_scan + merge not bit for bit")
        return dict(bit_equal=same, tally_one_batch=tally, launch_ms=window_ms,
                    energy_scan_launch_ms=scan_ms,
                    energy_scan_and_merge_ms=cuda_ms(lambda: esk.energy_topk(eX, en, lam_i, eQ, ql_w, K)))

    w_cell = window_row("energy_window", es_lam, es_idx, el, eql)
    one = torch.full_like(el, 0.4)
    s_one, i_one = torch.sort(one, stable=True)
    w_one = window_row("energy_window (one λ)", s_one, i_one, one, torch.full_like(eql, 0.4))
    del one, s_one, i_one
    designs = window_designs(dev, flush, {
        "energy": (eX, en, el, es_lam, es_idx, eQ, eql),
        "energy_jl": jl_window_law(dev),
    })
    emit(phase="window_designs", card=card, **designs)
    torch.cuda.empty_cache()
    rows_out.append(dict(
        name="energy_window", route="cuda", source="matternet_rs_tpu_torch/csrc/energy_window.cu",
        replaces="matternet_rs_tpu/energymaps.py search_energy_batch's full scan (no TPU kernel), "
                 "in place of energy_scan + G's merge where the sorted λ view is on the card",
        launches=sum(w_by_path.values()), launches_by_path=w_by_path,
        ms=w_cell["launch_ms"], launch_ms=w_cell["launch_ms"], cell_law=w_cell, one_lambda=w_one,
        bound_ms=bms, bound_by=by,
        shape=f"B={BATCH} N={eX.shape[0]} F={eX.shape[1]} k={K}",
        plain="energy_scan + G's merge on the same inputs (bit for bit)",
    ))
    resources["energy_window"] = dict(
        ptxas=ptxas_resources(buildcache.BUILD_LOG.get("energy_window"), "energy_window_kernel"))
    check(sum(w_by_path.values()) > 0, "energy_window: never launched on a search path")
    del eX, en, el, eQ, eql, es_lam, es_idx, energy_scan_inputs
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
        elif kind == "striped":
            v = v + 10.0 * ((torch.arange(n_e, device=dev) % 2048) < 124)
        main = v[:, :ns_e * 256].contiguous()
        tmax = main.view(b_e, ns_e, 256).amax(dim=2) + (1.0 if kind == "overstated" else 0.0)
        if kind == "offset":
            main, tmax = misaligned(main), misaligned(tmax)
        return main.view(b_e, ns_e, 256), tmax, (v[:, ns_e * 256:].contiguous() if nr_e else None), n_e

    stage_cases = [(b_e, 64, nr_e, kind, k_e) for kind in EDGE_KINDS_H for b_e in EDGE_B_H
                   for nr_e in EDGE_NR_H for k_e in EDGE_K_H]
    stage_cases += [(b_e, ns_e, nr_e, kind, 16) for ns_e in (1, 8) for kind in ("random", "equal")
                    for b_e in EDGE_B_H for nr_e in EDGE_NR_H]
    stage_cases += [(7, 5000, 576, "random", k_e) for k_e in EDGE_K_H]
    # The wide design (16 < k ≤ 128): every kind with every B, tail and k
    # (140 sub-tiles: c < ns up to k = 128; also maxima 1 above their
    # sub-tiles, where the first bar fails its count), every sub-tile
    # selected with the large scores in 31 threads' positions (more than a
    # list holds reach either bar: the radix select), the 10M-row index's
    # maxima; each also with a list cap of 0 (every selection through the
    # radix select).
    stage_cases += [(b_e, 140, nr_e, kind, k_e) for kind in EDGE_KINDS_H + ("striped", "overstated")
                    for b_e in EDGE_B_H for nr_e in EDGE_NR_H for k_e in EDGE_K_WIDE]
    stage_cases += [(b_e, k_e + so.SELECT_MARGIN, nr_e, kind, k_e) for kind in ("striped", "equal")
                    for b_e in EDGE_B_H for nr_e in EDGE_NR_H for k_e in EDGE_K_WIDE]
    stage_cases += [(7, 39_056, 576, kind, k_e) for kind in ("random", "striped") for k_e in EDGE_K_WIDE]
    for b_e, ns_e, nr_e, kind, k_e in stage_cases:
        main_e, tmax_e, tail_e, n_e = stage_scores(b_e, ns_e, nr_e, kind)
        args_e = (main_e, tmax_e, tail_e, n_e, k_e, so.SELECT_MARGIN)
        tp_, ip_ = tmk.select_topk_plain(*args_e)
        got = [tmk.select_topk(*args_e)]
        if k_e > tmk.TOPK_MAX_K:
            ops_e = tmk._subtile_topk_operands(*args_e)
            tmk._subtile_topk_launch(*ops_e, cap=0)
            got.append(ops_e[2:])
        same = all(bool(torch.equal(ik_, ip_)) and bit_equal(tk_, tp_) for tk_, ik_ in got)
        what = (f"subtile_topk B={b_e} ns={ns_e} c={min(ns_e, k_e + so.SELECT_MARGIN)} tail={nr_e} "
                f"k={k_e} {kind}{' (cap 512 and 0)' if len(got) > 1 else ''}")
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
