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
3. wide — a build at N = 40,000, F = 768, so the wide-F λ route (the
   TPU's F-tiled kernel range) runs through the builder.
   Launch counts are set to 0 just before phases 2 and 3 and read just
   after each; every kernel of a phase must have launched.
4. kernels — each kernel against its plain PyTorch version on the inputs
   the main path gave it (λ: |Δ| ≤ 1e-5·max(1, |λ|); scores and maxima:
   ≤ 1e-5 abs; gather: bit for bit), timed with CUDA events over cold-L2
   launches beside its plain version, the one PyTorch call that computes
   the same thing where there is one, and the card's least time for the
   work (the larger of bytes over 3.35 TB/s and f32 FLOP over 67 TFLOP/s,
   H100 SXM data sheet).

Then the ``kernels`` line, the card's name and power limit
(``nvidia-smi``), and last ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero. Without a CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_MAIN, F_MAIN, SEED_MAIN = 1_000_000, 128, 44
N_WIDE, F_WIDE, SEED_WIDE = 40_000, 768, 45
BATCH, K, ALPHA, N_BATCHES = 256, 10, 0.7, 3
TOL_LAMBDA, TOL_SCORE = 1e-5, 1e-5

# H100 SXM data sheet (dense): HBM3 3.35 TB/s, f32 FFMA 67 TFLOP/s.
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12
TOP_KERNELS = 10


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    from matternet_rs_tpu_torch import ArrowSpaceBuilder, buildcache, native
    from matternet_rs_tpu_torch.ops import kernels
    from matternet_rs_tpu_torch.ops import search as so
    from matternet_rs_tpu_torch.ops import taumode as tmo
    from matternet_rs_tpu_torch.ops.kernels import _cuda
    from matternet_rs_tpu_torch.ops.kernels import taumode as tk
    from matternet_rs_tpu_torch.ops.kernels import tilemax as tmk
    from matternet_rs_tpu_torch.utils.fixtures import make_energy_test_dataset
    from matternet_rs_tpu_torch.utils.parity import topk_mismatches

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
    plain_mismatch, self_fail = [], []
    for r, idx, sc, raw in results:
        check(idx.shape == (BATCH, K) and np.all(np.isfinite(sc)), "bad search output")
        rt = torch.from_numpy(r).to(dev)
        Q = Xt[rt]
        ql = torch.clamp((torch.from_numpy(raw).to(dev) - mn) / rng_, 0.0, 1.0)
        # Each query's blended score against its own row, as the scan scores it.
        denom = norms[rt] * torch.sqrt(torch.sum(Q * Q, dim=-1))
        cos = torch.where(denom > 1e-12, torch.sum(Q * Q, dim=-1) / torch.clamp(denom, min=1e-12),
                          torch.zeros_like(denom))
        lam_sim = 1.0 - torch.clamp(torch.abs(lams[rt] - ql), max=1.0)
        own = (ALPHA * cos + (1.0 - ALPHA) * lam_sim).cpu().numpy()
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in batches[1:]:
            aspace.search_batch(X[r], gl, k=K, alpha=ALPHA)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    dev_busy = busy_ms(prof.events(), DeviceType.CUDA) / N_BATCHES

    def dev_ms(a):
        return getattr(a, "self_device_time_total", None) or getattr(a, "self_cuda_time_total", 0)

    traced = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    top = sorted(traced, key=dev_ms, reverse=True)[:TOP_KERNELS]
    emit(phase="profile", card=card, batches=N_BATCHES, wall_ms_per_batch=wall_ms,
         device_busy_ms_per_batch=dev_busy,
         idle_share=1.0 - dev_busy / wall_ms if wall_ms > 0 else None,
         top_kernels=[{"name": a.key[:80], "calls_per_batch": a.count / N_BATCHES,
                       "device_ms_per_batch": dev_ms(a) / 1e3 / N_BATCHES}
                      for a in top if dev_ms(a) > 0])

    # -- 3. wide-F build -----------------------------------------------
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

    # -- 4. kernels against their plain versions -----------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2

    def cuda_ms(fn, reps=5):
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

    rows_out = []

    def lam_row(label, replaces, Xk, L, launches):
        n, f = Xk.shape
        tau = tmo.select_tau(Xk, tmo.TAU_MEDIAN)
        got = tk.taumode_lambdas_fused(Xk, L, tau)
        ref = tk.taumode_lambdas_plain(Xk, L, tau)
        err = (got - ref).abs()
        ok = bool(torch.all(err <= TOL_LAMBDA * torch.clamp(ref.abs(), min=1.0)))
        bms, by = bound(4 * (n * f + f * f + 2 * f + 2 * n), 14 * n * f * f)
        rows_out.append(dict(
            name=label, route="cuda", source="matternet_rs_tpu_torch/csrc/taumode.cu",
            replaces=replaces, launches=launches, max_abs_err=float(err.max()),
            ms=cuda_ms(lambda: tk.taumode_lambdas_fused(Xk, L, tau)),
            plain_ms=cuda_ms(lambda: tk.taumode_lambdas_plain(Xk, L, tau), reps=3),
            bound_ms=bms, bound_by=by, library_ms=None, shape=f"N={n} F={f}",
        ))
        check(ok, f"{label}: kernel vs plain λ beyond tolerance (max {float(err.max())})")

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
    emit(phase="kernels", card=card, rows=len(rows_out))

    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
