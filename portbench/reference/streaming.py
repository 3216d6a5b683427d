"""Plain reference of the out-of-core streaming index and its resident
int8 sketch.

From the corpus (drawn anew) it works out again what the store's build
makes: the strided row sample of stage 1 (every ``N // sample_rows``-th
row from row 0, the first ``sample_rows``), the clustering scan replayed
over it (``reference.clustering``), the feature graph from the replay's
own centroids and every row's raw λ (``reference.eigen``), normalised by
the store's rule (``(λ − min)/(max − min)``, a range of 1 when every λ is
equal), the per-row int8 quantisation of the sketch, and the blended
scores of any query over every row, in float64 on the device the inputs
are on.

The quantisation is the store's rule: ``scale = max|x|/127`` (1 for a
zero row), ``code = round(x/scale)`` half to even, ``mult = scale/|x|``
(0 for ``|x| ≤ 1e-12``). A code one step from the float64 code is a
choice within rounding where ``x/scale`` lies within ``HALF_STEP_TOL`` of
its size of a half step (float32 arithmetic moves it at most 2⁻²³ of its
size); such codes are counted, not faulted.

``precision="tf32"`` is the control: every operand of a product, and the
rows the sketch quantises, rounded to TF32, the arithmetic in float32."""

from __future__ import annotations

import torch

from portbench.reference import clustering
from portbench.reference.eigen import (
    Precision,
    followed_laplacian,
    graph_edges,
    raw_lambdas,
)

HALF_STEP_TOL = 2.0 ** -21
ZERO_NORM = 1e-12
SKETCH_BLOCK = 1 << 20               # rows quantised at a time
SCORE_ELEMENTS = 1 << 28             # query × row scores held at a time


def sample(X: torch.Tensor, sample_rows: int) -> torch.Tensor:
    """The build's strided stage-1 sample of the rows of ``X``."""
    stride = max(1, X.shape[0] // max(int(sample_rows), 1))
    return X[::stride][:int(sample_rows)]


def quantize(X: torch.Tensor, prec: Precision):
    """``(v, mult)``: each element over its row's scale, unrounded, and
    each row's multiplier, in ``prec``."""
    x = prec.operand(X).to(prec.dtype)
    maxabs = x.abs().amax(dim=1)
    scale = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
    norms = torch.sqrt((x * x).sum(dim=1))
    mult = torch.where(norms > ZERO_NORM, scale / torch.clamp(norms, min=ZERO_NORM),
                       torch.zeros_like(norms))
    return x / scale[:, None], mult


class StreamIndex:
    """The reference of one store's build over ``X [N, F]`` (float32).
    ``follow`` (the program's state) settles the choices within rounding
    of the scan and the graph."""

    def __init__(self, X: torch.Tensor, cfg: dict, prec: str = "f64",
                 follow: dict | None = None):
        b, st = cfg["builder"], cfg["store"]
        self.prec = Precision(prec)
        self.X = X
        self.clustering = clustering.replay(
            sample(X, st["sample_rows"]), int(b["max_clusters"]), float(b["radius"]), self.prec,
            follow=None if follow is None else follow["assignments"])
        self.L, self.graph_ties = followed_laplacian(
            self.clustering.centroids.T.contiguous(), cfg["graph"], cfg["graph"]["topk"],
            self.prec, None if follow is None else follow["laplacian"])
        self.edges = graph_edges(self.L)
        raw = raw_lambdas(X, self.edges, self.prec)
        self.mn = float(raw.min())
        mx = float(raw.max())
        self.rng = mx - self.mn if mx > self.mn else 1.0
        self.lambdas = (raw - self.mn) / self.rng
        self.Xd = self.prec.operand(X).to(self.prec.dtype)
        self.norms = torch.sqrt(torch.sum(self.Xd * self.Xd, dim=1))
        # Query blocks of the comparison: their scores over every row in a few GB.
        self.query_block = max(1, min(256, SCORE_ELEMENTS // X.shape[0]))

    def query_lambdas(self, Q: torch.Tensor) -> torch.Tensor:
        raw = raw_lambdas(Q, self.edges, self.prec)
        return torch.clamp((raw - self.mn) / self.rng, 0.0, 1.0)

    def scores(self, Q: torch.Tensor, alpha: float) -> torch.Tensor:
        """``[B, N]`` blended scores ``α·cos + (1 − α)·(1 − min(|λ − λq|, 1))``
        of the queries ``Q`` against every row."""
        ql = self.query_lambdas(Q)
        Qd = self.prec.operand(Q).to(self.prec.dtype)
        qn = torch.sqrt(torch.sum(Qd * Qd, dim=1))
        s = (Qd @ self.Xd.T).to(self.prec.dtype)
        den = qn[:, None] * self.norms[None, :]
        s = torch.where(den > ZERO_NORM, s / torch.clamp(den, min=ZERO_NORM), torch.zeros_like(s))
        del den
        lam = (self.lambdas[None, :] - ql[:, None]).abs_().clamp_(max=1.0)
        return s.mul_(alpha).add_(lam.neg_().add_(1.0), alpha=1.0 - alpha)

    def sketch(self):
        """``(codes [N, F] int8, mults [N])`` in this reference's precision
        (the control's sketch)."""
        codes, mults = [], []
        for s in range(0, self.X.shape[0], SKETCH_BLOCK):
            v, m = quantize(self.X[s:s + SKETCH_BLOCK], self.prec)
            codes.append(torch.round(v).to(torch.int8))
            mults.append(m.float())
        return torch.cat(codes), torch.cat(mults)

    def sketch_readings(self, codes: torch.Tensor, mults: torch.Tensor) -> dict:
        """``sketch_code_mismatch``: codes of ``codes [N, F]`` more than
        one step from the float64 code, or one step where the value is not
        within rounding of a half step; ``sketch_mult_err``: the largest
        relative gap of ``mults [N]``; ``code_ties``: codes one step off at
        a half step (counted, not faulted)."""
        n = self.X.shape[0]
        if tuple(codes.shape) != tuple(self.X.shape) or tuple(mults.shape) != (n,):
            return {"sketch_code_mismatch": n * self.X.shape[1], "sketch_mult_err": float("inf"),
                    "code_ties": 0}
        bad = ties = 0
        err = 0.0
        for s in range(0, n, SKETCH_BLOCK):
            v, m = quantize(self.X[s:s + SKETCH_BLOCK], Precision("f64"))
            got = codes[s:s + SKETCH_BLOCK].to(v.device).double()
            step = (got - torch.round(v)).abs()
            frac = v - torch.floor(v)
            half = (frac - 0.5).abs() <= HALF_STEP_TOL * torch.clamp(v.abs(), min=1.0)
            tie = (step == 1) & half
            bad += int(((step > 0) & ~tie).sum())
            ties += int(tie.sum())
            gm = mults[s:s + SKETCH_BLOCK].to(v.device).double()
            gap = torch.where(m > 0, (gm - m).abs() / torch.where(m > 0, m, torch.ones_like(m)),
                              gm.abs())
            err = max(err, float(gap.max()))
        return {"sketch_code_mismatch": bad, "sketch_mult_err": err, "code_ties": ties}
