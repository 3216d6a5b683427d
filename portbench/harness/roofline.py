"""The table of peaks and the least time for a unit of work.

Work is counted from what the inputs need (``work/<kind>.py``), not from
what a kernel happens to do, so a share of it reads the same whatever
implements it and cannot pass 100%: each input byte read once, each output
byte written once, products at the cheapest f32-accurate rate the port
already uses (three bf16 passes on the tensor cores), elementwise work at
the CUDA cores' float32 rate. Peaks: NVIDIA's data sheet for the H100 SXM
(dense)."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
F32_ACCURATE_PASSES = 3        # bf16x3: an f32-accurate product as three bf16 products


def least_seconds(work: dict) -> float:
    """The least time for ``work``: the largest of its byte, tensor-core and
    CUDA-core times (each bound holds alone)."""
    return max(work.get("bytes", 0.0) / PEAK_BYTES_S,
               work.get("tensor_flops", 0.0) / PEAK_BF16_FLOP_S,
               work.get("cuda_flops", 0.0) / PEAK_F32_FLOP_S)
