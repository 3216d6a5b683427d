"""Matmul precision policy (twin of ``matternet_rs_tpu/ops/_mm.py``).

The reference runs parity-critical products at ``Precision.HIGHEST`` (full
f32 accumulation). On the card a float32 product may otherwise go through
TF32 (about three decimal digits), so the policy is set explicitly, for
both cuBLAS and cuDNN, when this module is imported and again by
:func:`full_f32`.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """TF32 off everywhere; float32 products at ``highest`` precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


full_f32()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-f32 matmul (the exact tier's product)."""
    return torch.matmul(a, b)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as float32; bf16 and int8
    values are exact in bf16 and only widen."""
    if t.dtype in (torch.bfloat16, torch.int8):
        return t.float()
    return t.to(torch.bfloat16).float()


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 dot with ``preferred_element_type=f32``: both
    operands rounded to bf16, products (exact in f32) summed in f32.
    ``torch.matmul`` on bf16 tensors would round the result to bf16, so
    this multiplies the f32 widenings at full f32 instead."""
    return torch.matmul(_bf16_values(a), _bf16_values(b))


def mm_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's default-precision product (``mm_fast``: bf16
    multiplicands on its chip, sums in f32), which is :func:`mm_bf16`."""
    return mm_bf16(a, b)
