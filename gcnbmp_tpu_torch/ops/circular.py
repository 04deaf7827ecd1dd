"""Circular correlation, the HolE pair scorer's op.

Port of gcnbmp_tpu/ops/circular.py:30-54 (the rfft form):

    corr(a, b)[..., k] = sum_d a[..., d] * b[..., (d + k) % D]
                       = irfft(conj(rfft(a)) * rfft(b), n=D)

The JAX package switches to a time-domain matmul for D <= 16 on a
crossover measured on its own hardware; that switch is not ported.
Serving needs no custom backward; torch's FFT autograd covers training
use until a later change needs the closed form.
"""

from __future__ import annotations

import torch


def circular_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fa = torch.fft.rfft(a.float(), dim=-1)
    fb = torch.fft.rfft(b.float(), dim=-1)
    return torch.fft.irfft(torch.conj(fa) * fb, n=a.shape[-1], dim=-1)
