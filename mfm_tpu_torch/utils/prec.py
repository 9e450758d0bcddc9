"""Matmul-precision scoping for the parity-critical compute path.

Counterpart of ``mfm_tpu/utils/prec.py``.  On the card a float32 matmul
may run in TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN's float32
convolutions do by default.  Either would break the port's parity budgets
against the float64 reference, so every public compute function runs
inside :func:`full_fp32_matmul`, which turns both off for the duration of
the call, checks that they are off, and restores the caller's settings
afterwards.  As in the reference, the setting is part of the parity
contract and not caller-overridable inside the package.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the body with TF32 off for matmuls and cuDNN."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        if matmul.allow_tf32 or cudnn.allow_tf32:
            raise RuntimeError("could not turn TF32 off for the parity path")
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def highest_matmul_precision(fn):
    """Run ``fn`` under :func:`full_fp32_matmul`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_fp32_matmul():
            return fn(*args, **kwargs)

    return wrapped
