"""bf16 arrays on the host without ``ml_dtypes``.

numpy has no bfloat16 of its own; the JAX package decodes a bf16 wire
payload as ``ml_dtypes.bfloat16``, a dtype the port never imports.  The
port decodes it as :data:`BF16_WORDS` instead: the raw 16-bit words
under a 2-byte void dtype.  No numpy arithmetic or cast accepts a void
array, so code that does not know these words fails on them and never
folds them as integers.  Code that does know them recognises them by
:func:`is_bf16` and either moves the words as they are (the torch
engine stages them as bf16 on the card) or widens them exactly
(:func:`widen_bf16`: a bf16 value is the top half of the fp32 of the
same value).  ``is_bf16`` also takes ``ml_dtypes.bfloat16`` arrays, which
a caller that has JAX loaded may hand in.
"""
from __future__ import annotations

import numpy as np

#: the dtype the port's wire decodes a bf16 payload to: raw words, no
#: arithmetic.  It keeps its name through a shared-memory object header
#: (``"|V2"``), so a forked worker recognises it too.
BF16_WORDS = np.dtype("V2")


def is_bf16(dtype) -> bool:
    """bf16 words: ``BF16_WORDS`` (a field-less 2-byte void) or
    ``ml_dtypes.bfloat16``."""
    dt = np.dtype(dtype)
    return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2
                                     and dt.names is None)


def widen_bf16(a: np.ndarray, out: np.ndarray = None) -> np.ndarray:
    """The exact fp32 values of bf16 words (into ``out`` when given: an
    fp32 array of ``a``'s shape)."""
    if out is None:
        out = np.empty(a.shape, np.float32)
    bits = out.view(np.uint32)
    np.copyto(bits, a.view(np.uint16))
    np.left_shift(bits, 16, out=bits)
    return out


def as_f32(a: np.ndarray) -> np.ndarray:
    """``np.ascontiguousarray(a, dtype=np.float32)``, with bf16 words
    widened exactly instead of refused."""
    if is_bf16(a.dtype):
        return widen_bf16(np.ascontiguousarray(a))
    return np.ascontiguousarray(a, dtype=np.float32)
