"""The work of the rotation null's surrogate pass with 16-bit operands
(``compute_dtype`` bfloat16 or float16), from shapes alone.

As ``null_surrogate.py``: per chunk of S surrogates the contraction's
2·nF·S·J·P·N operations, on the tensor cores' 16-bit peak
(``peaks.PEAKS["bf16_flops"]``); but the features (nF, J·P, S) and the
coefficients (nF, J·P, N) are read as 2-byte values, and base, observed
(read), the counts and the S maxima (written) as 4-byte ones, each once
per chunk.  The count is of the step, whatever kernel runs it.
"""
from __future__ import annotations


def chunk_work(S: int, nF: int, JP: int, N: int) -> tuple[float, float]:
    flops = 2.0 * nF * S * JP * N
    nbytes = 2.0 * (nF * JP * S + nF * JP * N) + 4.0 * (3 * nF * N + S)
    return flops, nbytes


def pass_work(n_drawn: int, S: int, nF: int, JP: int, N: int
              ) -> tuple[float, float]:
    """The whole pass: n_drawn surrogates in chunks of S."""
    flops, nbytes = chunk_work(S, nF, JP, N)
    n_chunks = -(-n_drawn // S)
    return n_chunks * flops, n_chunks * nbytes
