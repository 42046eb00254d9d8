"""The work of the rotation null's surrogate pass, from shapes alone.

Per chunk of S surrogates: stat = base + (G·coef)/J over nF band bins,
J·P trig features (P = K(K−1) per subject) and N = E·M cells, then the
per-surrogate max and the per-cell exceedance counts.  Operations: the
contraction's 2·nF·S·J·P·N.  Bytes, each read or written once per
chunk: the features (nF, J·P, S), the coefficients (nF, J·P, N), base
and observed (nF, N) read, the counts (nF, N) and the S maxima written,
float32.  The count is of the step, whatever kernel or library runs it.
"""
from __future__ import annotations


def chunk_work(S: int, nF: int, JP: int, N: int) -> tuple[float, float]:
    flops = 2.0 * nF * S * JP * N
    nbytes = 4.0 * (nF * JP * S + nF * JP * N + 3 * nF * N + S)
    return flops, nbytes


def pass_work(n_drawn: int, S: int, nF: int, JP: int, N: int
              ) -> tuple[float, float]:
    """The whole pass: n_drawn surrogates in chunks of S."""
    flops, nbytes = chunk_work(S, nF, JP, N)
    n_chunks = -(-n_drawn // S)
    return n_chunks * flops, n_chunks * nbytes
