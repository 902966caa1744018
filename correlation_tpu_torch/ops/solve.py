"""Batched Levenberg-Marquardt updates for tiny (NP <= 6) systems.

Port of correlation_tpu/ops/solve.py (lm_delta / _chol_solve_rows) in one
[S, NP] layout.  The system is scaled by 1/N and its diagonal multiplied
by (1 + lambda), then solved by an unrolled Cholesky over the subset
axis.  A non-positive pivot makes 1/sqrt return inf or NaN, so a singular
system yields a non-finite update: that is the SOLVER signal the LM
loop reads.  torch.linalg.cholesky would raise or report instead, so
it is not used.  This is plain tensor code; the JAX package leaves the
same step to XLA.
"""

from __future__ import annotations

import torch


def _chol_solve_cols(a, b, n):
    """a: n x n nested list of [S] columns, b: n [S] columns -> n [S]."""
    l = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        d = a[j][j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        # The pivot's float32 sqrt, correctly rounded on every device: CUDA
        # builds of torch.sqrt / torch.rsqrt on float32 are approximate,
        # while a float64 sqrt rounded to float32 is the exact IEEE result.
        inv = 1.0 / torch.sqrt(d.double()).float()
        inv_d[j] = inv
        l[j][j] = d * inv  # sqrt(d); NaN when d <= 0 (singular)
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * inv_d[i]
    return x


def lm_delta(a_mat, b_vec, lam, scaling):
    """Solve (scaling*A with diagonal * (1 + lam)) dp = scaling*b per subset.

    a_mat [S, NP, NP] and b_vec [S, NP] are unscaled sums; lam and scaling
    are [S].  Returns dp [S, NP]; singular systems give non-finite rows.
    """
    n = b_vec.shape[-1]
    damp = 1.0 + lam
    a = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            e = a_mat[:, i, j] * scaling
            if i == j:
                e = e * damp
            a[i][j] = e
    b = [b_vec[:, i] * scaling for i in range(n)]
    return torch.stack(_chol_solve_cols(a, b, n), dim=-1)
