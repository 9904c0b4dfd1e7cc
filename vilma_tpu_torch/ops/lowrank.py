"""Host-side low-rank factorization of LD blocks.

A copy of vilma_tpu/ops/lowrank.py (numpy only): the JAX package's
`vilma_tpu.ops` package imports jax on import, so the port carries its
own copy instead of importing it.

This is the build/load-time layer: dense symmetric correlation blocks are
eigendecomposed on the host CPU (LAPACK) and truncated, producing the
(eigenvectors, eigenvalues, diagonal) factors that are then packed into
device-resident padded tensors (see vilma_tpu_torch.ops.blocks).

Semantics match the reference's `_svd_threshold` / `LowRankMatrix.__init__`
(reference matrix_structures.py:15-146): keep eigenvalues >= 1 - sqrt(t);
if none survive, fall back to a rank-0 sentinel; additionally drop
eigenvalues <= 1e-12 * max(eigenvalue). Unlike the reference we store only
(u, s, d) since v == u.T always holds for symmetric inputs.
"""
from dataclasses import dataclass

import numpy as np


@dataclass
class LowRankFactor:
    """One symmetric block factored as u @ diag(s) @ u.T + diag(d).

    Fields:
        u: [n, r] eigenvectors (columns).
        s: [r] eigenvalues (all > 0 after thresholding, except the rank-0
            sentinel where r == 1 and s[0] == 0).
        d: [n] diagonal component.
        rank: rank as defined by the reference (matrix_structures.py:213-234).
    """
    u: np.ndarray
    s: np.ndarray
    d: np.ndarray
    rank: int

    @property
    def n(self):
        return self.u.shape[0]

    @property
    def r(self):
        return self.u.shape[1]

    def dense(self):
        """Reconstruct the dense block (testing / slow paths only)."""
        return (self.u * self.s) @ self.u.T + np.diag(self.d)


def eigh_threshold(matrix, ld_thresh):
    """Eigendecompose `matrix` keeping eigenvalues >= 1 - sqrt(ld_thresh).

    Mirrors reference _svd_threshold (matrix_structures.py:15-28): a
    threshold t guarantees SNP pairs with r^2 < t stay linearly independent.
    Returns (u [n,k], s [k]); if no eigenvalue survives, returns the
    sentinel (ones((n,1)), zeros(1)) denoting a rank-0 block.
    """
    s_vals, vecs = np.linalg.eigh(matrix)
    keep = s_vals >= 1 - np.sqrt(ld_thresh)
    if not np.any(keep):
        return np.ones((matrix.shape[0], 1)), np.zeros(1)
    return np.ascontiguousarray(vecs[:, keep]), np.ascontiguousarray(s_vals[keep])


def factor_block(X=None, t=1.0, u=None, s=None, d=None, check_symmetric=True):
    """Build a LowRankFactor from a dense symmetric block or a factorization.

    Mirrors reference LowRankMatrix.__init__ (matrix_structures.py:72-146):
      - from dense X: threshold-eigendecompose, d = 0
      - from (u, s): re-apply the threshold `t` to s, d defaults to 0
      - always drop eigenvalues <= 1e-12 * max(s); if none remain, store the
        rank-0 sentinel (first eigenvector, s=[0]).
    """
    if X is not None:
        if u is not None or s is not None or d is not None:
            raise ValueError('Cannot provide both a matrix and a '
                             'factorization')
        if check_symmetric and not np.allclose(X, X.T):
            raise ValueError('Cannot factor an asymmetric matrix.')
        u, s = eigh_threshold(np.asarray(X, dtype=np.float64), t)
        d = np.zeros(X.shape[0])
    else:
        if u is None or s is None:
            raise ValueError('Need to provide either a matrix or '
                             'a factorization')
        u = np.asarray(u, dtype=np.float64)
        s = np.asarray(s, dtype=np.float64)
        if d is None:
            d = np.zeros(u.shape[0])
        d = np.asarray(d, dtype=np.float64)
        keep = s >= 1 - np.sqrt(t)
        u, s = u[:, keep], s[keep]

    keep = s > 1e-12 * (np.max(s) if s.size else 0.0)
    if keep.sum() > 0:
        u, s = u[:, keep], s[keep]
    else:
        # rank-0 sentinel, matching matrix_structures.py:141-145
        u = u[:, :1] if u.shape[1] else np.ones((u.shape[0], 1))
        s = np.zeros(1)
    return LowRankFactor(u=u, s=s, d=np.copy(d), rank=_rank(u, s, d))


def _rank(u, s, d):
    """Rank with the reference's conventions (matrix_structures.py:213-234)."""
    if np.allclose(d, 0):
        if s.shape[0] > 1:
            return int(s.shape[0])
        return 0 if s[0] == 0 else 1
    if np.all(d > 0):
        return int(d.shape[0])
    mat = np.diag(d) + (u * s) @ u.T
    return int(np.linalg.matrix_rank(mat, hermitian=True))
