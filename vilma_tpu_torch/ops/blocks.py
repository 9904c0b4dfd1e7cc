"""Device-resident packed block-diagonal LD tensors (port of
vilma_tpu/ops/blocks.py).

LD blocks are packed into a few *buckets* of padded dense tensors:

    u: [B, Pmax, Rmax]   eigenvectors (rows past a block's size are zero)
    s: [B, Rmax]         eigenvalues  (entries past a block's rank are zero)
    inv_s: [B, Rmax]     reference-style pseudo-inverse of s
    d: [B, Pmax]         diagonal component
    perm: [B, Pmax]      genome index of each block row (pads -> n, a
                         sentinel one-past-the-end slot)

so every block operation is one batched contraction per bucket, with one
gather from and one scatter-add into genome-ordered vectors of n+1 slots
(the last slot absorbs every pad read and write and is sliced off; real
genome indices never collide, so the scatter is deterministic on the
card too). The bucket matvec runs the hand-written CUDA kernel
(ops/cuda/block_matvec.py) on CUDA tensors. `matrix_power` keeps the
reference's dropped permutation through each bucket's `seq` map.

Not ported: the TPU-only 128-row gather/scatter path (`_dot_rows`,
`grows`/`srows`, `row_aligned`), the shard-local layout and its
shard_map bodies, and the `--mmap` spill (ROADMAP queue 1).
"""
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from vilma_tpu_torch.ops.cuda import block_matvec

# block sizes pad up to one of these tiers (as in the JAX package)
_SIZE_TIERS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _pad_to_tier(n):
    for t in _SIZE_TIERS:
        if n <= t:
            return t
    raise ValueError(f'LD block of size {n} exceeds the maximum supported '
                     f'block size {_SIZE_TIERS[-1]}')


def _pad_rank(r):
    return max(8, int(-(-r // 8) * 8))


@dataclass(frozen=True)
class BlockBucket:
    """One bucket of equally-padded LD blocks (see module docstring)."""
    u: torch.Tensor       # [B, Pmax, Rmax] (f64, f32 or bf16)
    s: torch.Tensor       # [B, Rmax]
    inv_s: torch.Tensor   # [B, Rmax]
    d: torch.Tensor       # [B, Pmax]
    perm: torch.Tensor    # [B, Pmax] int64, pads -> n
    seq: torch.Tensor = None  # [B, Pmax] int64 sequential (block-order)
    #   positions, pads -> n: matrix_power's scatter map. The reference
    #   builds its powered matrix without the permutation
    #   (matrix_structures.py:410-416), so block results land at
    #   sequential offsets with the missing indices at the end; the
    #   reference's seeded sim outputs depend on this

    @property
    def num_blocks(self):
        return self.u.shape[0]

    @property
    def pmax(self):
        return self.u.shape[1]

    @property
    def rmax(self):
        return self.u.shape[2]


@dataclass(frozen=True)
class PackedLD:
    """A symmetric block-diagonal matrix in packed bucket form
    (reference BlockDiagonalMatrix, matrix_structures.py:237-447):
    implicit zero rows/columns for `missing` genome indices and an
    arbitrary genome<->block permutation."""
    buckets: tuple            # tuple[BlockBucket]
    n: int                    # total genome indices (incl. missing)
    has_diag: bool            # any block has a nonzero diagonal part
    rank: float               # sum of per-block ranks (reference get_rank)
    missing: tuple            # genome indices with no LD block

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def device(self):
        return self.buckets[0].u.device if self.buckets else None

    def get_rank(self):
        return self.rank


def pack(factors, block_indices, n, dtype=torch.float64, u_dtype=None,
         device='cpu'):
    """Pack per-block lowrank.LowRankFactor objects into a PackedLD.

    block_indices[b] gives the genome index of each row of block b;
    indices covered by no block are `missing`. u_dtype (e.g.
    torch.bfloat16) is the storage type of the eigenvector tensors alone:
    they dominate device traffic ~400x over s/d. Defaults to `dtype`."""
    if u_dtype is None:
        u_dtype = dtype
    if len(factors) != len(block_indices):
        raise ValueError('factors and block_indices must align')
    covered = (np.concatenate([np.asarray(ix) for ix in block_indices])
               if block_indices else np.array([], dtype=np.int64))
    if covered.size != np.unique(covered).size:
        raise ValueError('block_indices assign a genome index to two blocks')
    if covered.size and (covered.min() < 0 or covered.max() >= n):
        raise ValueError('block index out of range')
    missing = tuple(sorted(set(range(n)) - set(covered.tolist())))

    # sequential (insertion-order) offsets, matrix_power's scatter map
    seq_starts = np.concatenate([[0], np.cumsum([f.n for f in factors])])
    groups = {}
    for pos, (f, ix) in enumerate(zip(factors, block_indices)):
        ix = np.asarray(ix, dtype=np.int64)
        if f.n != ix.shape[0]:
            raise ValueError('factor size does not match its index list')
        key = (_pad_to_tier(f.n), _pad_rank(f.r))
        groups.setdefault(key, []).append((f, ix, int(seq_starts[pos])))

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    buckets = []
    for (pmax, rmax), items in sorted(groups.items()):
        B = len(items)
        # u is staged in the float type and rounded once on conversion
        u = np.zeros((B, pmax, rmax),
                     dtype=np.float64 if dtype == torch.float64
                     else np.float32)
        s = np.zeros((B, rmax), dtype=np_dtype)
        inv_s = np.zeros((B, rmax), dtype=np_dtype)
        d = np.zeros((B, pmax), dtype=np_dtype)
        perm = np.full((B, pmax), n, dtype=np.int64)
        seq = np.full((B, pmax), n, dtype=np.int64)
        for b, (f, ix, start) in enumerate(items):
            u[b, :f.n, :f.r] = f.u
            s[b, :f.r] = f.s
            # reference inv_s (matrix_structures.py:140-145): 1/s for
            # kept eigenvalues, 0 for the rank-0 sentinel
            with np.errstate(divide='ignore'):
                inv_s[b, :f.r] = np.where(
                    f.s > 0, 1.0 / np.where(f.s > 0, f.s, 1.0), 0.0)
            d[b, :f.n] = f.d
            perm[b, :f.n] = ix
            seq[b, :f.n] = np.arange(start, start + f.n)
        buckets.append(BlockBucket(
            u=torch.from_numpy(u).to(device=device, dtype=u_dtype),
            s=torch.from_numpy(s).to(device),
            inv_s=torch.from_numpy(inv_s).to(device),
            d=torch.from_numpy(d).to(device),
            perm=torch.from_numpy(perm).to(device),
            seq=torch.from_numpy(seq).to(device)))

    has_diag = any(not np.allclose(f.d, 0) for f in factors)
    rank = float(sum(f.rank for f in factors))
    return PackedLD(buckets=tuple(buckets), n=n, has_diag=has_diag,
                    rank=rank, missing=missing)


# ---------------------------------------------------------------------------
# Core ops: gather genome-order vectors into bucket layout, one batched
# contraction per bucket, scatter-add back into n+1 slots.
# ---------------------------------------------------------------------------

def _extend(vector, pad_value=0.0):
    """Append the sentinel slot n (pads gather pad_value from it)."""
    pad = vector.new_full(vector.shape[:-1] + (1,), pad_value)
    return torch.cat([vector, pad], dim=-1)


def _scatter_accumulate(parts, n, dtype, device):
    """parts: list of (perm [B,P], values [B,P]) -> genome vector [n].
    index_add_ has no mode='drop': pads land in slot n, sliced off."""
    out = torch.zeros(n + 1, dtype=dtype, device=device)
    for perm, vals in parts:
        out.index_add_(0, perm.reshape(-1), vals.reshape(-1).to(dtype))
    return out[:n]


def _u_as(bk, dtype):
    """u in the contraction type (JAX promotes bf16 u to f32/f64)."""
    return bk.u if bk.u.dtype == dtype else bk.u.to(dtype)


def dot_multi(ld, vectors):
    """Matrix @ each of C vectors: [C, n] -> [C, n]. Cohorts sharing one
    LD panel read U once per evaluation per group of at most
    block_matvec.MAX_COHORTS, one kernel launch each, instead of once per
    cohort."""
    C, n = vectors.shape
    xs_ext = _extend(vectors)                               # [C, n+1]
    out = torch.zeros(n + 1, C, dtype=vectors.dtype, device=vectors.device)
    step = block_matvec.MAX_COHORTS
    for bk in ld.buckets:
        xb = xs_ext[:, bk.perm].permute(1, 0, 2)            # [B, C, P]
        parts = [block_matvec.bucket_matvec_multi(
            bk.u, bk.s, bk.d, xb[:, c0:c0 + step].contiguous())
            for c0 in range(0, C, step)]
        yb = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        out.index_add_(0, bk.perm.reshape(-1),
                       yb.permute(0, 2, 1).reshape(-1, C))
    return out[:n].T


def dot(ld, vector):
    """Matrix @ vector (reference matrix_structures.py:389-408)."""
    return dot_multi(ld, vector[None, :])[0]


def inverse_dot(ld, vector):
    """PseudoInverse(Matrix) @ vector (reference matrix_structures.py:
    159-196). Schema-loaded LD always has d == 0, the batched
    u @ (inv_s * (u.T @ v)) branch; blocks with a nonzero diagonal take
    the reference's host-side per-block branches."""
    if ld.has_diag:
        return _inverse_dot_host(ld, vector)
    x_ext = _extend(vector)
    parts = []
    for bk in ld.buckets:
        u = _u_as(bk, vector.dtype)
        xb = x_ext[bk.perm]
        t = torch.einsum('bpr,bp->br', u, xb) * bk.inv_s
        parts.append((bk.perm, torch.einsum('bpr,br->bp', u, t)))
    return _scatter_accumulate(parts, ld.n, vector.dtype, vector.device)


def _block_inverse_dot_np(u, s, inv_s, d, xb):
    """One block's pseudo-inverse action in numpy (the reference's three
    branches, matrix_structures.py:159-196)."""
    if np.all(np.isclose(d, 0)):
        return u @ (inv_s * (u.T @ xb))
    if np.any(np.isclose(np.abs(d), 0)):
        # mixed zero/nonzero diagonal: dense pinv with the reference's
        # spectrum-derived rcond
        reconst = np.diag(d) + (u * s) @ u.T
        e_vals = np.linalg.eigh(reconst)[0][::-1]
        full = np.where(np.isclose(np.cumsum(e_vals) / np.sum(e_vals),
                                   1.))[0]
        cut = full[0] if len(full) else len(e_vals) - 1
        rcond = e_vals[cut] / e_vals[0] * 0.1
        return np.linalg.pinv(reconst, rcond=rcond) @ xb
    if np.all(s == 0):
        # rank-0 sentinel with invertible d: the matrix is diag(d)
        return xb / d
    # invertible diagonal: Woodbury with the reference's diag(inv_s)
    col_active = np.abs(u).sum(axis=0) > 0
    small = np.diag(inv_s) + u.T @ (u / d[:, None])
    small[~col_active] = 0.
    small[:, ~col_active] = 0.
    small[~col_active, ~col_active] = 1.
    corr = u @ np.linalg.solve(small, u.T @ (xb / d)) / d
    return xb / d - corr


def _inverse_dot_host(ld, vector):
    vec = vector.detach().cpu().numpy()
    out = np.zeros(ld.n, dtype=vec.dtype)
    for bk in ld.buckets:
        perm = bk.perm.cpu().numpy()
        u_all = bk.u.to(vector.dtype).cpu().numpy()
        s_all = bk.s.cpu().numpy()
        inv_s_all = bk.inv_s.cpu().numpy()
        d_all = bk.d.cpu().numpy()
        for b in range(perm.shape[0]):
            live = perm[b] < ld.n
            if not live.any():
                continue
            ix = perm[b][live]
            out[ix] = _block_inverse_dot_np(u_all[b][live], s_all[b],
                                            inv_s_all[b], d_all[b][live],
                                            vec[ix])
    return torch.from_numpy(out).to(vector.device)


# bounds the chunked Woodbury solve's [C, R, R] temporaries (C*R*R
# elements, ~0.5 GB in f32)
_WOODBURY_CHUNK_ELEMS = 2 ** 27


def _woodbury_mid(bk, u, inv_dp, ut_xd):
    """solve(diag(inv_s) + u.T @ diag(inv_dp) @ u, ut_xd) per block, in
    block chunks that bound the [C, R, R] temporaries. Identity rows in
    padded rank slots (zero u columns) keep each solve well-posed.

    The system is symmetric positive definite (orthonormal u columns,
    dp > 0), so it is solved by Cholesky: the CPU LU route of
    torch.linalg.solve stalls in MKL's pivoting on 512-wide batches when
    torch runs more than one intra-op thread."""
    B, rmax = ut_xd.shape
    eye = torch.eye(rmax, dtype=ut_xd.dtype, device=ut_xd.device)
    chunk = max(1, min(B, _WOODBURY_CHUNK_ELEMS // (rmax * rmax)))
    mid = torch.empty_like(ut_xd)
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        u_c = u[sl]
        gram = torch.einsum('cpr,cpq->crq', u_c * inv_dp[sl][:, :, None],
                            u_c)
        col_active = u_c.abs().sum(dim=1) > 0                # [C, R]
        small = gram + bk.inv_s[sl][:, :, None] * eye
        small = small + (~col_active)[:, :, None] * eye
        mid[sl] = torch.cholesky_solve(ut_xd[sl][..., None],
                                       torch.linalg.cholesky(small))[..., 0]
    return mid


def ridge_inverse_dot(ld, vector, regularizer):
    """Inverse(Matrix + diag(regularizer)) @ vector via per-block Woodbury
    (reference matrix_structures.py:349-387 and 187-196, with the
    reference's diag(inv_s)). regularizer > 0 keeps it well-posed."""
    reg = torch.zeros_like(vector) + regularizer
    x_ext = _extend(vector)
    # pad slots read regularizer 1.0 so divisions stay finite; their u
    # rows are zero so they contribute nothing
    r_ext = _extend(reg, pad_value=1.0)
    parts = []
    for bk in ld.buckets:
        u = _u_as(bk, vector.dtype)
        xb = x_ext[bk.perm]
        dp = bk.d + r_ext[bk.perm]                           # [B, P]
        x_over_d = xb / dp
        ut_xd = torch.einsum('bpr,bp->br', u, x_over_d)      # [B, R]
        mid = _woodbury_mid(bk, u, 1.0 / dp, ut_xd)
        corr = torch.einsum('bpr,br->bp', u, mid) / dp
        parts.append((bk.perm, x_over_d - corr))
    return _scatter_accumulate(parts, ld.n, vector.dtype, vector.device)


def diag(ld):
    """Diagonal of the matrix (reference matrix_structures.py:426-440).
    The sum over the rank is a fixed pairwise tree of elementwise adds
    (zero-padded to a power of two), so every device gives the same
    bits."""
    parts = []
    dtype = torch.float64
    for bk in ld.buckets:
        u = _u_as(bk, bk.s.dtype)
        terms = (u * u) * bk.s[:, None, :]                   # [B, P, R]
        rank = terms.shape[-1]
        width = 1 << max(rank - 1, 0).bit_length()
        if width > rank:
            terms = torch.nn.functional.pad(terms, (0, width - rank))
        while terms.shape[-1] > 1:
            half = terms.shape[-1] // 2
            terms = terms[..., :half] + terms[..., half:]
        parts.append((bk.perm, terms[..., 0] + bk.d))
        dtype = bk.s.dtype
    return _scatter_accumulate(parts, ld.n, dtype, ld.device or 'cpu')


def matrix_power(ld, power):
    """Elementwise power of the eigenvalues (reference
    matrix_structures.py:205-211), as a new PackedLD.

    Reference-faithful quirk: the reference rebuilds the powered matrix
    WITHOUT its permutation (matrix_structures.py:410-416 omits perm=),
    so block results map to sequential offsets with the missing indices
    at the end. The powered buckets therefore gather from and scatter to
    the `seq` positions (the reference's sim noise, matrix_power(0.5),
    depends on this)."""
    if ld.has_diag:
        raise NotImplementedError('Matrix powers where the diagonal '
                                  'approximation is not zero have '
                                  'not yet been implemented.')
    out = []
    for bk in ld.buckets:
        if bk.seq is None:
            raise ValueError('matrix_power needs the buckets\' seq maps '
                             '(built by pack)')
        live = bk.s > 0
        s_new = torch.where(live, bk.s, torch.ones_like(bk.s)) ** power
        s_new = s_new * live
        inv_s = torch.where(s_new > 0, 1.0 / torch.where(
            s_new > 0, s_new, torch.ones_like(s_new)),
            torch.zeros_like(s_new))
        out.append(dataclasses.replace(bk, s=s_new.to(bk.s.dtype),
                                       inv_s=inv_s.to(bk.s.dtype),
                                       perm=bk.seq))
    return dataclasses.replace(ld, buckets=tuple(out))


def dot_i(ld, vector, i):
    """(Matrix @ vector)[i], touching only the block that holds i
    (reference matrix_structures.py:154-157,333-347): O(block size x
    rank) host work."""
    i = int(i)
    if i in set(ld.missing):
        return 0.
    vec = vector.detach().cpu().double().numpy() if torch.is_tensor(
        vector) else np.asarray(vector)
    for bk in ld.buckets:
        perm = bk.perm.cpu().numpy()
        hit_b, hit_p = np.nonzero(perm == i)
        if hit_b.size == 0:
            continue
        b, p = int(hit_b[0]), int(hit_p[0])
        live = perm[b] < ld.n
        xb = np.zeros(perm.shape[1], dtype=vec.dtype)
        xb[live] = vec[perm[b][live]]
        u = bk.u[b].double().cpu().numpy()
        s = bk.s[b].double().cpu().numpy()
        d = bk.d[b].double().cpu().numpy()
        return float(u[p] @ (s * (u.T @ xb)) + d[p] * xb[p])
    raise IndexError(f'index {i} not covered by any block')


def to_dense(ld):
    """The full dense [n, n] matrix as float64 numpy (testing only)."""
    out = np.zeros((ld.n, ld.n))
    for bk in ld.buckets:
        u = bk.u.double().cpu().numpy()
        s = bk.s.double().cpu().numpy()
        d = bk.d.double().cpu().numpy()
        perm = bk.perm.cpu().numpy()
        for b in range(u.shape[0]):
            rows = perm[b] < ld.n
            ix = perm[b][rows]
            dense = (u[b][rows] * s[b]) @ u[b][rows].T + np.diag(d[b][rows])
            out[np.ix_(ix, ix)] += dense
    return out
