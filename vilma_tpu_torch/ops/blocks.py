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

`fit --mmap` packs through a FactorSpill: factors and the eigenvector
buckets are staged in disk-backed memmaps, and a bucket reaches the card
in slices of blocks through one bounded pinned buffer.

A sharded PackedLD holds one PackedLD per shard, each on its shard's
device; its ops take and return one vector per shard (`split` makes
them). It has two layouts:

  * 'local' (`pack(n_shards=N)`, `shard`): the layout axis splits into N
    equal spans (parallel/alignment.py plans them), each shard holds the
    blocks of its span in span-local coordinates, and its ops act on
    each shard alone: no data crosses shards (the JAX package's
    _dot_sharded and _dot_multi_sharded);
  * 'gather' (`pack_gathered`, the JAX package's global-gather layout,
    for schemas that disagree on the order of shared variants): the
    axis of n slots (the variants, padded with inert slots to a multiple
    of N) splits into N spans of n / N, but the blocks keep their genome
    indices in [0, n): each size tier's blocks are dealt to the shards in
    contiguous runs (`deal_blocks`). Its ops gather the spans of a
    shard's snp line into the full vector, run the unchanged per-shard
    code on the shard's blocks, and add the line's full-length partial
    results, keeping each shard's span (`over_shards`). The gather and
    the sum are the methods `snp_gather` and `snp_sum_span` of the
    `comm` object the matrix carries (parallel/mesh.Mesh).

A process of a multi-process fit holds only its own shards.

Not ported: the TPU-only 128-row gather/scatter path (`_dot_rows`,
`grows`/`srows`, `row_aligned`).
"""
import dataclasses
import os
import shutil
import tempfile
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from vilma_tpu_torch.ops import lowrank
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
    # a sharded matrix has no buckets of its own: `shards` holds one
    # PackedLD per shard (this process's shards, the first of them global
    # shard `first_shard`), each for a span of n // shard_count slots: in
    # span coordinates (layout 'local') or in global ones ('gather')
    shards: tuple = ()
    shard_count: int = 1
    first_shard: int = 0
    # the lazy inverse flag (reference BlockDiagonalMatrix): `.dot` of an
    # inverted matrix applies the pseudo-inverse
    inverted: bool = False
    # a sharded matrix's layout, 'local' or 'gather' (module docstring);
    # a gathered matrix and each of its shards carry `comm`, the mesh
    # whose snp_gather and snp_sum_span join the shards of a line
    layout: str = 'local'
    comm: object = dataclasses.field(default=None, compare=False,
                                     repr=False)

    @property
    def shape(self):
        return (self.n, self.n)

    # the reference class's API (vilma_tpu/ops/blocks.py:126-160)
    def dot(self, vector):
        return (inverse_dot(self, vector) if self.inverted
                else dot(self, vector))

    def dot_i(self, vector, i):
        if self.inverted:
            raise NotImplementedError('dot_i with inverted matrices '
                                      'has not been implemented yet.')
        return dot_i(self, vector, i)

    def ridge_inverse_dot(self, vector, regularizer):
        if self.inverted:
            raise NotImplementedError('ridge_inverse_dot with inverted '
                                      'matrices has not been implemented '
                                      'yet.')
        return ridge_inverse_dot(self, vector, regularizer)

    def diag(self):
        if self.inverted:
            raise NotImplementedError('Getting the diagonal of an '
                                      'inverted matrix has not been '
                                      'implemented yet.')
        return diag(self)

    def matrix_power(self, power):
        return matrix_power(self, power)

    @property
    def inverse(self):
        return dataclasses.replace(self, inverted=not self.inverted)

    @property
    def shard_rows(self):
        return self.n // self.shard_count

    @property
    def device(self):
        if self.shards:
            return self.shards[0].device
        return self.buckets[0].u.device if self.buckets else None

    def get_rank(self):
        return self.rank


class _SpilledFactor:
    """A lowrank.LowRankFactor whose u lives on disk: duck-typed for
    everything pack() reads. `.u` opens a short-lived memmap of the
    spill's one payload file, so a schema of thousands of blocks holds
    one file descriptor at a time."""

    def __init__(self, spill, offset, shape, dtype, s, d, rank):
        self._spill = spill
        self._offset = offset
        self._shape = shape
        self._dtype = dtype
        self.s = s
        self.d = d
        self.rank = rank

    @property
    def u(self):
        return np.memmap(self._spill.payload_path, mode='r',
                         dtype=self._dtype, shape=self._shape,
                         offset=self._offset)

    @property
    def n(self):
        return self._shape[0]

    @property
    def r(self):
        return self._shape[1]


class FactorSpill:
    """Disk-backed staging of factor payloads (`fit --mmap`; the JAX
    package's FactorSpill, the reference's HDF5 spill,
    matrix_structures.py:120-135).

    `store()` appends a freshly factored block's u to one payload file,
    and `pack(spill=...)` assembles the bucket tensors in disk-backed
    memmaps, so the peak anonymous host memory of a load stays one block
    (plus one staging slice on the way to the card) instead of the
    factors and the packed tensors side by side. The files live in a
    private tempdir removed when the spill is collected; on Linux a
    memmap stays readable after the unlink, so a host PackedLD built
    from the spill stays valid."""

    def __init__(self, spill_dir=None):
        self.dir = tempfile.mkdtemp(prefix='vilma_tpu_torch_spill_',
                                    dir=spill_dir)
        self.payload_path = os.path.join(self.dir, 'factors.bin')
        self._payload = open(self.payload_path, 'wb')
        self._buckets = 0
        self._finalizer = weakref.finalize(
            self, _remove_spill, self._payload, self.dir)

    def store(self, factor):
        """Move a LowRankFactor's u onto disk."""
        u = np.ascontiguousarray(factor.u)
        offset = self._payload.tell()
        self._payload.write(u.tobytes())
        self._payload.flush()
        return _SpilledFactor(self, offset, u.shape, u.dtype,
                              s=factor.s, d=factor.d, rank=factor.rank)

    def bucket_array(self, shape, dtype):
        """A writable disk-backed array of zeros for one bucket's u."""
        path = os.path.join(self.dir, f'bucket{self._buckets}.npy')
        self._buckets += 1
        return np.lib.format.open_memmap(path, mode='w+', shape=shape,
                                         dtype=dtype)


def _remove_spill(payload, path):
    payload.close()
    shutil.rmtree(path, ignore_errors=True)


#: the most bytes of the pinned host buffer through which a spilled
#: bucket reaches the card
STAGING_BYTES = 64 << 20


def _u_from_spill(u, u_dtype, device):
    """A spilled bucket's u [B, Pmax, Rmax] (a disk-backed memmap in the
    staging float type) as a tensor of u_dtype on `device`.

    On the card the bucket moves in slices of whole blocks of at most
    STAGING_BYTES through one pinned buffer, reused once its asynchronous
    copy has finished; each slice is converted to u_dtype on the host by
    the conversion the unspilled path's `.to` makes, so the bits agree.
    On the host the memmap itself is the tensor (converted whole where
    u_dtype differs)."""
    src = torch.from_numpy(u)
    if torch.device(device).type == 'cpu':
        return src if src.dtype == u_dtype else src.to(u_dtype)
    out = torch.empty(u.shape, dtype=u_dtype, device=device)
    slices = _staging_slices(u.shape[0],
                             out[0].numel() * out.element_size())
    staging = torch.empty((slices[0].stop,) + tuple(u.shape[1:]),
                          dtype=u_dtype, pin_memory=True)
    for rows in slices:
        buf = staging[:rows.stop - rows.start]
        buf.copy_(src[rows])
        out[rows].copy_(buf, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
    return out


def _staging_slices(num_blocks, block_bytes):
    """Slices of whole blocks, each at most STAGING_BYTES (one block at
    the least)."""
    per = max(1, min(num_blocks, STAGING_BYTES // block_bytes))
    return [slice(b0, min(num_blocks, b0 + per))
            for b0 in range(0, num_blocks, per)]


def pack(factors, block_indices, n, dtype=torch.float64, u_dtype=None,
         device='cpu', spill=None, n_shards=1, shards=None,
         seq_starts=None):
    """Pack per-block lowrank.LowRankFactor objects into a PackedLD.

    block_indices[b] gives the genome index of each row of block b;
    indices covered by no block are `missing`. u_dtype (e.g.
    torch.bfloat16) is the storage type of the eigenvector tensors alone:
    they dominate device traffic ~400x over s/d. Defaults to `dtype`.
    With `spill` (a FactorSpill) each bucket's u is assembled in a
    disk-backed memmap and moved by _u_from_spill.

    n_shards > 1 (or a list of `shards`) packs a sharded PackedLD
    (module docstring): n must split into n_shards spans of a multiple of
    128 slots and no block may straddle a span boundary
    (parallel/alignment.py plans such layouts); both raise, as in the JAX
    package. `shards` lists the global shards to pack (all by default; a
    process of a multi-process fit packs its own) and `device` is one
    device or one per packed shard. `seq_starts` gives each block's
    offset in matrix_power's sequential order (by default the blocks
    follow each other in the order given)."""
    if n_shards > 1 or shards is not None:
        return _pack_sharded(factors, block_indices, n, dtype, u_dtype,
                             device, spill, n_shards, shards)
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
    if seq_starts is None:
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
        u_stage = np.float64 if dtype == torch.float64 else np.float32
        if spill is not None:
            u = spill.bucket_array((B, pmax, rmax), u_stage)
        else:
            u = np.zeros((B, pmax, rmax), dtype=u_stage)
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
        if spill is not None:
            u.flush()
            u_t = _u_from_spill(u, u_dtype, device)
        else:
            u_t = torch.from_numpy(u).to(device=device, dtype=u_dtype)
        buckets.append(BlockBucket(
            u=u_t,
            s=torch.from_numpy(s).to(device),
            inv_s=torch.from_numpy(inv_s).to(device),
            d=torch.from_numpy(d).to(device),
            perm=torch.from_numpy(perm).to(device),
            seq=torch.from_numpy(seq).to(device)))

    has_diag = any(not np.allclose(f.d, 0) for f in factors)
    rank = float(sum(f.rank for f in factors))
    return PackedLD(buckets=tuple(buckets), n=n, has_diag=has_diag,
                    rank=rank, missing=missing)


def _shard_devices(device, count):
    """One device per shard from a device or a sequence of them."""
    if isinstance(device, (list, tuple)):
        if len(device) != count:
            raise ValueError(f'{len(device)} devices for {count} shards')
        return [torch.device(d) for d in device]
    return [torch.device(device)] * count


def _span_rows(n, n_shards):
    """The slots of each of n_shards spans; raises unless they divide n
    in multiples of 128 (the JAX package's shard-local contract)."""
    rows = n // n_shards
    if n % n_shards or rows % 128:
        raise ValueError('shard-local packing needs n to divide into '
                         'n_shards spans of 128-multiple length')
    return rows


def _pack_sharded(factors, block_indices, n, dtype, u_dtype, device, spill,
                  n_shards, shards):
    """pack(n_shards > 1): each requested shard packs its own blocks in
    span coordinates on its device."""
    rows = _span_rows(n, n_shards)
    shards = list(range(n_shards)) if shards is None else list(shards)
    devices = _shard_devices(device, len(shards))
    owned = {s: ([], []) for s in shards}
    for f, ix in zip(factors, block_indices):
        ix = np.asarray(ix, dtype=np.int64)
        s = int(ix[0]) // rows
        if int(ix.min()) // rows != s or int(ix.max()) // rows != s:
            raise ValueError('an LD block straddles a shard-span boundary; '
                             'the layout planner must keep blocks whole '
                             'per shard')
        if s not in owned:
            raise ValueError(f'a block of shard {s}, which is not packed '
                             'here')
        owned[s][0].append(f)
        owned[s][1].append(ix - s * rows)
    parts = tuple(pack(owned[s][0], owned[s][1], rows, dtype=dtype,
                       u_dtype=u_dtype, device=dev, spill=spill)
                  for s, dev in zip(shards, devices))
    missing = tuple(s * rows + m for s, part in zip(shards, parts)
                    for m in part.missing)
    return PackedLD(buckets=(), n=n,
                    has_diag=any(p.has_diag for p in parts),
                    rank=float(sum(f.rank for f in factors)),
                    missing=missing, shards=parts, shard_count=n_shards,
                    first_shard=shards[0] if shards else 0)


def shard(ld, n_shards, device='cpu', shards=None):
    """An unsharded PackedLD regrouped into n_shards spans (the sharded
    form `pack(n_shards)` gives), its blocks moved to `device` (one, or
    one per shard in `shards`, all by default). Raises as pack does."""
    rows = _span_rows(ld.n, n_shards)
    shards = list(range(n_shards)) if shards is None else list(shards)
    devices = _shard_devices(device, len(shards))
    per_shard = {s: [] for s in shards}
    for bk in ld.buckets:
        perm = bk.perm.cpu()
        live = perm < ld.n
        first = torch.where(live, perm, ld.n).amin(dim=1) // rows
        last = torch.where(live, perm, -1).amax(dim=1) // rows
        if bool((first != last).any()):
            raise ValueError('an LD block straddles a shard-span boundary')
        for s in shards:
            sel = torch.nonzero(first == s)[:, 0]
            if sel.numel():
                per_shard[s].append((bk, sel))
    parts = []
    for s, dev in zip(shards, devices):
        buckets = []
        covered = np.zeros(rows, dtype=bool)
        for bk, sel in per_shard[s]:
            perm = bk.perm.cpu()[sel]
            local = torch.where(perm < ld.n, perm - s * rows, rows)
            covered[local[local < rows].numpy()] = True
            buckets.append(BlockBucket(
                u=bk.u[sel.to(bk.u.device)].to(dev),
                s=bk.s[sel.to(bk.s.device)].to(dev),
                inv_s=bk.inv_s[sel.to(bk.s.device)].to(dev),
                d=bk.d[sel.to(bk.d.device)].to(dev),
                perm=local.to(dev)))
        parts.append(PackedLD(
            buckets=tuple(buckets), n=rows,
            has_diag=any(bool((b.d != 0).any()) for b in buckets),
            rank=float(sum(int((b.s > 0).sum()) for b in buckets)),
            missing=tuple(np.flatnonzero(~covered).tolist())))
    return dataclasses.replace(ld, buckets=(), shards=tuple(parts),
                               shard_count=n_shards,
                               first_shard=shards[0] if shards else 0)


def deal_blocks(sizes, n_shards):
    """The snp shard of each block of the global-gather layout, from the
    blocks' sizes (kept rows, manifest order) alone, so that every
    process deals alike before any load: the blocks of each size tier
    (a bucket's padded size) go to the shards in contiguous runs of
    ceil(B / n_shards), as the JAX package's multi-process loader deals
    them to processes (vilma_tpu/parallel/distributed.py:356-367). A
    shard may hold no block of a tier; none is padded with zero
    blocks."""
    owners = np.zeros(len(sizes), dtype=np.int64)
    tiers = {}
    for pos, size in enumerate(sizes):
        tiers.setdefault(_pad_to_tier(int(size)), []).append(pos)
    for positions in tiers.values():
        per = -(-len(positions) // n_shards)
        for k, pos in enumerate(positions):
            owners[pos] = k // per
    return owners


def pack_gathered(factors, block_indices, owners, n, n_shards, comm,
                  dtype=torch.float64, u_dtype=None, device='cpu',
                  spill=None, shards=None, seq_starts=None):
    """A PackedLD in the global-gather layout (module docstring): block b
    (factors[b], its genome indices block_indices[b] in [0, n)) on shard
    owners[b] (`deal_blocks`), each of the listed `shards` (all n_shards
    by default; one entry per local shard of `comm`, a snp index
    repeating across comp rows) packing its own blocks in global
    coordinates on its device (`device`: one, or one per listed shard).
    Blocks of shards not listed may be left out. n splits into n_shards
    spans of n / n_shards slots, any length. seq_starts[b] is block b's
    offset in the whole matrix's sequential order (pack's seq map), so
    that matrix_power, per shard, is the unsharded matrix's."""
    if n % n_shards:
        raise ValueError(f'the gathered layout needs n ({n}) to divide '
                         f'into {n_shards} spans')
    shards = list(range(n_shards)) if shards is None else list(shards)
    devices = _shard_devices(device, len(shards))
    parts = []
    for s, dev in zip(shards, devices):
        own = [b for b, o in enumerate(owners) if o == s]
        part = pack([factors[b] for b in own],
                    [block_indices[b] for b in own], n, dtype=dtype,
                    u_dtype=u_dtype, device=dev, spill=spill,
                    seq_starts=(None if seq_starts is None else
                                [seq_starts[b] for b in own]))
        parts.append(dataclasses.replace(part, layout='gather', comm=comm))
    covered = (np.concatenate([np.asarray(ix) for ix in block_indices])
               if len(block_indices) else np.array([], dtype=np.int64))
    missing = np.ones(n, dtype=bool)
    missing[covered] = False
    return PackedLD(buckets=(), n=n,
                    has_diag=any(p.has_diag for p in parts),
                    rank=float(sum(f.rank for f in factors)),
                    missing=tuple(np.flatnonzero(missing).tolist()),
                    shards=tuple(parts), shard_count=n_shards,
                    first_shard=shards[0] if shards else 0,
                    layout='gather', comm=comm)


def split(ld, x):
    """The last axis of x (all n layout slots) as one tensor per shard of
    a sharded PackedLD, each on its shard's device."""
    rows = ld.shard_rows
    return tuple(
        x[..., (ld.first_shard + j) * rows:(ld.first_shard + j + 1) * rows]
        .to(part.device).contiguous() for j, part in enumerate(ld.shards))


def over_shards(op, parts, *args):
    """`op` (dot, dot_multi, inverse_dot, ridge_inverse_dot, diag) of the
    matrix whose local shards are `parts`, with one entry per shard in
    each of `args`; one result per shard. Shard-local parts (and an
    unsharded matrix, the one-shard case) act alone. Gathered parts act
    through their lines: each tensor argument is gathered over the line
    into the full [.., n] vector (comm.snp_gather), every shard runs `op`
    on its own blocks at full length, and the line's partial results are
    added and cut to each shard's span (comm.snp_sum_span)."""
    if parts[0].layout != 'gather':
        return tuple(op(part, *a) for part, *a in zip(parts, *args))
    comm = parts[0].comm
    full = [comm.snp_gather(a) if torch.is_tensor(a[0]) and a[0].dim()
            else a for a in args]
    return tuple(comm.snp_sum_span([op(part, *a)
                                    for part, *a in zip(parts, *full)]))


def _check_length(ld, x):
    """A shard's op at full length only: a gathered shard given its span
    (or any matrix a vector of another length) raises."""
    if x.shape[-1] != ld.n:
        raise ValueError(f'a vector of {x.shape[-1]} slots for a matrix '
                         f'of {ld.n}')


def from_dense_blocks(blocks, block_indices, n, t=1.0,
                      dtype=torch.float64, device='cpu'):
    """Factor dense symmetric blocks on the host, then pack them."""
    factors = [lowrank.factor_block(X=b, t=t) for b in blocks]
    return pack(factors, block_indices, n, dtype=dtype, device=device)


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
    cohort. On a sharded matrix `vectors` holds one [C, span] tensor per
    shard, and so does the result (`over_shards`)."""
    if ld.shards:
        return over_shards(dot_multi, ld.shards, vectors)
    _check_length(ld, vectors)
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
    """Matrix @ vector (reference matrix_structures.py:389-408); on a
    sharded matrix one span per shard (`over_shards`)."""
    if ld.shards:
        return over_shards(dot, ld.shards, vector)
    return dot_multi(ld, vector[None, :])[0]


def inverse_dot(ld, vector):
    """PseudoInverse(Matrix) @ vector (reference matrix_structures.py:
    159-196). Schema-loaded LD always has d == 0, the batched
    u @ (inv_s * (u.T @ v)) branch; blocks with a nonzero diagonal take
    the reference's host-side per-block branches. On a sharded matrix
    one span per shard (`over_shards`)."""
    if ld.shards:
        return over_shards(inverse_dot, ld.shards, vector)
    _check_length(ld, vector)
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
    reference's diag(inv_s)). regularizer > 0 keeps it well-posed. On a
    sharded matrix one span per shard (`over_shards`), a per-SNP
    regularizer too."""
    if ld.shards:
        regs = (regularizer if isinstance(regularizer, (list, tuple))
                else [regularizer] * len(ld.shards))
        return over_shards(ridge_inverse_dot, ld.shards, vector, regs)
    _check_length(ld, vector)
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


# diag forms its [B, P, R] temporaries at most this many elements at a
# time (at 6M SNPs the whole bucket's took ~37 GB of device memory)
_DIAG_CHUNK_ELEMS = 2 ** 27


def _block_diags(bk):
    """Each block's diagonal [B, P]: the sum over the rank of s u**2 by a
    fixed pairwise tree of elementwise adds (zero-padded to a power of
    two), plus d; in block chunks, which give the same bits at any chunk
    size."""
    B, P, R = bk.u.shape
    chunk = max(1, _DIAG_CHUNK_ELEMS // (P * R))
    width = 1 << max(R - 1, 0).bit_length()
    out = []
    for b0 in range(0, max(B, 1), chunk):        # a bucket of 0 blocks too
        u = bk.u[b0:b0 + chunk].to(bk.s.dtype)
        terms = (u * u) * bk.s[b0:b0 + chunk, None, :]      # [C, P, R]
        if width > R:
            terms = torch.nn.functional.pad(terms, (0, width - R))
        while terms.shape[-1] > 1:
            half = terms.shape[-1] // 2
            terms = terms[..., :half] + terms[..., half:]
        out.append(terms[..., 0] + bk.d[b0:b0 + chunk])
    return out[0] if len(out) == 1 else torch.cat(out)


def diag(ld):
    """Diagonal of the matrix (reference matrix_structures.py:426-440).
    The sum over the rank is a fixed pairwise tree of elementwise adds,
    so every device gives the same bits (`_block_diags`). On a sharded
    matrix one span per shard (`over_shards`)."""
    if ld.shards:
        return over_shards(diag, ld.shards)
    parts = []
    dtype = torch.float64
    for bk in ld.buckets:
        parts.append((bk.perm, _block_diags(bk)))
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
    depends on this). A sharded matrix powers each shard's blocks: a
    gathered one's carry the whole matrix's sequential offsets
    (pack_gathered), a shard-local one's those of their own span."""
    if ld.has_diag:
        raise NotImplementedError('Matrix powers where the diagonal '
                                  'approximation is not zero have '
                                  'not yet been implemented.')
    if ld.shards:
        return dataclasses.replace(ld, shards=tuple(
            matrix_power(part, power) for part in ld.shards))
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
    rank) host work. On a sharded matrix `vector` has all n slots, and
    i must lie in a block of this process's shards."""
    i = int(i)
    if i in set(ld.missing):
        return 0.
    if ld.shards:
        rows = ld.shard_rows
        for j, part in enumerate(ld.shards):
            if ld.layout == 'gather':
                if any(bool((bk.perm == i).any()) for bk in part.buckets):
                    return dot_i(part, vector, i)
            elif (ld.first_shard + j) == i // rows:
                lo = i // rows * rows
                return dot_i(part, vector[lo:lo + rows], i - lo)
        raise IndexError(f'index {i} lies in no block of this process\'s '
                         'shards')
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
