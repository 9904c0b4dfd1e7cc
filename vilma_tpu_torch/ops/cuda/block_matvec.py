"""Fused low-rank block matvec: wrapper of the CUDA kernels in
csrc/block_matvec.cu, with its plain PyTorch version and the planner
that picks the kernel's route.

Replaces vilma_tpu/ops/pallas/block_matvec.py::bucket_matvec_multi
(the Pallas TPU kernel `_kernel`):

    y[b, c] = U_b (s_b * (U_b^T x[b, c])) + d_b * x[b, c]

for B padded [Pmax, Rmax] LD blocks and C cohorts sharing the panel.
x and t are rounded to U's dtype before each contraction and the sums
accumulate in f32 (the semantics of block_matvec.py:52-61 and
blocks.py:480-490).

Two routes, chosen by the bucket's shape alone (`plan`):

* cluster: a thread-block cluster of G CTAs holds one block in its
  shared memory, P/G rows each, and reads U from device memory once;
  as many clusters as the card holds walk the blocks;
* two_read: one CTA per block reads U twice, for blocks whose slices
  would not fit a 16-CTA cluster.

On a CUDA tensor the wrapper launches the kernel of the planned route or
raises (also when the card cannot place the planned cluster); on a CPU
tensor it runs `bucket_matvec_multi_plain`. There is no fallback.
"""
import ctypes
from dataclasses import dataclass

import torch

from vilma_tpu_torch.ops.cuda import build

#: launches of the cluster route and of the two-read route (plain-version
#: calls do not count)
launches = 0
launches_two_read = 0

# dynamic shared memory one CTA may use on Hopper (232,448 bytes)
_SMEM_MAX = 227 * 1024
# cluster sizes the route takes; 16 is non-portable on the H100
_CLUSTERS = (1, 2, 4, 8, 16)
# the widest rank the cluster route takes: a bf16 ring holds at most 32
# column blocks of 64, two blocks' worth at R = 1024; f32 U lands in row
# copies
_MAX_RANK = {2: 1024, 4: 2048}
_MAX_SLOTS = 32


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one bucket shape."""
    route: str      # 'cluster' or 'two_read'
    cluster: int    # CTAs per LD block (1 on the two-read route)
    slots: int      # column-block slots of a CTA's ring (bf16; else 1)
    smem: int       # dynamic shared memory per CTA, bytes


def cluster_smem(P, R, C, itemsize, G, slots=1):
    """Dynamic shared memory of one CTA of the cluster route
    (csrc/block_matvec.cu::cluster_layout): the mbarriers; U (bf16: a ring
    of `slots` swizzled column-block slots of rows16 rows of 128 bytes;
    f32: rows16 rows at a pitch of r16 * 4 + 16 bytes); two buffers of
    x [C, rows16], d [rows16] and s [r16]; the partial t [2, C, r16] f32,
    the rounded t [C, r16 + 16 / itemsize], y [C, rows16], with f32 U the 8
    warps' partials [8, C, min(r16, 512)], and 1024 bytes to align the
    base. rows16 and r16 are P / G and R rounded up to 16."""
    rows16 = -(-(P // G) // 16) * 16
    r16 = -(-R // 16) * 16
    if itemsize == 2:
        ubytes = slots * rows16 * 128
    else:
        ubytes = rows16 * (r16 * itemsize + 16)
    smem = (-(-(_MAX_SLOTS + 2) * 8 // 1024) * 1024 + ubytes
            + 2 * 4 * ((C + 1) * rows16 + r16)
            + 8 * C * r16 + C * (itemsize * r16 + 16) + 4 * C * rows16
            + 1024)
    if itemsize == 4:
        smem += 4 * 8 * C * min(r16, 512)
    return smem


def _ring_slots(P, R, C, G):
    """Column-block slots a bf16 CTA's ring gets: up to two blocks' worth,
    as many as fit shared memory (0: not even one block's)."""
    ncb = -(-R // 64)
    slot = -(-(P // G) // 16) * 16 * 128
    room = (_SMEM_MAX - cluster_smem(P, R, C, 2, G, 0)) // slot
    slots = min(2 * ncb, _MAX_SLOTS, room)
    return slots if slots >= ncb else 0


def plan(P, R, itemsize, C):
    """The route for a [P, R] bucket of U with `itemsize`-byte elements
    and C cohorts: the smallest cluster (at least 16 rows per CTA, at
    most 256 for bf16) whose CTAs hold a block's slice in shared memory,
    else the two-read route. bf16 CTAs keep their slices in a ring of
    column-block slots, as many as fit up to two blocks' worth, so the
    next block's first column blocks load while one is worked on.
    csrc/block_matvec.cu::cluster_shape_ok holds the same rules and
    refuses a plan whose shared memory differs from its layout's."""
    for G in _CLUSTERS:
        # bf16 slices land as single tensor copies of at most 256 rows
        if not (P % G == 0 and (P // G) % 16 == 0 and R % 8 == 0
                and R <= _MAX_RANK[itemsize]
                and (itemsize == 4 or P // G <= 256)):
            continue
        slots = _ring_slots(P, R, C, G) if itemsize == 2 else 1
        smem = cluster_smem(P, R, C, itemsize, G, slots)
        if slots and smem <= _SMEM_MAX:
            return Plan('cluster', G, slots, smem)
    return Plan('two_read', 1, 1, 4 * C * R)


def bucket_matvec_multi_plain(u, s, d, x):
    """Plain PyTorch version: u [B, P, R]; s [B, R]; d [B, P];
    x [B, C, P] -> [B, C, P].

    With bf16 u the contractions run on bf16-ROUNDED operands upcast to
    f32: a CPU bf16 matmul would return bf16 and round every sum."""
    if u.dtype == torch.bfloat16:
        uf = u.float()
        xr = x.to(torch.bfloat16).float()
        t = torch.einsum('bpr,bcp->bcr', uf, xr) * s[:, None, :]
        tr = t.to(torch.bfloat16).float()
        y = torch.einsum('bpr,bcr->bcp', uf, tr)
        return y.to(x.dtype) + d[:, None, :] * x
    u = u.to(x.dtype)       # JAX promotes an f32 u against f64 vectors
    t = torch.einsum('bpr,bcp->bcr', u, x) * s[:, None, :]
    return torch.einsum('bpr,bcr->bcp', u, t) + d[:, None, :] * x


def _require(cond, msg):
    if not cond:
        raise ValueError('bucket_matvec_multi: ' + msg)


# (device, P, R, C, bf16, plan) -> clusters the card holds at once
_placeable = {}


def _clusters(lib, device, P, R, C, bf16, pl):
    """How many clusters of plan `pl` the card holds at once; raises if
    it cannot place one."""
    key = (device, P, R, C, bf16, pl)
    if key not in _placeable:
        count = ctypes.c_int(0)
        build.check(lib.vilma_block_matvec_cluster_fit(
            P, R, C, bf16, pl.cluster, pl.slots, pl.smem,
            ctypes.byref(count)), 'vilma_block_matvec_cluster_fit')
        _placeable[key] = count.value
    if _placeable[key] < 1:
        raise RuntimeError(
            f'bucket_matvec_multi: {device} cannot place a cluster of '
            f'{pl.cluster} CTAs with {pl.smem} bytes of shared memory each '
            f'(a [{P}, {R}] block)')
    return _placeable[key]


def bucket_matvec_multi(u, s, d, x):
    """y[b, c] = u[b] @ (s[b] * (u[b].T @ x[b, c])) + d[b] * x[b, c]."""
    if not x.is_cuda:
        return bucket_matvec_multi_plain(u, s, d, x)
    global launches, launches_two_read
    B, P, R = u.shape
    C = x.shape[1] if x.dim() == 3 else -1
    _require(u.dtype in (torch.float32, torch.bfloat16),
             f'u must be float32 or bfloat16 on CUDA, got {u.dtype}')
    for name, t, shape in (('s', s, (B, R)), ('d', d, (B, P)),
                           ('x', x, (B, C, P))):
        _require(t.dtype == torch.float32,
                 f'{name} must be float32, got {t.dtype}')
        _require(tuple(t.shape) == shape,
                 f'{name} has shape {tuple(t.shape)}, expected {shape}')
    for name, t in (('u', u), ('s', s), ('d', d), ('x', x)):
        _require(t.is_cuda and t.device == x.device,
                 f'{name} must be on {x.device}')
        _require(t.is_contiguous(), f'{name} must be contiguous')
    _require(1 <= C <= 3, f'C = {C} cohorts per panel (kernel takes 1..3)')
    vec = 16 // u.element_size()
    _require(R % vec == 0 and u.data_ptr() % 16 == 0,
             f'rank axis {R} must be a multiple of {vec} and u 16-byte '
             'aligned (16-byte row loads)')
    pl = plan(P, R, u.element_size(), C)
    _require(pl.smem <= _SMEM_MAX,
             f'C * R = {C * R} floats exceed the shared-memory budget')
    y = torch.empty_like(x)
    if B == 0:
        return y
    lib = build.library()
    bf16 = int(u.dtype == torch.bfloat16)
    stream = build.stream_handle(x.device)
    if pl.route == 'cluster':
        nclusters = min(B, _clusters(lib, x.device, P, R, C, bf16, pl))
        build.check(lib.vilma_block_matvec_cluster(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), B, P, R, C, bf16, pl.cluster, pl.slots, nclusters,
            pl.smem, stream), 'vilma_block_matvec_cluster')
        launches += 1
    else:
        build.check(lib.vilma_block_matvec(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), B, P, R, C, bf16, stream), 'vilma_block_matvec')
        launches_two_read += 1
    return y
