"""Fused low-rank block matvec: wrapper of the CUDA kernels in
csrc/block_matvec.cu, with its plain PyTorch version and the planner
that picks the kernel's route.

Replaces vilma_tpu/ops/pallas/block_matvec.py::bucket_matvec_multi
(the Pallas TPU kernel `_kernel`):

    y[b, c] = U_b (s_b * (U_b^T x[b, c])) + d_b * x[b, c]

for B padded [Pmax, Rmax] LD blocks and C <= MAX_COHORTS cohorts sharing
the panel (blocks.dot_multi hands it more as several launches). The
kernels are built for the cohort counts of WIDTHS; a launch of another C
runs the next wider one, the extra rows of x zero. x and t are rounded
to U's dtype before each contraction and the sums accumulate in f32 (the
semantics of block_matvec.py:52-61 and blocks.py:480-490).

Two routes, chosen by the bucket's shape alone (`plan`):

* cluster: a thread-block cluster of G CTAs holds one block in its
  shared memory, P/G rows each, and reads U from device memory once;
  as many clusters as the card holds walk the blocks;
* group: for the blocks the cluster route does not take, a group of up
  to 128 CTAs (one cooperative launch) spreads each block's columns over
  as many SMs, so that both products are local to a CTA (its slice held
  in shared memory where two fit); the CTAs' partials of y meet through a
  workspace in device memory, one split-phase counter barrier a block.

On a CUDA tensor the wrapper launches the kernel of the planned route or
raises (also when the card cannot place the planned cluster or group);
on a CPU tensor it runs `bucket_matvec_multi_plain`. There is no
fallback.

Under autograd (a CUDA x that requires grad) the launch goes through
`BucketMatvec`: each block's operator U diag(s) U^T + diag(d) is
symmetric, so the gradient with respect to x is the same kernel launched
on the incoming gradient, the same route and plan. The LD factors are
constants: nothing differentiates them, and a u, s or d that requires
grad raises.
"""
import ctypes
import functools
from dataclasses import dataclass

import torch

from vilma_tpu_torch.ops.cuda import build

#: launches of the cluster route and of the group route, and of either
#: route by cohort count (plain-version calls do not count); the
#: backward's launches (either route) count apart, in launches_backward
launches = 0
launches_group = 0
launches_by_cohorts = {}
launches_backward = 0

#: the most cohorts one launch takes
MAX_COHORTS = 8
# the cohort counts the kernels are built for
# (csrc/block_matvec.cu::cohorts_ok)
WIDTHS = (1, 2, 3, 4, 8)

# dynamic shared memory one CTA may use on Hopper (232,448 bytes)
_SMEM_MAX = 227 * 1024
# cluster sizes the route takes; 16 is non-portable on the H100
_CLUSTERS = (1, 2, 4, 8, 16)
# the widest rank the cluster route takes: a bf16 ring holds at most 32
# column blocks of 64, two blocks' worth at R = 1024; f32 U lands in row
# copies
_MAX_RANK = {2: 1024, 4: 2048}
_MAX_SLOTS = 32
# group route: at most this many CTAs per block (a power of two the
# H100's 132 SMs hold at once)
_GROUP_MAX = 128
# warps of a group-route CTA that compute (steps 1 and 2) and that reduce
# (step 3) (csrc/block_matvec.cu kComputeWarps, kReduceWarps)
_COMPUTE_WARPS = 12
_REDUCE_WARPS = 4


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one bucket shape."""
    route: str      # 'cluster' or 'group'
    cluster: int    # CTAs per LD block
    slots: int      # cluster: column-block slots of a CTA's ring (bf16;
                    # else 1); group: slice buffers per CTA (2; 0: U read
                    # from device memory in both products)
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


def group_columns(R, itemsize, G):
    """Column groups of 16 bytes a group-route CTA owns: ceil(R / (vec G))
    rounded up to a power of two (vec = 16 / itemsize)."""
    per = -(-(R // (16 // itemsize)) // G)
    cgc = 1
    while cgc < per:
        cgc *= 2
    return cgc


def group_smem(P, R, C, itemsize, G, nbuf):
    """Dynamic shared memory of one CTA of the group route
    (csrc/block_matvec.cu::group_layout): 128 bytes to align the base and
    128 of mbarriers; `nbuf` slices of all P rows by the CTA's cgc column
    groups of 16 bytes and as many copies of the block's x [C, P] (each
    rounded up to 128 bytes); three buffers of its shares of s [cgc vec],
    d [rpc] and x [C, rpc] (rpc = ceil(P / G) rows of y; each padded to 16
    bytes); t [C, cgc vec] (padded); the compute warps' sums of step 1
    [12, cgc vec, C]; and the reduce warps' lane sums [128]."""
    vec = 16 // itemsize
    cgc = group_columns(R, itemsize, G)
    rpc = -(-P // G)
    slice_bytes = -(-P * cgc * 16 // 128) * 128
    xfull = -(-4 * C * P // 128) * 128
    vstride = -(-4 * (cgc * vec + (C + 1) * rpc) // 16) * 16
    ts = -(-4 * C * cgc * vec // 16) * 16
    red = 4 * _COMPUTE_WARPS * cgc * vec * C + 4 * 32 * _REDUCE_WARPS
    return 256 + nbuf * (slice_bytes + xfull) + 3 * vstride + ts + red


def group_size(R, itemsize):
    """CTAs per block on the group route: the largest power of two up to
    128 that leaves each CTA at least one column group of 16 bytes."""
    ncg = R // (16 // itemsize)
    G = 1
    while 2 * G <= min(_GROUP_MAX, ncg):
        G *= 2
    return G


@functools.lru_cache(maxsize=None)
def plan(P, R, itemsize, C):
    """The route for a [P, R] bucket of U with `itemsize`-byte elements
    and C cohorts: the smallest cluster (at least 16 rows per CTA, at
    most 256 for bf16) whose CTAs hold a block's slice in shared memory;
    else the group route (`group_size` CTAs per block, each owning a
    slice of U's columns: two slice buffers where they fit, else none, U
    read from device memory in both products). bf16 cluster CTAs keep
    their slices in a ring of column-block slots, as many as fit up to
    two blocks' worth, so the next block's first column blocks load while
    one is worked on. csrc/block_matvec.cu::cluster_shape_ok and
    group_shape_ok hold the same rules and refuse a plan whose shared
    memory differs from its layout's. The plan depends on the shape
    alone, not on the number of blocks, and is made once per shape."""
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
    G = group_size(R, itemsize)
    nbuf = 2 if (P % 4 == 0 and group_smem(P, R, C, itemsize, G, 2)
                 <= _SMEM_MAX) else 0
    return Plan('group', G, nbuf, group_smem(P, R, C, itemsize, G, nbuf))


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


# (device, P, R, C, bf16, plan) -> clusters (cluster route) or CTAs (group
# route) the card holds at once
_placeable = {}
# (device, stream, P, C, G, groups) -> the group route's workspace and the
# counter set its next launch uses
_workspace = {}


def _capacity(lib, device, P, R, C, bf16, pl):
    """How many clusters (cluster route) or CTAs (group route) of plan
    `pl` the card holds at once; raises if it cannot place one cluster
    or one group."""
    key = (device, P, R, C, bf16, pl)
    if key not in _placeable:
        count = ctypes.c_int(0)
        entry = ('vilma_block_matvec_cluster_fit' if pl.route == 'cluster'
                 else 'vilma_block_matvec_group_fit')
        build.check(getattr(lib, entry)(
            P, R, C, bf16, pl.cluster, pl.slots, pl.smem,
            ctypes.byref(count)), entry)
        _placeable[key] = count.value
    need = 1 if pl.route == 'cluster' else pl.cluster
    if _placeable[key] < need:
        raise RuntimeError(
            f'bucket_matvec_multi: {device} cannot place a {pl.route} of '
            f'{pl.cluster} CTAs with {pl.smem} bytes of shared memory each '
            f'(a [{P}, {R}] block)')
    return _placeable[key]


def group_count(B, held, pl):
    """Groups of a group-route launch: as many as the card holds at once
    (`held` CTAs) and there are blocks; without slices in shared memory
    one, so that the whole card works on one block at a time and the
    second product reads it from L2."""
    return 1 if pl.slots == 0 else min(B, held // pl.cluster)


def _group_workspace(device, stream, P, C, G, groups):
    """The group route's workspace, made once per (device, stream, shape)
    (launches on one stream run in order, so they may share it): per group
    four slots (blocks in flight), each a buffer of the CTAs' partials of
    y [G, C, P], then two sets of the slots' barrier counters (8 of 32
    words each). A launch counts on one set and zeroes the other for the
    next; both start at zero. Returns [workspace, set of the next
    launch]."""
    key = (device, stream, P, C, G, groups)
    if key not in _workspace:
        _workspace[key] = [
            torch.zeros(groups * 4 * (G * C * P + 2 * 8 * 32),
                        dtype=torch.float32, device=device), 0]
    return _workspace[key]


def width(C):
    """The cohort count of the kernel a launch of C cohorts runs."""
    return next(w for w in WIDTHS if w >= C)


def bucket_matvec_multi(u, s, d, x):
    """y[b, c] = u[b] @ (s[b] * (u[b].T @ x[b, c])) + d[b] * x[b, c]."""
    if not x.is_cuda:
        return bucket_matvec_multi_plain(u, s, d, x)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, s, d, x)):
        return BucketMatvec.apply(u, s, d, x)
    return _launch(u, s, d, x)


class BucketMatvec(torch.autograd.Function):
    """bucket_matvec_multi as a differentiable function of x: the
    backward is the forward's kernel on the gradient (the operator is
    symmetric per block)."""

    @staticmethod
    def forward(ctx, u, s, d, x):
        _require(not any(t.requires_grad for t in (u, s, d)),
                 'u, s and d are constants here and must not require '
                 'grad (only x is differentiated)')
        ctx.save_for_backward(u, s, d)
        return _launch(u, s, d, x)

    @staticmethod
    def backward(ctx, grad):
        u, s, d = ctx.saved_tensors
        return None, None, None, _launch(u, s, d, grad.contiguous(),
                                         backward=True)


@build.on_operands_device
def _launch(u, s, d, x, backward=False):
    """Check the operands, launch the planned route, count the launch."""
    global launches, launches_group, launches_backward
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
    _require(1 <= C <= MAX_COHORTS,
             f'C = {C} cohorts per launch (the kernel takes 1..'
             f'{MAX_COHORTS})')
    vec = 16 // u.element_size()
    _require(R % vec == 0 and u.data_ptr() % 16 == 0,
             f'rank axis {R} must be a multiple of {vec} and u 16-byte '
             'aligned (16-byte row loads)')
    W = width(C)
    pl = plan(P, R, u.element_size(), W)
    _require(pl.smem <= _SMEM_MAX,
             f'C * R = {W * R} floats exceed the shared-memory budget')
    if W != C:
        x = torch.cat([x, x.new_zeros(B, W - C, P)], dim=1)
    y = torch.empty_like(x)
    if B == 0:
        return y[:, :C]
    lib = build.library()
    bf16 = int(u.dtype == torch.bfloat16)
    stream = build.stream_handle(x.device)
    held = _capacity(lib, x.device, P, R, W, bf16, pl)
    if pl.route == 'cluster':
        build.check(lib.vilma_block_matvec_cluster(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), B, P, R, W, bf16, pl.cluster, pl.slots,
            min(B, held), pl.smem, stream), 'vilma_block_matvec_cluster')
    else:
        groups = group_count(B, held, pl)
        ws = _group_workspace(x.device, stream, P, W, pl.cluster, groups)
        build.check(lib.vilma_block_matvec_group(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), ws[0].data_ptr(), ws[1], B, P, R, W, bf16,
            pl.cluster, pl.slots, groups, pl.smem, stream),
            'vilma_block_matvec_group')
        ws[1] ^= 1
    if backward:
        launches_backward += 1
    else:
        if pl.route == 'cluster':
            launches += 1
        else:
            launches_group += 1
        launches_by_cohorts[C] = launches_by_cohorts.get(C, 0) + 1
    return y if W == C else y[:, :C]
