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
* group: for the blocks the cluster route does not take, each block's
  columns are cut into panels of about 64 KB a CTA; a cluster of up to 16
  CTAs splits a panel's rows and exchanges its t through distributed
  shared memory, and walks a block's panels in order with y kept in
  shared memory and 2-4 panels in flight by TMA. A bucket of fewer blocks
  than the card holds clusters cuts each block into panel groups
  (`group_split`), whose sums meet by ticket in a device-memory
  workspace. The route is bound by the synchronization a panel costs
  (its cluster barrier and exchanges), not by bytes (PERF.md).

On a CUDA tensor the wrapper launches the kernel of the planned route or
raises (also when the card cannot place the planned cluster);
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

#: launches of the cluster route and of the group route (the group
#: route's with bf16 U also in launches_group_bf16), and of either route
#: by cohort count (plain-version calls do not count); the backward's
#: launches (either route) count apart, in launches_backward
launches = 0
launches_group = 0
launches_group_bf16 = 0
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
# group route: the most rows of a block one CTA takes where the cluster
# (at most 16 CTAs) allows; panel widths by U's itemsize, a multiple of
# the unit up to the most (csrc/block_matvec.cu kGroupPanelBf16,
# kGroupPanelF32); the bytes of a CTA's slice of one panel (one stage of
# its ring) the planner aims at; the most stages a ring holds
_GROUP_ROWS = 256
_PANEL_UNIT = {2: 64, 4: 32}
_PANEL_MAX = {2: 512, 4: 128}
_PANEL_BYTES = 64 * 1024
_GROUP_STAGES = 4


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one bucket shape."""
    route: str      # 'cluster' or 'group'
    cluster: int    # CTAs per cluster (cluster route: per LD block;
                    # group route: the CTAs that split a panel's rows)
    slots: int      # slots of a CTA's ring (cluster route: bf16 column
                    # blocks, f32 1; group route: bf16 column blocks of 64,
                    # f32 panels)
    smem: int       # dynamic shared memory per CTA, bytes
    panel: int = 0  # group route: columns per panel (a block's columns
                    # cut into ceil(R / panel) panels)

    def panels(self, R):
        """Panels of a block of rank R (1 on the cluster route)."""
        return -(-R // self.panel) if self.route == 'group' else 1


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


def group_size(P):
    """CTAs per cluster on the group route: the fewest, a power of two up
    to 16, that leave each at most 256 of a block's P rows."""
    G = 1
    while G < 16 and -(-P // G) > _GROUP_ROWS:
        G *= 2
    return G


def group_rows(P, G):
    """(rows, rows16) of a group-route CTA: its share ceil(P / G) of a
    block's rows, and the rows of its slots: the rows its TMA boxes bring
    (ceil(rows / 256) boxes of equal rows, a multiple of 8) rounded up to
    16 (csrc/block_matvec.cu::group_layout)."""
    rows = -(-P // G)
    nbox = -(-rows // 256)
    box = -(-(-(-rows // nbox)) // 8) * 8
    return rows, -(-(nbox * box) // 16) * 16


def group_smem(P, C, itemsize, G, W, slots):
    """Dynamic shared memory of one CTA of the group route
    (csrc/block_matvec.cu::group_layout): the mbarriers and the
    last-arriver flag (1024 bytes); the ring of `slots` slots of rows16
    rows (bf16: column blocks of 64 in 128-byte rows; f32: a panel of W
    columns) and s [stages, W]; two buffers of x [C, rows16] and d
    [rows16]; the partial t [2, C, W] f32 and the cluster's partials
    pushed to it [2, G, C, W]; the warps' step-1 partials [8, C, W] (f32)
    or [C, 512] (bf16); the rounded t [C, W + 16 / itemsize] (padded to
    16 bytes); y [C, rows16]; and 1024 bytes to align the base."""
    rows16 = group_rows(P, G)[1]
    pitch, ncb = (128, W // 64) if itemsize == 2 else (4 * W, 1)
    return (1024 + slots * rows16 * pitch + 4 * (slots // ncb) * W
            + 2 * 4 * (C + 1) * rows16 + 2 * 4 * C * W * (1 + G)
            + 4 * C * (8 * W if itemsize == 4 else 512)
            + -(-itemsize * C * (W + 16 // itemsize) // 16) * 16
            + 4 * C * rows16 + 1024)


def group_panel(P, R, itemsize, G):
    """Columns per panel on the group route: the widest power of two
    times the unit (64 bf16, 32 f32) whose slice (rows16 x W) stays
    within 64 KB, up to the most (512, 128) and to the least that covers
    R; at least one unit."""
    unit, rows16 = _PANEL_UNIT[itemsize], group_rows(P, G)[1]
    W = unit
    while (2 * W <= _PANEL_MAX[itemsize] and W < R
           and rows16 * 2 * W * itemsize <= _PANEL_BYTES):
        W *= 2
    return W


@functools.lru_cache(maxsize=None)
def plan(P, R, itemsize, C):
    """The route for a [P, R] bucket of U with `itemsize`-byte elements
    and C cohorts: the smallest cluster (at least 16 rows per CTA, at
    most 256 for bf16) whose CTAs hold a block's slice in shared memory;
    else the group route: clusters of `group_size` CTAs split the rows of
    a panel of `group_panel` columns, with as many ring stages (panels in
    flight per CTA) as fit, 2 to 4 (the panel halves while not even two
    fit: step 1 of the next panel runs beside step 2 of this one). bf16
    cluster CTAs keep their slices in a ring of column-block slots, as
    many as fit up to two blocks' worth, so the next block's first column
    blocks load while one is worked on.
    csrc/block_matvec.cu::cluster_shape_ok and group_shape_ok hold the
    same rules and refuse a plan whose shared memory differs from its
    layout's. The plan depends on the shape alone, not on the number of
    blocks, and is made once per shape."""
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
    G = group_size(P)
    unit = _PANEL_UNIT[itemsize]
    W = group_panel(P, R, itemsize, G)
    while True:
        ncb = W // 64 if itemsize == 2 else 1
        for stages in range(_GROUP_STAGES, 1, -1):
            slots = stages * ncb
            smem = group_smem(P, C, itemsize, G, W, slots)
            if slots <= _MAX_SLOTS and smem <= _SMEM_MAX:
                return Plan('group', G, slots, smem, W)
        if W == unit:
            # not even two stages fit: the wrapper refuses the plan
            return Plan('group', G, 2 * ncb,
                        group_smem(P, C, itemsize, G, W, 2 * ncb), W)
        W //= 2


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


# (device, P, R, C, bf16, plan, library) -> clusters the card holds at once
_placeable = {}
# (device, stream, P, C, G, groups) -> the group route's workspace and the
# blocks it has room for
_workspace = {}


def _capacity(lib, device, P, R, C, bf16, pl):
    """How many clusters of plan `pl` the card holds at once; raises if it
    cannot place one."""
    key = (device, P, R, C, bf16, pl, id(lib))
    if key not in _placeable:
        count = ctypes.c_int(0)
        if pl.route == 'cluster':
            entry = 'vilma_block_matvec_cluster_fit'
            args = (P, R, C, bf16, pl.cluster, pl.slots, pl.smem)
        else:
            entry = 'vilma_block_matvec_group_fit'
            args = (P, R, C, bf16, pl.cluster, pl.panel, pl.slots, pl.smem)
        build.check(getattr(lib, entry)(*args, ctypes.byref(count)), entry)
        _placeable[key] = count.value
    if _placeable[key] < 1:
        raise RuntimeError(
            f'bucket_matvec_multi: {device} cannot place a {pl.route} '
            f'cluster of {pl.cluster} CTAs with {pl.smem} bytes of shared '
            f'memory each (a [{P}, {R}] block)')
    return _placeable[key]


def group_split(B, R, held, pl):
    """How a group-route launch cuts its work: (panels a work item, items
    a block, clusters). A cluster takes an item's panels in order, summing
    y in shared memory; the items of a block meet by ticket, which costs
    about a panel more an item. Of the cuts of a block into items of equal
    panels, the one with the least (rounds of `held` clusters) x (panels
    an item, plus 1 when the items meet by ticket); the fewer items on a
    tie. So a bucket of many blocks takes whole blocks, and a bucket of
    few spreads each over several clusters."""
    npanel = pl.panels(R)
    best = None
    for ppi in sorted({-(-npanel // k) for k in range(1, npanel + 1)},
                      reverse=True):
        groups = -(-npanel // ppi)
        cost = -(-B * groups // held) * (ppi + (groups > 1))
        if best is None or cost < best[0]:
            best = (cost, ppi, groups)
    _, ppi, groups = best
    return ppi, groups, min(B * groups, held)


def _group_workspace(device, stream, P, C, G, groups, B):
    """The group route's workspace, made once per (device, stream, shape)
    and grown with B (launches on one stream run in order, so they may
    share it): the tickets [B, G] (zero, and left zero by every launch),
    then the panel groups' sums of y [B, groups, C, P]. Returns
    (workspace, the blocks it has room for)."""
    key = (device, stream, P, C, G, groups)
    if key not in _workspace or _workspace[key][1] < B:
        _workspace[key] = (torch.zeros(B * G + B * groups * C * P,
                                       dtype=torch.float32, device=device), B)
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
def _launch(u, s, d, x, backward=False, lib=None):
    """Check the operands, launch the planned route, count the launch.
    lib: the kernel library (chip_smoke.py passes the measurement build,
    build.library('stamps')); the main one by default."""
    global launches, launches_group, launches_group_bf16, launches_backward
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
    lib = build.library() if lib is None else lib
    bf16 = int(u.dtype == torch.bfloat16)
    stream = build.stream_handle(x.device)
    held = _capacity(lib, x.device, P, R, W, bf16, pl)
    if pl.route == 'cluster':
        build.check(lib.vilma_block_matvec_cluster(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), B, P, R, W, bf16, pl.cluster, pl.slots,
            min(B, held), pl.smem, stream), 'vilma_block_matvec_cluster')
    else:
        ppi, groups, nclusters = group_split(B, R, held, pl)
        tickets = parts = 0
        if groups > 1:
            ws, room = _group_workspace(x.device, stream, P, W, pl.cluster,
                                        groups, B)
            tickets = ws.data_ptr()
            parts = tickets + 4 * room * pl.cluster
        build.check(lib.vilma_block_matvec_group(
            u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
            y.data_ptr(), parts, tickets, B, P, R, W, bf16, pl.cluster,
            pl.panel, pl.slots, ppi, nclusters, pl.smem, stream),
            'vilma_block_matvec_group')
    if backward:
        launches_backward += 1
    else:
        if pl.route == 'cluster':
            launches += 1
        else:
            launches_group += 1
            launches_group_bf16 += bf16
        launches_by_cohorts[C] = launches_by_cohorts.get(C, 0) + 1
    return y if W == C else y[:, :C]
