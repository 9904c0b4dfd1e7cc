"""The shard-local genome layout (port of vilma_tpu/parallel/alignment.py,
numpy; the port keeps its own copy).

A sharded fit splits the SNP axis into N equal spans, one per shard, and
every LD block of every cohort must lie inside one span: then each
shard's matvec reads and writes only its own span, and no per-SNP data
crosses shards. The planner:

  * segments the genome at the union of all cohorts' block boundaries,
    so every cohort's block is a whole number of segments;
  * pads each segment up to a multiple of 128 layout slots (inert pads:
    zero eigenvector rows, beta 0 / SE 1 and an all-zero annotation row
    in the per-SNP arrays), as the JAX package does;
  * with n_shards > 1, assigns block-connected components whole to
    shards in genome order and pads every shard to the longest span.

Numerics are preserved: the eigendecompositions are untouched, the
inserted rows are zero, and the original variant order is restored at
output time through the layout map (MultiPopVI's out_index). Extract
files in any order plan through a virtual genome order merged from the
cohorts' manifests; only schemas that disagree on the order of shared
variants fail to plan (ok=False).
"""
import heapq

import numpy as np
import torch

from vilma_tpu_torch.ops import blocks as blocks_mod
from vilma_tpu_torch.ops import lowrank


def _block_list(ld):
    """Per-block (kept_indices, bucket_idx, block_idx) of an unsharded
    PackedLD in manifest order (by the packed `seq` offsets). Reads only
    the perm and seq maps, never the factors."""
    out = []
    for bi, bk in enumerate(ld.buckets):
        perm = bk.perm.cpu().numpy()
        seq = bk.seq.cpu().numpy()
        for b in range(perm.shape[0]):
            keep = perm[b] < ld.n
            ix = perm[b][keep]
            if ix.size == 0:
                continue
            out.append((int(seq[b][keep][0]), ix.copy(), bi, b))
    out.sort(key=lambda t: t[0])
    return [(ix, bi, b) for _, ix, bi, b in out]


def _block_intervals(ld):
    """Per-block (start, stop, kept_indices, bucket_idx, block_idx),
    sorted by start, or None when the blocks' [min, max+1) intervals
    interleave or a block's indices do not ascend (an extract file not in
    genome order: `compute_layout` then plans through the virtual
    order). Blocks may have holes (variants of the window this cohort
    dropped)."""
    out = []
    for ix, bi, b in _block_list(ld):
        if ix.size > 1 and not np.all(np.diff(ix) > 0):
            return None
        out.append((int(ix[0]), int(ix[-1]) + 1, ix, bi, b))
    out.sort(key=lambda t: t[0])
    for (a0, b0, _, _, _), (a1, _, _, _, _) in zip(out, out[1:]):
        if a1 < b0:
            return None
    return out


def topological_merge(chains, n):
    """Merge per-cohort total orders into one virtual genome order.

    chains: one sequence of variant indices per cohort, its covered
    variants in manifest order. Returns vpos [n] (variant -> virtual
    position), or None when the chains conflict (a cycle: no order
    satisfies every schema). Variants in no chain slot in smallest index
    first; after each emission the successors it unlocks run depth-first,
    so chains come out as contiguous runs."""
    pairs = []
    for ch in chains:
        ch = np.asarray(ch, dtype=np.int64)
        if ch.size > 1:
            pairs.append(np.stack([ch[:-1], ch[1:]], axis=1))
    if pairs:
        # cohorts sharing a schema add the same edges: count them once
        edges = np.unique(np.concatenate(pairs, axis=0), axis=0)
    else:
        edges = np.empty((0, 2), dtype=np.int64)
    indeg = np.zeros(n, dtype=np.int64)
    np.add.at(indeg, edges[:, 1], 1)
    se = edges[np.argsort(edges[:, 0], kind='stable')]
    starts = np.searchsorted(se[:, 0], np.arange(n + 1))
    succ = se[:, 1]
    heap = np.flatnonzero(indeg == 0).tolist()
    heapq.heapify(heap)
    vpos = np.full(n, -1, dtype=np.int64)
    pos = 0
    run = []
    while run or heap:
        v = run.pop() if run else heapq.heappop(heap)
        vpos[v] = pos
        pos += 1
        unlocked = []
        for e in range(starts[v], starts[v + 1]):
            w = int(succ[e])
            indeg[w] -= 1
            if indeg[w] == 0:
                unlocked.append(w)
        if unlocked:
            unlocked.sort(reverse=True)
            run.extend(unlocked)
    if pos != n:
        return None
    return vpos


def _block_factor(ld, bucket_idx, block_idx, num_rows):
    """One block's factor, read from its bucket one block at a time (a
    spilled bucket never comes into memory whole)."""
    bk = ld.buckets[bucket_idx]
    dtype = bk.s.dtype
    u = bk.u[block_idx].to(dtype).cpu().numpy()
    s = bk.s[block_idx].cpu().numpy()
    d = bk.d[block_idx].cpu().numpy()
    r = max(int(np.sum(np.abs(u).sum(axis=0) > 0)), 1)
    return lowrank.LowRankFactor(
        u=np.ascontiguousarray(u[:num_rows, :r]),
        s=s[:r].copy(), d=d[:num_rows].copy(),
        rank=int(np.sum(s[:r] > 0)) if s[:r].size else 0)


def _seg_pad(a, b):
    return int(-(-(b - a) // 128) * 128)


def entry_intervals(entries):
    """[(start, stop)] of metadata-pass entries
    (io/load.matched_schema_entries dicts), or None where
    `_block_intervals` would give None (callers then plan through
    `layout_via_virtual_order`)."""
    out = []
    for e in entries:
        ix = np.asarray(e['idx'])
        if ix.size == 0:
            continue
        if ix.size > 1 and not np.all(np.diff(ix) > 0):
            return None
        out.append((int(ix[0]), int(ix[-1]) + 1))
    out.sort()
    for (a0, b0), (a1, _) in zip(out, out[1:]):
        if a1 < b0:
            return None
    return out


def layout_via_virtual_order(block_ix_lists, n, n_shards=1):
    """The genome -> layout map for any variant ordering.

    block_ix_lists: one list per cohort of each block's kept variant
    indices, blocks in manifest order. The cohorts' manifest orders merge
    into a virtual genome order (`topological_merge`), in which every
    block is an ascending interval; the interval planner lays those out
    and the two maps compose. Returns (layout_map [n] int32, L, ok);
    ok is False only when the schemas conflict."""
    chains = []
    for blocks_ix in block_ix_lists:
        if blocks_ix:
            chains.append(np.concatenate(
                [np.asarray(ix, dtype=np.int64) for ix in blocks_ix]))
        else:
            chains.append(np.empty(0, dtype=np.int64))
    vpos = topological_merge(chains, n)
    if vpos is None:
        return None, None, False
    interval_lists = []
    for blocks_ix in block_ix_lists:
        ivals = []
        for ix in blocks_ix:
            vix = vpos[np.asarray(ix)]
            ivals.append((int(vix[0]), int(vix[-1]) + 1))
        ivals.sort()
        interval_lists.append(ivals)
    layout_v, L, ok = compute_layout_from_intervals(interval_lists, n,
                                                    n_shards=n_shards)
    if not ok:
        return None, None, False
    return layout_v[vpos].astype(np.int32), L, True


def block_span(layout_map, ix):
    """(span_start, span_len, rel) of a block's layout span: its kept
    indices `ix` land at layout_map[ix]; the span is the 128-padded range
    from the first of them, and `rel` are their offsets in it. Shared by
    `relayout_ld` and the multi-process loader, so both pack alike."""
    new_ix = np.asarray(layout_map)[np.asarray(ix)]
    span_start = int(new_ix[0])
    span_len = int(new_ix[-1]) + 1 - span_start
    span_len = int(-(-span_len // 128) * 128)
    return span_start, span_len, new_ix - span_start


def compute_layout(lds, n, n_shards=1):
    """The genome -> layout map of loaded (unsharded) PackedLDs: from the
    block intervals, or through the virtual order where they interleave.
    Returns (layout_map [n] int32, L, ok)."""
    interval_lists = []
    for ld in lds:
        ranges = _block_intervals(ld)
        if ranges is None:
            interval_lists = None
            break
        interval_lists.append([(a, b) for a, b, _, _, _ in ranges])
    if interval_lists is not None:
        return compute_layout_from_intervals(interval_lists, n,
                                             n_shards=n_shards)
    block_ix_lists = [[ix for ix, _, _ in _block_list(ld)] for ld in lds]
    return layout_via_virtual_order(block_ix_lists, n, n_shards=n_shards)


def compute_layout_from_intervals(interval_lists, n, n_shards=1):
    """The genome -> layout map from per-cohort block intervals (one list
    of (start, stop) per cohort; a metadata pass gives them, see
    `entry_intervals`). Returns (layout_map [n] int32, L, True).

    With n_shards > 1 the layout is shard-local: L splits into n_shards
    equal 128-multiple spans and no block of any cohort straddles a span
    boundary. Boundaries fall only between block-connected components
    (maximal runs of overlapping blocks over all cohorts), assigned to
    shards greedily in genome order; runs no block covers split
    anywhere; every shard pads to the longest span."""
    boundaries = {0, n}
    intervals = []
    for ranges in interval_lists:
        for a, b in ranges:
            boundaries.add(a)
            boundaries.add(b)
            intervals.append((a, b))
    cuts = np.array(sorted(boundaries), dtype=np.int64)
    segs = list(zip(cuts[:-1].tolist(), cuts[1:].tolist()))
    if n_shards <= 1:
        layout_map = np.empty(n, dtype=np.int32)
        pos = 0
        for a, b in segs:
            layout_map[a:b] = pos + np.arange(b - a)
            pos += _seg_pad(a, b)
        return layout_map, pos, True

    # block-connected components: the units a shard owns whole
    intervals.sort()
    comps = []
    cur = None
    for a, b in intervals:
        if cur is None or a >= cur[1]:
            if cur is not None:
                comps.append(tuple(cur))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        comps.append(tuple(cur))

    # units in genome order: ('atom', the segments of one component) or
    # ('gap', one uncovered segment, splittable anywhere)
    units = []
    ci = 0
    for a, b in segs:
        while ci < len(comps) and comps[ci][1] <= a:
            ci += 1
        if ci < len(comps) and comps[ci][0] <= a < comps[ci][1]:
            if units and units[-1][0] == 'atom' and units[-1][2] == ci:
                units[-1][1].append((a, b))
            else:
                units.append(('atom', [(a, b)], ci))
        else:
            units.append(('gap', [(a, b)], None))

    total = sum(_seg_pad(a, b) for a, b in segs)
    target = _seg_pad(0, -(-total // n_shards))
    shards = [[] for _ in range(n_shards)]
    fills = [0] * n_shards
    s = 0
    for kind, pieces, _ in units:
        if kind == 'atom':
            usize = sum(_seg_pad(a, b) for a, b in pieces)
            if s < n_shards - 1 and fills[s] > 0 \
                    and fills[s] + usize > target:
                s += 1
            shards[s].extend(pieces)
            fills[s] += usize
            continue
        a, b = pieces[0]
        while a < b:
            if s < n_shards - 1 and fills[s] >= target:
                s += 1
            if s == n_shards - 1:
                shards[s].append((a, b))
                fills[s] += _seg_pad(a, b)
                break
            take = min(b - a, target - fills[s])
            shards[s].append((a, a + take))
            fills[s] += _seg_pad(a, a + take)
            a += take
    shard_rows = max(max(fills), 128)
    layout_map = np.empty(n, dtype=np.int32)
    for s, pieces in enumerate(shards):
        pos = s * shard_rows
        for a, b in pieces:
            layout_map[a:b] = pos + np.arange(b - a)
            pos += _seg_pad(a, b)
    return layout_map, n_shards * shard_rows, True


def relayout_ld(ld, layout_map, L, dtype=None, spill=None, u_dtype=None,
                n_shards=1, device='cpu', shards=None):
    """Rebuild an unsharded PackedLD in layout coordinates: each block's
    kept rows scatter to their layout slots; holes and pads are zero
    rows. With n_shards > 1, or a list of the `shards` to build, the
    result is a sharded PackedLD (blocks.pack n_shards) whose shards sit
    on `device` (one device, or one per shard). `spill` (a
    blocks.FactorSpill) stages the relayouted factors and buckets on
    disk, one block in memory at a time (fit --mmap). dtype defaults to
    the eigenvalues' type and u_dtype to dtype."""
    if dtype is None:
        dtype = ld.buckets[0].s.dtype if ld.buckets else torch.float64
    factors, indices = [], []
    for ix, bucket_idx, block_idx in _block_list(ld):
        f = _block_factor(ld, bucket_idx, block_idx, ix.size)
        span_start, span_len, rel = block_span(layout_map, ix)
        u_span = np.zeros((span_len, f.u.shape[1]), dtype=f.u.dtype)
        d_span = np.zeros(span_len, dtype=f.d.dtype)
        u_span[rel] = f.u
        d_span[rel] = f.d
        factor = lowrank.LowRankFactor(u=u_span, s=f.s, d=d_span,
                                       rank=f.rank)
        if spill is not None:
            factor = spill.store(factor)
        factors.append(factor)
        indices.append(np.arange(span_start, span_start + span_len))
    return blocks_mod.pack(factors, indices, L, dtype=dtype,
                           u_dtype=u_dtype, device=device, spill=spill,
                           n_shards=n_shards, shards=shards)


def relayout_rows(arr, layout_map, L, fill=0.0):
    """Scatter [P, n] (or [n]) genome-order rows into layout order."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        out = np.full(L, fill, dtype=arr.dtype)
        out[layout_map] = arr
        return out
    out = np.full(arr.shape[:-1] + (L,), fill, dtype=arr.dtype)
    out[..., layout_map] = arr
    return out


def relayout_annotations(one_hot, layout_map, L):
    """One-hot [n, A] -> [L, A] with all-zero rows at pads (the engine's
    pad sentinel)."""
    one_hot = np.asarray(one_hot)
    out = np.zeros((L, one_hot.shape[1]), dtype=one_hot.dtype)
    out[layout_map] = one_hot
    return out
