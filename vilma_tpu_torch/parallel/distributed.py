"""Multi-process sharded fits: joining the process group and loading each
process's own LD blocks (port of vilma_tpu/parallel/distributed.py).

  1. every process runs the cheap metadata pass
     (io/load.matched_schema_entries: .var parsing and variant matching,
     no .npy payload), so all of them plan the same shard-local layout
     (`plan_sharded_load`, parallel/alignment.py);
  2. process r owns a contiguous run of shards (parallel/mesh.py) and
     factorizes only the blocks whose spans land on them (under --mesh
     comp=M, the spans of its shards' snp columns): the O(n^3)
     eigendecompositions, the load's dominant cost, are split across
     processes (`load_ld_sharded`), through the factor cache and --mmap
     where asked for;
  3. the processes agree on the matrix's rank (the sum of every block's,
     the likelihood's ld_ranks term, each span counted by the owner of
     its comp-0 shard) with one all_gather_object. Each
     shard's buckets are its own, so no bucket shape needs agreeing.
"""
import dataclasses
import logging
import os

import numpy as np
import torch

from vilma_tpu_torch.io import load as load_mod
from vilma_tpu_torch.ops import blocks as blocks_mod
from vilma_tpu_torch.ops import lowrank
from vilma_tpu_torch.parallel import alignment


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device='cuda'):
    """Join the default torch.distributed process group: NCCL when the
    fit runs on cuda, gloo on cpu (nothing else chooses the backend).
    With a coordinator (host:port) the group meets there (tcp://) with
    the given size and rank; without one it reads torchrun's environment
    (env://). Errors propagate (a swallowed failure would turn one fit
    into N independent fits that all write as process 0); only an
    already initialized group is taken as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        logging.info('torch.distributed is already initialized (%s)',
                     dist.get_backend())
        return
    backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    if coordinator_address:
        dist.init_process_group(
            backend=backend, init_method=f'tcp://{coordinator_address}',
            world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend=backend, init_method='env://')
    logging.info('process %d of %d joined the %s process group',
                 dist.get_rank(), dist.get_world_size(), backend)


class ShardedLoadPlan:
    """The shard-local layout of a multi-process fit, planned from
    metadata alone (identical on every process), and the matched schema
    entries it was planned from."""

    def __init__(self, layout_map, L, n_shards, entries_map):
        self.layout_map = np.asarray(layout_map, dtype=np.int32)
        self.L = int(L)
        self.n_shards = int(n_shards)
        self._entries = entries_map

    @staticmethod
    def key(schema_path, denylist):
        return (os.path.realpath(schema_path),
                tuple(sorted({int(i) for i in denylist})))

    def entries(self, schema_path, denylist):
        return self._entries[self.key(schema_path, denylist)]


def plan_sharded_load(specs, variants, n_shards):
    """One shard-local layout over every cohort of a multi-process fit.

    specs: [(schema_path, denylist)] in cohort order. Runs the metadata
    pass once per distinct (schema, denylist) and plans the union of the
    cohorts' block intervals (alignment.compute_layout_from_intervals),
    or, where the blocks' index ranges interleave (an extract file not in
    genome order), through the virtual genome order. Returns a
    ShardedLoadPlan, or None when the schemas conflict on the order of
    shared variants."""
    n = len(variants)
    entries_map, interval_lists = {}, []
    for schema_path, denylist in specs:
        key = ShardedLoadPlan.key(schema_path, denylist)
        if key not in entries_map:
            entries_map[key] = list(load_mod.matched_schema_entries(
                schema_path, variants, denylist))
        if interval_lists is not None:
            ivals = alignment.entry_intervals(entries_map[key])
            interval_lists = (None if ivals is None
                              else interval_lists + [ivals])
    if interval_lists is not None:
        layout_map, L, ok = alignment.compute_layout_from_intervals(
            interval_lists, n, n_shards=n_shards)
    else:
        block_ix_lists = [
            [np.asarray(e['idx'])
             for e in entries_map[ShardedLoadPlan.key(sp, dl)]
             if len(e['idx'])]
            for sp, dl in specs]
        layout_map, L, ok = alignment.layout_via_virtual_order(
            block_ix_lists, n, n_shards=n_shards)
    if not ok:
        return None
    return ShardedLoadPlan(layout_map, L, n_shards, entries_map)


def load_ld_sharded(schema_path, variants, denylist, ldthresh, mesh, plan,
                    mmap=False, dtype=torch.float64, u_dtype=None,
                    cache_dir=None, spill_dir=None):
    """Load an LD schema in the plan's layout, factorizing only the blocks
    of this process's shards (see the module docstring). Returns (a
    sharded PackedLD holding this process's shards on its devices, the
    variant positions missing LD information in the original order), as
    io/load.load_ld_from_schema does: the same matching, allele flips,
    thresholds and mmap-mode RNG draws (two per loaded block, on every
    process alike)."""
    if plan.n_shards != mesh.n_snp:
        raise ValueError(f'the plan has {plan.n_shards} shards, the mesh '
                         f'{mesh.n_snp}')
    entries = plan.entries(schema_path, denylist)
    rows = plan.L // plan.n_shards
    local = set(mesh.snp_shards)
    spill = blocks_mod.FactorSpill(spill_dir) if mmap else None
    factors, indices = [], []
    local_rank = 0.0
    covered = np.zeros(plan.L, dtype=bool)
    total_flipped = 0
    for entry in entries:
        total_flipped += entry['num_flipped']
        if mmap:
            load_mod.consume_mmap_rng_draws()
        start, length, rel = alignment.block_span(plan.layout_map,
                                                  entry['idx'])
        covered[start:start + length] = True
        if start // rows not in local:
            continue
        f = load_mod.load_entry_factor(entry, ldthresh, cache_dir=cache_dir)
        # kept rows scatter into their span; holes and pads stay zero rows
        u = np.zeros((length, f.r), dtype=f.u.dtype)
        d = np.zeros(length, dtype=f.d.dtype)
        u[rel] = f.u
        d[rel] = f.d
        factor = lowrank.LowRankFactor(u=u, s=f.s, d=d, rank=f.rank)
        if mesh.counts_span(start // rows):
            local_rank += float(f.rank)
        if spill is not None:
            factor = spill.store(factor)
        factors.append(factor)
        indices.append(np.arange(start, start + length))
    packed = blocks_mod.pack(factors, indices, plan.L, dtype=dtype,
                             u_dtype=u_dtype, device=list(mesh.devices),
                             spill=spill, n_shards=plan.n_shards,
                             shards=list(mesh.snp_shards))
    ranks = [local_rank]
    if mesh.world > 1:
        import torch.distributed as dist
        ranks = [None] * mesh.world
        dist.all_gather_object(ranks, local_rank)
    packed = dataclasses.replace(
        packed, rank=float(sum(ranks)),
        missing=tuple(np.flatnonzero(~covered).tolist()))
    kept = (np.concatenate([e['idx'] for e in entries]) if entries
            else np.array([], dtype=np.int64))
    missing_orig = sorted(set(range(len(variants))) - set(kept.tolist()))
    logging.info('process %d of %d: %d of %d LD blocks factorized here '
                 '(%d slots in %d shards)', mesh.rank, mesh.world,
                 len(factors), len(entries), plan.L, plan.n_shards)
    logging.warning('%d variants have no LD information and will be '
                    'treated as missing during optimization.',
                    len(missing_orig))
    logging.warning('Allele order flipped for %d variants while matching '
                    'LD blocks.', total_flipped)
    return packed, missing_orig
