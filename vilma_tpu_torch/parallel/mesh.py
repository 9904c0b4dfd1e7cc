"""The mesh of a sharded fit (port of vilma_tpu/parallel/mesh.py).

A fit sharded over N snp shards splits every [*, I] array and every LD
matrix along the shard-local layout's N equal spans
(parallel/alignment.py). Each shard holds its spans, its blocks and
copies of the small tables on one torch device, and every kernel of an
objective evaluation runs per shard on its own operands. What crosses
shards is only what the JAX package psums or XLA reduces over the SNP
axis: the objective's [P] likelihood sums and beta-KL scalar, the [A, K]
annotation sums, the error-scaling EM's [P] statistics, the convergence
statistics and the precompute's global sums (engine.py). `Mesh.sum` and
`Mesh.max` make those reductions: the shards of this process are added
on its first device, then `torch.distributed.all_reduce` joins the
processes (gloo on the host, NCCL on the card). The output gathers
(`Mesh.gather`) collect every span in shard order.

A process owns a contiguous run of n_snp / world shards (the counterpart
of the JAX package's process_contiguous_devices), one card each by
default. A device list places shards explicitly (co-located shards on
one card in chip_smoke.py, the host in the tests); the CLI has no flag
for it. Component sharding (--mesh comp=N) is not ported.
"""
import dataclasses

import torch

from vilma_tpu_torch.inference import engine
from vilma_tpu_torch.models.sigma import SigmaSummaries
from vilma_tpu_torch.ops import blocks


class Mesh:
    """The snp shards of this process and the reductions across all of
    them. devices[j] holds global shard first_shard + j."""

    def __init__(self, n_snp, devices, rank=0, world=1):
        self.n_snp = int(n_snp)
        self.devices = tuple(torch.device(d) for d in devices)
        self.rank = int(rank)
        self.world = int(world)
        if len(self.devices) * self.world != self.n_snp:
            raise ValueError(f'{len(self.devices)} shards in each of '
                             f'{self.world} processes do not make '
                             f'snp={self.n_snp}')
        self.first_shard = self.rank * len(self.devices)

    @property
    def device(self):
        """Where this process's reductions land: its first shard's."""
        return self.devices[0]

    @property
    def local_shards(self):
        return range(self.first_shard, self.first_shard + len(self.devices))

    def _all_reduce(self, x, op):
        """x reduced by `op` ('SUM', 'MAX') across the processes."""
        if self.world > 1:
            import torch.distributed as dist
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op))
        return x

    def sum(self, parts):
        """The sum of one tensor per local shard, across every process,
        on `device`. The local shards add in shard order."""
        out = parts[0].to(self.device, copy=True)
        for p in parts[1:]:
            out = out + p.to(self.device)
        return self._all_reduce(out, 'SUM')

    def max(self, parts):
        """The elementwise max of one tensor per local shard, across every
        process, on `device`."""
        out = parts[0].to(self.device, copy=True)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(self.device))
        return self._all_reduce(out, 'MAX')

    def join(self, x):
        """Add each process's x (zeros where it has nothing) so that
        every process holds the whole: an output chunk whose columns the
        processes fill in turn. Exact, as each entry has one writer."""
        return self._all_reduce(x, 'SUM')

    def gather(self, parts):
        """The last axes of one tensor per local shard concatenated over
        every shard of every process, in shard order, on `device`."""
        local = torch.cat([p.to(self.device) for p in parts], dim=-1)
        if self.world == 1:
            return local
        import torch.distributed as dist
        local = local.contiguous()
        outs = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(outs, local)
        return torch.cat(outs, dim=-1)

    def split(self, x):
        """The local shards' spans of the last axis of x (all n_snp
        spans), each on its shard's device."""
        rows = x.shape[-1] // self.n_snp
        return tuple(x[..., s * rows:(s + 1) * rows].to(dev).contiguous()
                     for s, dev in zip(self.local_shards, self.devices))

    def replicate(self, x):
        """x on every local shard's device."""
        return tuple(x.to(dev) for dev in self.devices)


def make_mesh(n_snp=None, n_comp=1, devices=None, device='cuda'):
    """The mesh of `n_snp` shards over the processes of the default
    process group (one without it). Each process owns n_snp / world
    shards: by default one card each (`device` 'cuda'; the processes of a
    host take its cards in rank order; raising when too few cards are
    present, never wrapping shards round the cards it finds) or the host
    ('cpu'). `devices` places this process's
    shards explicitly (one entry per shard; for tests and
    chip_smoke.py). n_comp > 1 raises: component sharding is not
    ported."""
    if n_comp > 1:
        raise NotImplementedError(
            '--mesh comp=N is not ported yet (ROADMAP.md queue 1, '
            '"Component sharding")')
    import torch.distributed as dist
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_snp is None:
        n_snp = world * (len(devices) if devices is not None else
                         torch.cuda.device_count()
                         if torch.device(device).type == 'cuda' else 1)
    n_snp = int(n_snp)
    if n_snp < 1 or n_snp % world:
        raise ValueError(f'--mesh snp={n_snp} must be a positive multiple '
                         f'of the process count ({world})')
    per_process = n_snp // world
    if devices is None:
        if torch.device(device).type == 'cuda':
            count = torch.cuda.device_count()
            first = rank * per_process % count if count else 0
            if first + per_process > count:
                raise RuntimeError(
                    f'--mesh snp={n_snp} needs {per_process} CUDA devices '
                    f'for each of {world} process(es), one per shard; '
                    f'{count} present')
            devices = [torch.device('cuda', first + j)
                       for j in range(per_process)]
        else:
            devices = [torch.device('cpu')] * per_process
    elif len(devices) != per_process:
        raise ValueError(f'{len(devices)} devices for the {per_process} '
                         'shards of this process')
    devices = [torch.device(d) for d in devices]
    if world > 1 and devices[0].type == 'cuda':
        # NCCL's collectives and all_gather_object run on the current card
        torch.cuda.set_device(devices[0])
    return Mesh(n_snp, devices, rank, world)


# the [*, I] fields of each dataclass, split along the spans (the layout
# the JAX package's _specs gives, without comp); the others are copied
_SNP_FIELDS = {
    'ModelData': ('marginal_effects', 'std_errs', 'scalings', 'ld_diags',
                  'scaled_ld_diags', 'adj_marginal_effects',
                  'inverse_betas', 'annotations'),
    'VIState': ('nat_mu', 'nat_hist', 'vi_mu', 'vi_delta',
                'nat_grad_vi_delta'),
    'SigmaSummaries': tuple(f.name for f in
                            dataclasses.fields(SigmaSummaries)),
}


def _place(obj, mesh):
    """One copy of a dataclass per local shard: its [*, I] fields split,
    nested summaries placed alike, other tensors copied, the rest
    shared."""
    snp = _SNP_FIELDS[type(obj).__name__]
    per_shard = [{} for _ in mesh.devices]
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, SigmaSummaries):
            parts = _place(val, mesh)
        elif torch.is_tensor(val):
            parts = (mesh.split(val) if f.name in snp
                     else mesh.replicate(val))
        else:
            parts = [val] * len(mesh.devices)
        for d, p in zip(per_shard, parts):
            d[f.name] = p
    return [dataclasses.replace(obj, **d) for d in per_shard]


def shard_data(data, mesh):
    """An unsharded ModelData on the mesh: its [*, I] arrays split along
    the spans onto the shards' devices, its LD matrices regrouped by span
    (blocks.shard, raising if a block straddles one), the small tables
    and the global sums (chi_stat, ld_ranks, annotation_counts) copied to
    each. Returns an engine.ShardedData."""
    lds = [blocks.shard(ld, mesh.n_snp, mesh.devices, mesh.local_shards)
           for ld in data.ld]
    parts = _place(dataclasses.replace(data, ld=()), mesh)
    return engine.ShardedData(
        shards=tuple(dataclasses.replace(p, ld=tuple(ld.shards[j]
                                                     for ld in lds))
                     for j, p in enumerate(parts)),
        mesh=mesh)


def shard_state(state, mesh):
    """An unsharded VIState on the mesh: per-SNP fields split, the small
    ones copied, host scalars shared. Returns an engine.ShardedState."""
    return engine.ShardedState(tuple(_place(state, mesh)))

