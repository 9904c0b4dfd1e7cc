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

Component sharding (--mesh comp=M, the JAX package's 'comp' axis, its
_specs layout at vilma_tpu/parallel/mesh.py:53-101) adds a second axis:
the shards form an (M, N) grid, shard (c, s) holds snp span s and the
c-th contiguous slice of the K mixture components (`k_slices`: uneven
where M does not divide K, never padded, since a pad component would
enter the softmax over K). Its K-dependent arrays (mixture_prec,
log_det, the kdim natural mean, vi_mu, vi_delta, the sigma summaries,
the columns of hyper_delta) hold the slice; the [P, I] arrays, the
shared natural mean and the epoch history are replicated over comp.
The reductions across the grid: `comp_sum`, `comp_max` and
`comp_gather` over the comp shards of one snp column (the softmax over
K), `snp_sum` over the snp shards of one comp row (the [A, K_slice]
annotation sums), `sum` over all. Across processes they run on
torch.distributed subgroups of the processes owning a column or a row.

The global-gather layout (ops/blocks.py, for LD schemas that disagree on
the order of shared variants) moves per-SNP data across the snp shards
of each comp row in every LD op: `snp_gather` joins the row's spans into
the full vector, `snp_sum_span` adds the row's full-length partial
results and keeps each shard's span. Co-located shards join on the
first shard's device in shard order (repeatable bit for bit); across
processes they run all_gather and all_reduce on the row's subgroup.
`traffic` counts the bytes each moves.

Shard (c, s) has the flat index c * N + s (the JAX package's order,
process-major and reshaped (M, N)); a process owns a contiguous run of
M * N / world flat indices, one card each by default (the counterpart
of the JAX package's process_contiguous_devices). A device list places
shards explicitly (co-located shards on one card in chip_smoke.py, the
host in the tests); the CLI has no flag for it.
"""
import dataclasses

import numpy as np
import torch

from vilma_tpu_torch.inference import engine
from vilma_tpu_torch.models.sigma import SigmaSummaries
from vilma_tpu_torch.ops import blocks


def k_slices(K, n_comp):
    """The [k0, k1) slice of the K components held by each comp index:
    contiguous, the first K % n_comp one longer. K < n_comp raises."""
    if K < n_comp:
        raise ValueError(f'--mesh comp={n_comp} needs at least as many '
                         f'mixture components; the grid has {K}')
    sizes = [K // n_comp + (c < K % n_comp) for c in range(n_comp)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


def _add(xs):
    """The sum of the tensors xs, in order."""
    tot = xs[0].clone()
    for x in xs[1:]:
        tot = tot + x
    return tot


def _top(xs):
    """The elementwise max of the tensors xs."""
    tot = xs[0].clone()
    for x in xs[1:]:
        tot = torch.maximum(tot, x)
    return tot


class Mesh:
    """The (comp, snp) shards of this process and the reductions across
    all of them. devices[j] holds flat shard first_shard + j, which is
    shard (c, s) = divmod(first_shard + j, n_snp)."""

    def __init__(self, n_snp, devices, rank=0, world=1, n_comp=1,
                 groups=None):
        self.n_snp = int(n_snp)
        self.n_comp = int(n_comp)
        self.devices = tuple(torch.device(d) for d in devices)
        self.rank = int(rank)
        self.world = int(world)
        per = len(self.devices)
        if per * self.world != self.n_comp * self.n_snp:
            raise ValueError(f'{per} shards in each of {self.world} '
                             f'processes do not make comp={self.n_comp}, '
                             f'snp={self.n_snp}')
        if self.world > 1 and per % self.n_snp and self.n_snp % per:
            raise ValueError(f'{per} shards a process split the snp '
                             f'columns of --mesh comp={self.n_comp},'
                             f'snp={self.n_snp} unevenly: a process must '
                             'own whole comp rows or a run within one')
        self.first_shard = self.rank * per
        # {ranks: process group} of the column and row subgroups
        self._groups = groups or {}
        # the global-gather layout's bytes: the full vectors snp_gather
        # hands the local shards, the partials they give snp_sum_span
        self.traffic = dict(gather_bytes=0, sum_bytes=0, gathers=0,
                            sums=0)

    @property
    def device(self):
        """Where this process's reductions land: its first shard's."""
        return self.devices[0]

    @property
    def local_shards(self):
        return range(self.first_shard, self.first_shard + len(self.devices))

    def coords(self, j):
        """(comp index, snp index) of local shard j."""
        return divmod(self.first_shard + j, self.n_snp)

    @property
    def snp_shards(self):
        """The snp span of each local shard (repeats across comp)."""
        return tuple(self.coords(j)[1] for j in range(len(self.devices)))

    def k_slice(self, j, K):
        """The slice of the K components local shard j holds."""
        return slice(*k_slices(K, self.n_comp)[self.coords(j)[0]])

    def counts_once(self, j):
        """Whether local shard j adds the values every comp shard of its
        column holds alike (the comp-0 copy alone adds them)."""
        return self.coords(j)[0] == 0

    def _owner(self, flat):
        return flat // len(self.devices)

    def counts_span(self, s):
        """Whether this process adds snp span s into global counts (it
        owns the span's comp-0 shard)."""
        return self._owner(s) == self.rank

    def _ranks(self, axis, key):
        """The processes owning a shard of snp column `key` (axis 'comp')
        or of comp row `key` (axis 'snp')."""
        flats = ([c * self.n_snp + key for c in range(self.n_comp)]
                 if axis == 'comp'
                 else [key * self.n_snp + s for s in range(self.n_snp)])
        return tuple(sorted({self._owner(f) for f in flats}))

    def _lines(self, axis):
        """[(key, local shards in order along `axis`)]: each snp column
        (axis 'comp', its shards by comp index) or comp row (axis 'snp',
        by snp index) this process holds a shard of, in key order."""
        by_key = {}
        for j in range(len(self.devices)):
            c, s = self.coords(j)
            key, pos = (s, c) if axis == 'comp' else (c, s)
            by_key.setdefault(key, []).append((pos, j))
        return [(key, [j for _, j in sorted(v)])
                for key, v in sorted(by_key.items())]

    def _group(self, ranks):
        """The process group of `ranks` (the default group for all)."""
        return (None if ranks is None or len(ranks) == self.world
                else self._groups[ranks])

    def _all_reduce(self, x, op, ranks=None):
        """x reduced by `op` ('SUM', 'MAX') across the processes (those
        of `ranks` only, where given)."""
        if self.world > 1 and (ranks is None or len(ranks) > 1):
            import torch.distributed as dist
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op),
                            group=self._group(ranks))
        return x

    def _line_reduce(self, parts, axis, combine, op):
        """One tensor per local shard: `combine` of the parts along `axis`
        (over the comp shards of each column, or the snp shards of each
        row), the same on every shard of the line."""
        out = [None] * len(parts)
        for key, js in self._lines(axis):
            dev = self.devices[js[0]]
            tot = combine([parts[j].to(dev) for j in js])
            tot = self._all_reduce(tot, op, self._ranks(axis, key))
            for j in js:
                out[j] = tot.to(self.devices[j])
        return out

    def comp_sum(self, parts):
        """The sum over the comp shards of each shard's snp column."""
        return self._line_reduce(parts, 'comp', _add, 'SUM')

    def comp_max(self, parts):
        """The elementwise max over the comp shards of each column."""
        return self._line_reduce(parts, 'comp', _top, 'MAX')

    def snp_sum(self, parts):
        """The sum over the snp shards of each shard's comp row."""
        return self._line_reduce(parts, 'snp', _add, 'SUM')

    def snp_gather(self, parts):
        """One [.., span] tensor per local shard in, one [.., n_snp *
        span] out: the spans of every snp shard of each shard's comp row
        joined in snp order (the gathered layout's input, ops/blocks.py).
        A row split over processes joins their runs by all_gather on the
        row's group."""
        out = [None] * len(parts)
        for key, js in self._lines('snp'):
            dev = self.devices[js[0]]
            full = torch.cat([parts[j].to(dev) for j in js], dim=-1)
            ranks = self._ranks('snp', key)
            if self.world > 1 and len(ranks) > 1:
                import torch.distributed as dist
                full = full.contiguous()
                runs = [torch.empty_like(full) for _ in ranks]
                dist.all_gather(runs, full, group=self._group(ranks))
                full = torch.cat(runs, dim=-1)
            for j in js:
                out[j] = full.to(self.devices[j])
                self.traffic['gather_bytes'] += (full.numel()
                                                 * full.element_size())
            self.traffic['gathers'] += 1
        return out

    def snp_sum_span(self, parts):
        """One full-length [.., n_snp * span] partial per local shard in,
        one [.., span] out: each shard's span of the sum over the snp
        shards of its comp row (the gathered layout's output)."""
        for p in parts:
            self.traffic['sum_bytes'] += p.numel() * p.element_size()
        self.traffic['sums'] += len(self._lines('snp'))
        rows = parts[0].shape[-1] // self.n_snp
        return [tot[..., s * rows:(s + 1) * rows].contiguous()
                for tot, s in zip(self.snp_sum(parts), self.snp_shards)]

    def comp_gather(self, parts):
        """The [n_comp, ...] stack of the parts of every comp shard of
        each shard's snp column, in comp order. Across processes each
        joins its rows into zeros (one writer per row: exact)."""
        out = [None] * len(parts)
        for key, js in self._lines('comp'):
            dev = self.devices[js[0]]
            if len(js) == self.n_comp:
                stack = torch.stack([parts[j].to(dev) for j in js])
            else:
                stack = parts[js[0]].new_zeros(
                    (self.n_comp,) + tuple(parts[js[0]].shape), device=dev)
                for j in js:
                    stack[self.coords(j)[0]] = parts[j].to(dev)
                stack = self._all_reduce(stack, 'SUM',
                                         self._ranks('comp', key))
            for j in js:
                out[j] = stack.to(self.devices[j])
        return out

    def comp_cat(self, parts, dim, K):
        """Each column's parts (the slices of K components along `dim`)
        concatenated in comp order, one tensor per local shard; uneven
        slices are padded for the stack and cut after it."""
        sizes = [b - a for a, b in k_slices(K, self.n_comp)]
        top = max(sizes)
        padded = []
        for p in parts:
            pad = list(p.shape)
            pad[dim] = top - p.shape[dim]
            padded.append(torch.cat([p, p.new_zeros(pad)], dim=dim)
                          if pad[dim] else p)
        return [torch.cat([st[c].narrow(dim, 0, sizes[c])
                           for c in range(self.n_comp)], dim=dim)
                for st in self.comp_gather(padded)]

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

    def writes(self, j):
        """Whether local shard j writes its span into joined outputs."""
        return True

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
                     for s, dev in zip(self.snp_shards, self.devices))

    def replicate(self, x):
        """x on every local shard's device."""
        return tuple(x.to(dev) for dev in self.devices)

    def gather_spans(self, parts):
        """One tensor per local shard that the comp shards of a column
        hold alike (a posterior mean), its last axis gathered over the
        snp spans in order."""
        view = self.columns()
        if view is self:
            return self.gather(parts)
        return view.gather([parts[js[0]] for js in view.lines])

    def columns(self):
        """The snp columns this process holds, as a mesh for outputs
        (`ColumnView`); a mesh without comp is its own."""
        return self if self.n_comp == 1 else ColumnView(self)


class ColumnView:
    """The snp columns of a comp mesh that this process holds a shard of,
    one entry each (on the device of the column's first local shard),
    with a snp mesh's gathers: the outputs of a comp-sharded fit are
    derived per column from its state gathered over comp. A column is
    written into joined outputs by one process, the owner of its comp-0
    shard."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_snp = mesh.n_snp
        self.n_comp = 1
        self.rank, self.world = mesh.rank, mesh.world
        lines = mesh._lines('comp')
        self.lines = [js for _, js in lines]
        self.columns = [key for key, _ in lines]
        self.devices = tuple(mesh.devices[js[0]] for js in self.lines)
        self.first_shard = self.columns[0]
        self._writer = [mesh._owner(s) == mesh.rank for s in self.columns]

    @property
    def device(self):
        return self.devices[0]

    def writes(self, j):
        return self._writer[j]

    def join(self, x):
        return self.mesh.join(x)

    def gather(self, parts):
        """The last axes of one tensor per column concatenated over every
        column in order, on `device`; across processes each column's
        writer fills it into zeros and the processes join."""
        rows = parts[0].shape[-1]
        if self.world == 1:
            return torch.cat([p.to(self.device) for p in parts], dim=-1)
        out = parts[0].new_zeros(tuple(parts[0].shape[:-1])
                                 + (rows * self.n_snp,), device=self.device)
        for j, (s, p) in enumerate(zip(self.columns, parts)):
            if self._writer[j]:
                out[..., s * rows:(s + 1) * rows] = p.to(self.device)
        return self.mesh.join(out)


def make_mesh(n_snp=None, n_comp=1, devices=None, device='cuda'):
    """The mesh of `n_comp` x `n_snp` shards over the processes of the
    default process group (one without it). Each process owns
    n_comp * n_snp / world shards: by default one card each (`device`
    'cuda'; the processes of a host take its cards in rank order;
    raising when too few cards are present, never wrapping shards round
    the cards it finds) or the host ('cpu'). `devices` places this
    process's shards explicitly (one entry per shard; for tests and
    chip_smoke.py). Across processes, the subgroups of the comp columns
    and rows are made here, on every process alike."""
    import torch.distributed as dist
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n_comp = int(n_comp)
    if n_comp < 1:
        raise ValueError(f'--mesh comp={n_comp} must be positive')
    if n_snp is None:
        n_snp = world * (len(devices) if devices is not None else
                         torch.cuda.device_count()
                         if torch.device(device).type == 'cuda' else 1)
        n_snp //= n_comp
    n_snp = int(n_snp)
    total = n_comp * n_snp
    if n_snp < 1 or total % world:
        raise ValueError(f'--mesh comp={n_comp},snp={n_snp} must make a '
                         f'positive multiple of the process count ({world})')
    per_process = total // world
    if devices is None:
        if torch.device(device).type == 'cuda':
            count = torch.cuda.device_count()
            first = rank * per_process % count if count else 0
            if first + per_process > count:
                raise RuntimeError(
                    f'--mesh comp={n_comp},snp={n_snp} needs {per_process} '
                    f'CUDA devices for each of {world} process(es), one per '
                    f'shard; {count} present')
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
    mesh = Mesh(n_snp, devices, rank, world, n_comp)
    if world > 1 and n_comp > 1:
        # every process makes every subgroup, in one order
        sets = sorted({mesh._ranks(axis, key)
                       for axis, keys in (('comp', range(n_snp)),
                                          ('snp', range(n_comp)))
                       for key in keys})
        for ranks in sets:
            if len(ranks) > 1:
                mesh._groups[ranks] = (None if len(ranks) == world
                                       else dist.new_group(list(ranks)))
    return mesh


# the [*, I] fields of each dataclass, split along the spans, and the
# [K, ...] ones, split along the comp slices (the JAX package's _specs);
# hyper_delta [A, K] splits its columns; the others are copied
_SNP_FIELDS = {
    'ModelData': ('marginal_effects', 'std_errs', 'scalings', 'ld_diags',
                  'scaled_ld_diags', 'adj_marginal_effects',
                  'inverse_betas', 'annotations'),
    'VIState': ('nat_mu', 'nat_hist', 'vi_mu', 'vi_delta',
                'nat_grad_vi_delta'),
    'SigmaSummaries': tuple(f.name for f in
                            dataclasses.fields(SigmaSummaries)),
}
_K_FIELDS = {
    'ModelData': ('mixture_prec', 'log_det'),
    'VIState': ('vi_mu', 'vi_delta'),
    'SigmaSummaries': _SNP_FIELDS['SigmaSummaries'],
}


def _place(obj, mesh, K):
    """One copy of a dataclass per local shard: its [*, I] fields split,
    its [K, ...] fields sliced (a kdim nat_mu too; under comp the [K-1, I]
    nat_grad_vi_delta, which the comp path derives from hyper_delta, is
    dropped), nested summaries placed alike, other tensors copied, the
    rest shared."""
    owner = type(obj).__name__
    snp, kf = _SNP_FIELDS[owner], _K_FIELDS[owner]
    comp = mesh.n_comp > 1
    per_shard = [{} for _ in mesh.devices]
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, SigmaSummaries):
            parts = _place(val, mesh, K)
        elif torch.is_tensor(val):
            if comp and f.name == 'nat_grad_vi_delta':
                parts = [None] * len(mesh.devices)
            else:
                parts = (mesh.split(val) if f.name in snp
                         else mesh.replicate(val))
                if comp and (f.name in kf or f.name == 'hyper_delta' or (
                        f.name == 'nat_mu' and val.dim() == 3)):
                    dim = 1 if f.name == 'hyper_delta' else 0
                    parts = [p.narrow(dim, ks.start, ks.stop - ks.start)
                             .contiguous()
                             for p, ks in zip(parts, (
                                 mesh.k_slice(j, K)
                                 for j in range(len(mesh.devices))))]
        else:
            parts = [val] * len(mesh.devices)
        for d, p in zip(per_shard, parts):
            d[f.name] = p
    return [dataclasses.replace(obj, **d) for d in per_shard]


def shard_data(data, mesh):
    """An unsharded ModelData on the mesh: its [*, I] arrays split along
    the spans onto the shards' devices, its LD matrices regrouped by span
    (blocks.shard, raising if a block straddles one), its [K, ...] tables
    sliced over comp, the small tables and the global sums (chi_stat,
    ld_ranks, annotation_counts) copied to each. Returns an
    engine.ShardedData."""
    K = data.mixture_prec.shape[0]
    k_slices(K, mesh.n_comp)
    lds = [blocks.shard(ld, mesh.n_snp, mesh.devices, mesh.snp_shards)
           for ld in data.ld]
    parts = _place(dataclasses.replace(data, ld=()), mesh, K)
    return engine.ShardedData(
        shards=tuple(dataclasses.replace(p, ld=tuple(ld.shards[j]
                                                     for ld in lds))
                     for j, p in enumerate(parts)),
        mesh=mesh)


def shard_state(state, mesh):
    """An unsharded VIState on the mesh: per-SNP fields split, [K, ...]
    fields sliced over comp, the small ones copied, host scalars shared.
    Returns an engine.ShardedState."""
    K = state.hyper_delta.shape[1]
    return engine.ShardedState(tuple(_place(state, mesh, K)),
                               n_comp=mesh.n_comp)
