"""The `fit` command: variational inference on GWAS summary statistics.

Port of vilma_tpu/commands/fit.py with the same flags and output files
(.npz, .covariance.pkl, .estimates.tsv), plus --device.

`--mesh snp=N` shards the fit over N shards (parallel/mesh.py), one card
each on cuda; the inputs are relaid out in the shard-local layout
(parallel/alignment.py) and the outputs come back in the original
variant order. `--mesh comp=M[,snp=N]` also splits the K mixture
components over M comp shards (M x N shards in all, one card each on
cuda): each holds a slice of the [K, ...] state, and the softmax over K
is reduced across them. `--distributed` joins processes over
torch.distributed (NCCL on cuda, gloo on cpu): the layout is planned from
the schemas' metadata before any load, each process factorizes only the
blocks of its shards' snp spans, and process 0 writes the files. Still
raising, with its ROADMAP item: cohorts whose schemas disagree on the
order of shared variants (the JAX package's global-gather layout).
"""
import logging
import os
import pickle

import numpy as np

from vilma_tpu_torch.commands import resolve_device
from vilma_tpu_torch.io import load
from vilma_tpu_torch.models import mixture


def args(super_parser):
    parser = super_parser.add_parser(
        'fit',
        description='Use variational inference to learn '
                    'effect sizes and effect size distribution '
                    'from GWAS summary data.',
        usage='vilma-tpu-torch fit <options>',
    )
    parser.add_argument('-K', '--components', default=12, type=int,
                        help='number of mixture components in prior')
    parser.add_argument('--num-its', default=1000, type=int,
                        help='Maximum number of optimization iterations.')
    parser.add_argument('--ld-schema', required=True, type=str,
                        help='Comma-separated paths to LD panel schemas.')
    parser.add_argument('--sumstats', required=True, type=str,
                        help='Comma-separated paths to summary statistics.')
    parser.add_argument('--stderrscale', default='1.0', type=str,
                        required=False,
                        help='Comma separated list of values to multiply '
                             'summary stat stderrs by.')
    parser.add_argument('--annotations', type=str, default=None,
                        help='Path to annotation file.')
    parser.add_argument('--output', required=True, type=str,
                        help='Output path prefix.')
    parser.add_argument('--names', type=str, required=False,
                        help='Comma-separated names of the populations for '
                             'output. Defaults to 0, 1,... ')
    parser.add_argument('--extract', required=True, type=str,
                        help='List of SNPs to include in analysis, '
                             'with ID, A1, and A2 columns.')
    parser.add_argument('--scaled', dest='scaled', action='store_true',
                        help='Place the prior on frequency-scaled effect '
                             'sizes instead of natural-scale effects.')
    parser.add_argument('--ldthresh', required=False, default=1.0,
                        type=float,
                        help='Threshold for singular value approximation of '
                             'the LD matrix; --ldthresh x guarantees SNPs '
                             'with r^2 >= x stay linearly independent.')
    parser.add_argument('--seed', type=int, default=42,
                        help='Seed for random number generation.')
    parser.add_argument('--mmap', dest='mmap', action='store_true',
                        help='Stage LD factor payloads through disk '
                             '(memory-mapped temporary files) instead of '
                             'holding them in host RAM; bounds peak host '
                             'memory for whole-genome schemas.')
    parser.add_argument('--factor-cache', type=str, default='',
                        help='Directory memoizing per-block LD '
                             'eigendecompositions: refits of the same LD '
                             'panel (new sumstats or hyperparameters, a '
                             'resume, more traits) skip them. Entries are '
                             'keyed by file identity, threshold and '
                             'variant match, and shared with vilma-tpu.')
    parser.add_argument('--learn-scaling', dest='scale_se',
                        action='store_true',
                        help='Learn a scaling factor for the standard '
                             'errors.')
    parser.add_argument('--samplesizes', type=str, default='100e3',
                        help='Comma-separated GWAS sample sizes used for '
                             'initialization.')
    parser.add_argument('--init-hg', type=str, default='0.1',
                        help='Comma-separated per-population heritability '
                             'guesses used for initialization.')
    parser.add_argument('--trait', dest='trait', action='store_true',
                        help='Treat sumstats files as different traits '
                             'measured on one cohort: all traits share a '
                             'single LD panel (pass one --ld-schema) and '
                             'the mixture prior becomes a grid of '
                             'cross-trait effect covariances.')
    parser.add_argument('--checkpoint-freq', type=int, default=-1,
                        help='Store the model every this many iterations. '
                             'Defaults to no checkpointing.')
    parser.add_argument('--load-checkpoint', type=str, default='', nargs=2,
                        help='Resume optimization from CHECKPOINT_FILE.npz '
                             'and COVARIANCE_FILE.pkl.',
                        metavar=('CHECKPOINT_FILE.npz',
                                 'COVARIANCE_FILE.pkl'))
    parser.add_argument('--precision', type=str, default='auto',
                        choices=['auto', 'f32', 'f64'],
                        help='Numerical precision of the solver. f64 is '
                             'the parity path (--device cpu); f32 the '
                             'card path. auto picks f32 on cuda and f64 '
                             'on cpu.')
    parser.add_argument('--ld-precision', type=str, default='auto',
                        choices=['auto', 'f32', 'bf16'],
                        help='Storage precision of the LD eigenvector '
                             'tensors (the dominant device traffic and '
                             'capacity). bf16 halves both; contractions '
                             'still accumulate in f32. auto follows '
                             '--precision.')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='Where the fit runs. cuda (default) runs the '
                             'hand-written kernels and fails if no CUDA '
                             'device is present; cpu runs their plain '
                             'PyTorch versions.')
    parser.add_argument('--mesh', type=str, default='',
                        help='Shard the fit over a mesh of devices, e.g. '
                             '"snp=4": the LD blocks and every per-SNP '
                             'array split into 4 spans, one card each '
                             '(with --distributed, over all processes); '
                             '"comp=2,snp=4" also splits the mixture '
                             'components in 2 slices, 8 shards in all.')
    parser.add_argument('--distributed', action='store_true',
                        help='Join a multi-process fit over '
                             'torch.distributed (NCCL on cuda, gloo on '
                             'cpu) before loading; needs --mesh. Pass '
                             '--coordinator/--num-processes/--process-id, '
                             'or launch with torchrun (env://).')
    parser.add_argument('--coordinator', type=str, default='',
                        help='coordinator host:port for --distributed.')
    parser.add_argument('--num-processes', type=int, default=None,
                        help='total process count for --distributed.')
    parser.add_argument('--process-id', type=int, default=None,
                        help='this process\'s rank for --distributed.')
    parser.add_argument('--profile', type=str, default='',
                        help='Write a torch.profiler chrome trace of the '
                             'optimization to this directory.')
    parser.add_argument('--pallas', type=str, default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Use the fused kernels (the block matvec, the '
                             'compact-objective prologue and the '
                             'annotation sums). On cuda, auto and on run '
                             'the hand-written CUDA kernels and off is '
                             'refused; on cpu the plain PyTorch versions '
                             'run whatever the value.')
    parser.add_argument('--drop-non-psd', action='store_true',
                        help='Drop mixture-grid components whose '
                             'covariance is not positive definite (the '
                             'grid is drawn identically, same RNG '
                             'stream).')
    parser.add_argument('--no-save-vi-sigma', dest='save_vi_sigma',
                        action='store_false',
                        help='Skip the vi_sigma array in the output '
                             '.npz (output-only; dominates the file at '
                             'genome scale).')
    parser.add_argument('--align-layout', dest='align_layout',
                        action='store_true',
                        help='Accepted for compatibility; a no-op here '
                             '(the 128-aligned layout serves TPU row '
                             'gathers only, and outputs are identical).')
    return parser


def _check_supported(args):
    """The --mesh axes ({'snp': N, 'comp': M}), checked before any file
    is read: unknown axes, sizes below 1 and a mesh-less --distributed
    raise ValueError."""
    axes = {'snp': 1, 'comp': 1}
    if args.mesh:
        for kv in args.mesh.split(','):
            name, _, size = kv.partition('=')
            if name not in axes or not size.isdigit() or int(size) < 1:
                raise ValueError(f'--mesh {args.mesh}: expected '
                                 'snp=N[,comp=M] with positive sizes')
            axes[name] = int(size)
    if args.distributed and not args.mesh:
        raise ValueError('--distributed needs a device mesh: pass --mesh '
                         'snp=<total shards across all processes>')
    return axes


def _resolve_device(args):
    device = resolve_device(args.device)
    if args.device == 'cuda':
        if args.pallas == 'off':
            raise ValueError('--pallas off is refused on cuda: the port '
                             'has no unfused device path; every kernel '
                             'of the fit runs as its CUDA kernel')
    if args.precision == 'auto':
        args.precision = 'f32' if args.device == 'cuda' else 'f64'
    if args.device == 'cuda' and args.precision == 'f64':
        raise ValueError('--precision f64 is the host parity path: use '
                         '--device cpu (the CUDA kernels compute in f32)')
    return device


def main(args, devices=None):
    """Run the fit. `devices` (for Python callers: tests, chip_smoke.py)
    places this process's shards of --mesh explicitly, one entry per
    shard (co-located shards on one card, say); the CLI gives one card
    per shard."""
    import torch
    np.random.seed(args.seed)
    axes = _check_supported(args)
    device = _resolve_device(args)
    # a multi-process fit joins its process group and builds its mesh
    # before loading, so that each process loads only its own blocks
    if args.distributed:
        from vilma_tpu_torch.parallel import distributed
        distributed.initialize(args.coordinator or None, args.num_processes,
                               args.process_id, device=device)
    mesh = None
    if args.mesh:
        from vilma_tpu_torch.parallel import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(n_snp=axes['snp'], n_comp=axes['comp'],
                                  devices=devices, device=device)
    multiproc = mesh is not None and mesh.world > 1

    if (not args.trait
            and args.ld_schema.count(',') != 1
            and args.ld_schema.count(',') != args.sumstats.count(',')):
        raise ValueError('Either need to input one ld_schema or provide a '
                         'sumstats file for each ld_schema.')
    if args.trait:
        n_schemas = args.ld_schema.count(',') + 1
        n_traits = args.sumstats.count(',') + 1
        if n_schemas == 1 and n_traits > 1:
            args.ld_schema = ','.join([args.ld_schema] * n_traits)
        elif n_schemas != n_traits:
            raise ValueError('--trait needs one shared --ld-schema (or '
                             'one per trait).')
        if n_traits > 1:
            logging.warning(
                '--trait assumes INDEPENDENT GWAS noise across traits. '
                'For traits measured on the same individuals, correlated '
                'sampling noise leaks into the learned cross-trait '
                'effect-size correlation.')

    num_pops = args.sumstats.count(',') + 1
    names = list(map(str, range(num_pops)))
    if args.names is not None:
        if args.names.count(',') != args.sumstats.count(','):
            raise ValueError('If --names are provided, one must be '
                             'provided per sumstat file.')
        names = args.names.split(',')

    logging.info('Loading variants...')
    variants = load.load_variant_list(args.extract)

    logging.info('Loading annotations...')
    annotations, denylist = load.load_annotations(args.annotations,
                                                  variants=variants)
    missing_annot = np.zeros(len(annotations), dtype=bool)
    missing_annot[denylist] = True
    missing_sumstats = np.zeros((len(annotations), num_pops), dtype=bool)
    missing_ld_info = np.zeros((len(annotations), num_pops), dtype=bool)

    stderr_mult = np.zeros(num_pops)
    stderr_mult[:] = list(map(float, args.stderrscale.split(',')))
    gwas_n = np.zeros(num_pops)
    gwas_n[:] = list(map(float, args.samplesizes.split(',')))
    init_hg = np.zeros(num_pops)
    init_hg[:] = list(map(float, args.init_hg.split(',')))

    dtype = torch.float64 if args.precision == 'f64' else torch.float32
    u_dtype = {'bf16': torch.bfloat16, 'f32': torch.float32,
               'auto': None}[args.ld_precision]

    # pass 1: sumstats for every cohort (host-side, no RNG draws)
    combined_betas, combined_errors, cohort_missing = [], [], []
    for idx, sumstats_path in enumerate(args.sumstats.split(',')):
        logging.info('Loading sumstats for population %d...', idx + 1)
        sumstats, missing = load.load_sumstats(sumstats_path,
                                               variants=variants)
        missing_sumstats[missing, idx] = True
        missing.extend(denylist)
        cohort_missing.append(missing)
        combined_betas.append(np.array(sumstats['BETA']).reshape((1, -1)))
        logging.info('Largest beta is... %f',
                     np.max(np.abs(np.array(sumstats['BETA']))))
        combined_errors.append(np.array(sumstats['SE']).reshape((1, -1))
                               * stderr_mult[idx])

    # a multi-process fit plans the shard-local layout from the schemas'
    # metadata before any load, so that each process factorizes only the
    # blocks of its own shards
    plan = None
    if multiproc:
        from vilma_tpu_torch.parallel import distributed
        plan = distributed.plan_sharded_load(
            list(zip(args.ld_schema.split(','), cohort_missing)), variants,
            mesh.n_snp)
        if plan is None:
            _conflicting_schemas()

    # pass 2: LD per cohort; cohorts sharing a panel (same path, same
    # masked variants) get ONE loaded matrix, and so one matvec pass. A
    # single-process mesh loads the factors on the host at f64 and relays
    # them out onto the shards below, where they are packed as the
    # unsharded load packs them (the same bits of u, s and inv_s)
    combined_ld = []
    ld_cache = {}
    for idx, (ld_schema_path, missing) in enumerate(
            zip(args.ld_schema.split(','), cohort_missing)):
        logging.info('Loading LD for population %d...', idx + 1)
        ld_key = (os.path.realpath(ld_schema_path),
                  tuple(sorted(set(missing))))
        if ld_key in ld_cache:
            logging.info('Population %d shares the LD panel of an '
                         'earlier population; reusing it.', idx + 1)
        elif multiproc:
            ld_cache[ld_key] = distributed.load_ld_sharded(
                ld_schema_path, variants=variants, denylist=missing,
                ldthresh=args.ldthresh, mmap=args.mmap, dtype=dtype,
                u_dtype=u_dtype, cache_dir=args.factor_cache or None,
                mesh=mesh, plan=plan)
        else:
            ld_cache[ld_key] = load.load_ld_from_schema(
                ld_schema_path, variants=variants, denylist=missing,
                ldthresh=args.ldthresh, mmap=args.mmap,
                dtype=torch.float64 if mesh is not None else dtype,
                u_dtype=None if mesh is not None else u_dtype,
                cache_dir=args.factor_cache or None,
                device='cpu' if mesh is not None else device)
        ld_mat, this_missing_ld = ld_cache[ld_key]
        combined_ld.append(ld_mat)
        missing_ld_info[this_missing_ld, idx] = True

    betas = np.concatenate(combined_betas, axis=0)
    std_errs = np.concatenate(combined_errors, axis=0)
    logging.info('Largest beta is... %f', np.max(np.abs(betas)))

    if args.load_checkpoint:
        with open(args.load_checkpoint[1], 'rb') as pfile:
            cross_pop_covs = pickle.load(pfile)[0]
    else:
        logging.info('Building cross-population covariances...')
        mins, maxes = mixture.effect_size_ranges(betas, std_errs,
                                                 args.scaled)
        cross_pop_covs = mixture.make_simple(
            num_pops, args.components, mins, maxes,
            drop_non_psd=args.drop_non_psd)
        if mesh is None or mesh.rank == 0:
            with open('%s.covariance.pkl' % args.output, 'wb') as ofile:
                pickle.dump([cross_pop_covs], ofile)

    # the layout comes after the grid, which reads the unpadded inputs
    out_index = None
    if mesh is not None:
        from vilma_tpu_torch.parallel import alignment
        if multiproc:
            layout_map, L = plan.layout_map, plan.L
        else:
            layout_map, L, ok = alignment.compute_layout(
                combined_ld, len(variants), n_shards=mesh.n_snp)
            if not ok:
                _conflicting_schemas()
            from vilma_tpu_torch.ops import blocks as blocks_mod
            spill = blocks_mod.FactorSpill() if args.mmap else None
            # by identity: cohorts sharing a loaded panel keep sharing it
            relayouted = {}
            for ld in combined_ld:
                if id(ld) not in relayouted:
                    relayouted[id(ld)] = alignment.relayout_ld(
                        ld, layout_map, L, dtype=dtype, spill=spill,
                        u_dtype=u_dtype, n_shards=mesh.n_snp,
                        device=list(mesh.devices),
                        shards=list(mesh.snp_shards))
            combined_ld = [relayouted[id(ld)] for ld in combined_ld]
        logging.info('Shard-local layout: %d variants -> %d slots in %d '
                     'spans', len(variants), L, mesh.n_snp)
        betas = alignment.relayout_rows(betas, layout_map, L, fill=0.0)
        std_errs = alignment.relayout_rows(std_errs, layout_map, L,
                                           fill=1.0)
        annotations = alignment.relayout_annotations(annotations,
                                                     layout_map, L)
        out_index = layout_map

    logging.info('Fitting...')
    from vilma_tpu_torch.inference import MultiPopVI
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    elbo = MultiPopVI(
        marginal_effects=betas.astype(np_dtype),
        std_errs=std_errs.astype(np_dtype),
        ld_mats=combined_ld,
        mixture_covs=cross_pop_covs,
        annotations=annotations,
        checkpoint=(args.checkpoint_freq > 0),
        checkpoint_freq=args.checkpoint_freq,
        output=args.output,
        scaled=args.scaled,
        scale_se=args.scale_se,
        gwas_N=gwas_n,
        init_hg=init_hg,
        num_its=args.num_its,
        dtype=dtype,
        device=device,
        mesh=mesh,
        out_index=out_index,
    )
    checkpoint = None
    if args.load_checkpoint:
        checkpoint = np.load(args.load_checkpoint[0])
    if args.profile:
        state = _profiled(elbo, args.profile, checkpoint)
    else:
        state = elbo.optimize(checkpoint)

    # genome-scale fits stream the [K, *, I]-shaped members (vi_mu,
    # vi_delta, vi_sigma) into the .npz in bounded chunks. Every process
    # of a multi-process fit computes them (their chunks gather across
    # processes); process 0 alone writes the files
    to_save, streams = elbo.dump_spec(state)
    posterior_means = elbo.real_posterior_mean(state)
    posterior_vars = elbo.real_posterior_variance(state)
    if args.save_vi_sigma:
        streams = streams + [
            ('vi_sigma',
             (elbo.num_mix, elbo.num_pops, elbo.num_pops, elbo.num_loci),
             np_dtype, elbo.vi_sigma_chunks())]
    from vilma_tpu_torch.inference.engine import write_npz_all_ranks
    write_npz_all_ranks(args.output, to_save, streams, elbo.rank)
    if elbo.rank != 0:
        return

    for name, posterior in zip(names, posterior_means):
        variants['posterior_' + name] = posterior
    for name, pmv in zip(names, posterior_vars):
        variants['posterior_variance_' + name] = pmv
    if args.annotations:
        variants['missing_annotation'] = missing_annot
    for idx, name in enumerate(names):
        variants['missing_sumstats_' + name] = missing_sumstats[:, idx]
        variants['missing_LD_' + name] = missing_ld_info[:, idx]
    variants.to_tsv(args.output + '.estimates.tsv')


def _conflicting_schemas():
    raise NotImplementedError(
        'the LD schemas disagree on the relative order of shared '
        'variants, so no shard-local layout exists; the JAX package\'s '
        'global-gather mesh layout is not ported yet (ROADMAP.md queue '
        '1, "Global-gather mesh layout")')


def _profiled(elbo, trace_dir, checkpoint=None):
    """optimize() under torch.profiler, writing a chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        state = elbo.optimize(checkpoint)
    prof.export_chrome_trace(os.path.join(trace_dir, 'fit_trace.json'))
    return state
