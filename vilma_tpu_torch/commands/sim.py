"""The `sim` command: simulate GWAS summary data from the mixture model.

Port of vilma_tpu/commands/sim.py with the same flags and outputs, plus
--device: per-SNP mixture-component draws by annotation, correlated true
effects through Cholesky factors, and GWAS estimates
beta_hat = S X (beta/S) + S X^{1/2} eps, the LD-correlated noise going
through the packed block matrix_power(0.5).

The draws and the Cholesky factors are host numpy in float64, in the
reference's order of global-RNG draws:

1. np.random.seed;
2. the fill-in draw for unannotated variants;
3. per cohort, two draws per loaded LD block (the reference's mmap
   mode, which sim hardcodes: its LD loads stage through the disk
   spill, load.load_ld_from_schema(mmap=True));
4. one categorical draw per SNP (or, with --fast-rng, one vectorized
   inverse-CDF draw: same distribution, different stream);
5. the latent normals;
6. the per-cohort noise.

The two LD products of each cohort, dot(LD, beta/S) and
dot(LD^{1/2}, eps), run on --device: on the card in float32, the block
matvec kernel's type; on the host in float64 through its plain version.
"""
import logging
import os
import pickle

import numpy as np
import torch

from vilma_tpu_torch.commands import resolve_device
from vilma_tpu_torch.io import load
from vilma_tpu_torch.ops import blocks


def args(super_parser):
    parser = super_parser.add_parser(
        'sim',
        description='Simulate GWAS summary data from a '
                    'mixture-of-gaussians model.',
        usage='vilma-tpu-torch sim <options>',
    )
    parser.add_argument('--sumstats', required=True, type=str,
                        help='Comma-separated paths to summary statistics.')
    parser.add_argument('--covariance', required=True, type=str,
                        help='Path to .pkl file containing the covariance '
                             'matrices for each Gaussian component.')
    parser.add_argument('--weights', required=True, type=str,
                        help='Path to a .npy matrix of weights '
                             '(num_annotations x num_components), or a '
                             '.npz fitted model.')
    parser.add_argument('--gwas-n-scaling', required=False, type=str,
                        default='1.',
                        help='Comma-separated per-cohort sample size '
                             'scalings.')
    parser.add_argument('--annotations', type=str, default='',
                        help='Path to annotations file.')
    parser.add_argument('--output', required=True, type=str,
                        help='Output path prefix.')
    parser.add_argument('--names', type=str, required=False,
                        help='Comma-separated names of the populations for '
                             'the output. Defaults to 0, 1, ...')
    parser.add_argument('--ld-schema', required=True, type=str,
                        help='Comma-separated paths to LD panel schemas.')
    parser.add_argument('--seed', type=int, default=42,
                        help='Seed for random number generation.')
    parser.add_argument('--fast-rng', dest='fast_rng', action='store_true',
                        help='Vectorize the per-SNP component draws. '
                             'Statistically identical but NOT draw-for-'
                             'draw compatible with the reference RNG '
                             'stream (seeded outputs differ).')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='Where the LD products run: cuda (default, '
                             'float32, fails without a CUDA device) or '
                             'cpu (float64).')
    return parser


def ld_dtype(device):
    """The float type of the LD products: float32 on the card (the block
    matvec kernel's), float64 on the host."""
    return torch.float32 if device.type == 'cuda' else torch.float64


def sim_components(annotations, weights, fast=False):
    """One-hot component draws, row i ~ Categorical(weights[annotation[i]]).

    Default: per-SNP np.random.choice in SNP order, the reference's draw
    sequence (reference sim.py:71-94). fast=True: one uniform per SNP
    inverted through the per-annotation CDF."""
    num_snps, num_components = annotations.shape[0], weights.shape[1]
    one_hot = np.zeros((num_snps, num_components))
    if fast:
        annot_idx = np.argmax(annotations, axis=1)
        cdf = np.cumsum(weights, axis=1)
        u = np.random.random(num_snps)
        comp_idx = np.minimum((u[:, None] > cdf[annot_idx]).sum(axis=1),
                              num_components - 1)
        one_hot[np.arange(num_snps), comp_idx] = 1
        return one_hot
    for i in range(num_snps):
        this_annotation = np.where(annotations[i] == 1)[0][0]
        comp_idx = np.random.choice(num_components,
                                    p=weights[this_annotation])
        one_hot[i, comp_idx] = 1
    return one_hot


def sim_true_effects(annotations, weights, cov_mats, fast=False):
    """Draw true effects from the mixture model (reference sim.py:97-133)."""
    num_pops = cov_mats.shape[-1]
    one_hot_components = sim_components(annotations, weights, fast=fast)
    latent_effects = np.random.normal(
        loc=0, scale=1, size=(annotations.shape[0], num_pops))
    sqrt_covs = np.array([np.linalg.cholesky(mat) for mat in cov_mats])
    return np.einsum('ip,ik,kqp->qi', latent_effects, one_hot_components,
                     sqrt_covs)


def _ld_dot(ld_mat, vector):
    """LD @ vector for a host float64 vector, in the LD's float type on
    its device (the CUDA kernel on the card); float64 numpy out."""
    dtype = ld_mat.buckets[0].s.dtype if ld_mat.buckets else torch.float64
    x = torch.as_tensor(vector, device=ld_mat.device or 'cpu').to(dtype)
    return blocks.dot(ld_mat, x).cpu().numpy().astype(np.float64)


def sim_gwas(true_beta, std_errs, ld_mat):
    """Simulate GWAS estimates (reference sim.py:136-156)."""
    mean = std_errs * _ld_dot(ld_mat, true_beta / std_errs)
    latent_noise = np.random.normal(loc=0, scale=1,
                                    size=true_beta.shape[0])
    half = blocks.matrix_power(ld_mat, 0.5)
    true_noise = std_errs * _ld_dot(half, latent_noise)
    return mean + true_noise


def _combined_variants(sumstats_paths):
    """Union of the variant lists of every sumstats file: the first row
    of each ID, in order."""
    table = load.concat_tables([load.load_variant_list(path)
                                for path in sumstats_paths])
    _, first = np.unique(table['ID'].astype(str), return_index=True)
    return table.take(np.sort(first))


def _fill_missing_annotations(annotations, denylist):
    """Unannotated variants draw a random annotation proportional to the
    observed annotation frequencies (reference sim.py:187-200): one
    np.random.choice draw."""
    proportions = annotations.sum(axis=0).astype(np.float64)
    proportions /= proportions.sum()
    random_annots = np.random.choice(annotations.shape[1],
                                     size=len(denylist),
                                     p=proportions, replace=True)
    annotations[denylist, :] = 0
    annotations[denylist, random_annots] = 1
    assert np.all(annotations.sum(axis=1) == 1)
    return annotations


def _load_weights(weights_path, num_annotations, num_components):
    """Mixture weights from a raw .npy matrix or a fitted .npz model."""
    loaded = np.load(weights_path)
    if isinstance(loaded, np.lib.npyio.NpzFile):
        weights = np.asarray(loaded['hyper_delta'])
    else:
        weights = np.asarray(loaded)
    if weights.shape[0] != num_annotations:
        raise ValueError('Weight rows must equal the number of '
                         'annotation categories.')
    if weights.shape[1] != num_components:
        raise ValueError('Weight columns must equal the number of '
                         'mixture covariance matrices.')
    if not np.allclose(weights.sum(axis=1), 1.):
        raise ValueError('Each annotation row of the weights must sum '
                         'to 1.')
    return weights


def main(args):
    np.random.seed(args.seed)
    device = resolve_device(args.device)
    dtype = ld_dtype(device)

    sumstats_paths = args.sumstats.split(',')
    num_pops = len(sumstats_paths)
    names = list(map(str, range(num_pops)))
    if args.names is not None:
        if args.names.count(',') != args.sumstats.count(','):
            raise ValueError('If --names are provided, one must be '
                             'provided per sumstat file.')
        names = args.names.split(',')

    n_scales = np.ones(num_pops)
    n_scales[:] = np.array(list(map(float, args.gwas_n_scaling.split(','))))
    if not np.all(n_scales > 0):
        raise ValueError('--gwas-n-scaling must be all positive.')

    all_vars = _combined_variants(sumstats_paths)
    annotations, denylist = load.load_annotations(args.annotations, all_vars)
    annotations = _fill_missing_annotations(annotations, denylist)

    # missing data gets SE 1e-100, dropped at output (reference sim.py:205)
    n = len(all_vars)
    std_errs = np.full((num_pops, n), 1e-100)
    ld_mats = []
    ld_cache = {}
    for idx, (sstats_file, n_scale, ld_schema_path) in enumerate(
            zip(sumstats_paths, n_scales, args.ld_schema.split(','))):
        logging.info('Loading sumstats for population %s...', names[idx])
        these_sstats, missing = load.load_sumstats(sstats_file, all_vars)
        logging.info('Loading LD for population %s...', names[idx])
        # cohorts sharing a panel and a missing set share one loaded
        # matrix; the reuse still takes the load's RNG draws
        key = (os.path.realpath(ld_schema_path), tuple(missing))
        if key in ld_cache:
            ld_mat, this_missing_ld = ld_cache[key]
            load.consume_mmap_rng_draws(
                sum(bk.num_blocks for bk in ld_mat.buckets))
        else:
            ld_mat, this_missing_ld = load.load_ld_from_schema(
                ld_schema_path, variants=all_vars, denylist=missing,
                ldthresh=0.999999, mmap=True, dtype=dtype, device=device)
            ld_cache[key] = (ld_mat, this_missing_ld)
        ld_mats.append(ld_mat)
        keep_bool = np.ones(n, dtype=bool)
        keep_bool[missing] = False
        keep_bool[this_missing_ld] = False
        std_errs[idx, keep_bool] = (np.sqrt(1 / n_scale)
                                    * these_sstats['SE'][keep_bool])

    with open(args.covariance, 'rb') as pickle_file:
        cov_mats = np.array(pickle.load(pickle_file)[0])
    weights = _load_weights(args.weights, annotations.shape[1],
                            len(cov_mats))

    true_effects = sim_true_effects(annotations, weights, cov_mats,
                                    fast=args.fast_rng)
    sim_beta_hat = np.stack(
        [sim_gwas(beta, std_vec, ld_mat)
         for ld_mat, beta, std_vec in zip(ld_mats, true_effects, std_errs)])

    for p, name in enumerate(names):
        logging.info('Saving results for cohort %s', name)
        to_save = all_vars.copy()
        to_save['SE'] = std_errs[p]
        to_save['BETA'] = sim_beta_hat[p]
        to_save['true_beta'] = true_effects[p]
        # the reference sets the missing-data SE to NaN, then dropna()
        keep = ((std_errs[p] >= 1e-99) & ~np.isnan(sim_beta_hat[p])
                & ~np.isnan(true_effects[p]))
        to_save.take(keep).to_tsv(args.output + '.' + name + '.simgwas.tsv')
