"""The `make_ld_schema` command: build a block LD matrix from genotypes.

Port of vilma_tpu/commands/make_ld_schema.py with the same flags and
on-disk schema format, plus --device: per block a
`<root>_{chrom}:{block}.npy` correlation matrix (or, with --ldthresh in
[0, 1], the truncated eigendecomposition stacked as `[U; s]`), a `.var`
variant file, and a `<root>.schema` manifest listing them.

Genotypes are decoded in bulk (vilma_tpu_torch.io.plink), block
membership is one searchsorted over every variant, and the monomorphic
screen is one vectorized nanstd, all on the host. Each block's
NaN-aware correlation is the JAX package's four-GEMM form in float64 on
`--device` (the card by default), at every block size: the JAX package
sends blocks under 128 SNPs through pandas.DataFrame.corr instead, which
agrees with the GEMM form to ~1e-13. The truncation is torch.linalg.eigh
in float64 with lowrank.factor_block's threshold rules.
"""
import logging
import os
import warnings
from pathlib import Path

import numpy as np
import torch

from vilma_tpu_torch.commands import resolve_device
from vilma_tpu_torch.io import plink


def args(super_parser):
    parser = super_parser.add_parser(
        'make_ld_schema',
        description='Build a block diagonal LD matrix from genotype data '
                    'and store it in vilma format.',
        usage='vilma-tpu-torch make_ld_schema <options>',
    )
    parser.add_argument('-o', '--out-root', required=True, type=str,
                        help='Path for output schema')
    parser.add_argument('-b', '--block-file', required=True, type=str,
                        help='Bed file containing LD block boundaries')
    parser.add_argument('-p', '--plink-file-list', required=True, type=str,
                        help='A file where each line is the basename of '
                             'plink format genotype data for a single '
                             'chromosome.')
    parser.add_argument('--extract', required=False, type=str, default='',
                        help='A file with a column ID that specifies which '
                             'SNPs to keep. Defaults to all variants.')
    parser.add_argument('--ldthresh', required=False, type=float, default=-1,
                        help='Threshold for computing SVD. Negative: no '
                             'SVD. In [0, 1]: setting x guarantees SNPs '
                             'with r^2 > x stay linearly independent in '
                             'the decomposition.')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='Where the correlations and their '
                             'eigendecompositions run (float64). cuda '
                             '(default) fails if no CUDA device is '
                             'present.')
    return parser


def get_ld_blocks(bedfile_name):
    """Per-chromosome LD block boundaries from a UCSC-style bed file:
    {chrom: (starts, ends)} sorted by end. Text after '#' is a comment;
    overlapping intervals are rejected."""
    table = {}
    with open(bedfile_name) as fh:
        for line in fh:
            fields = line.split('#', 1)[0].split()
            if not fields:
                continue
            if len(fields) != 3:
                raise ValueError(f'{bedfile_name}: expected chrom, start '
                                 f'and end, got {line!r}')
            table.setdefault(fields[0], []).append((int(fields[1]),
                                                    int(fields[2])))
    per_chrom = {}
    for chrom, rows in table.items():
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[np.argsort(rows[:, 1], kind='stable')]
        starts, ends = rows[:, 0], rows[:, 1]
        if np.any(starts[1:] < ends[:-1]):
            raise ValueError('The LD-block bed file has overlapping '
                             'intervals.')
        per_chrom[chrom] = (starts, ends)
    return per_chrom


def nan_corr(genos, device):
    """NaN-aware pairwise correlation [snps x snps] of a [samples, snps]
    float block (NaN = missing) in float64 on `device`: each pair uses
    exactly the samples observed for both SNPs (the
    pandas.DataFrame.corr contract), from four GEMMs over the validity
    mask V and the zero-filled genotypes A:

        n = V.T @ V, Sx = A.T @ V, Sxx = (A*A).T @ V, Sxy = A.T @ A
    """
    g = torch.as_tensor(np.asarray(genos, dtype=np.float64), device=device)
    valid = ~torch.isnan(g)
    v = valid.to(torch.float64)
    a = torch.where(valid, g, torch.zeros_like(g))
    n = v.T @ v
    sx = a.T @ v
    sxx = (a * a).T @ v
    sxy = a.T @ a
    cov = sxy - sx * sx.T / n
    var_x = sxx - sx * sx / n
    corr = cov / torch.sqrt(var_x * var_x.T)
    return torch.where(n < 2, torch.full_like(corr, float('nan')), corr)


def truncate(corr, t):
    """lowrank.factor_block(X=corr, t) on a float64 tensor: keep the
    eigenvalues >= 1 - sqrt(t), then those > 1e-12 x the largest, with
    the rank-0 sentinel where none survive. Returns the stacked [U; s]
    as float64 numpy."""
    s_vals, vecs = torch.linalg.eigh(corr)
    s_vals, vecs = s_vals.cpu().numpy(), vecs.cpu().numpy()
    keep = s_vals >= 1 - np.sqrt(t)
    if not np.any(keep):
        u, s = np.ones((corr.shape[0], 1)), np.zeros(1)
    else:
        u, s = vecs[:, keep], s_vals[keep]
    keep = s > 1e-12 * (np.max(s) if s.size else 0.0)
    if keep.sum() > 0:
        u, s = u[:, keep], s[keep]
    else:
        u, s = u[:, :1], np.zeros(1)
    return np.vstack([u, s.reshape((1, -1))])


def assign_to_blocks(blocks, plink_data, variants=None):
    """Partition a chromosome's SNPs into LD blocks, vectorized.

    Returns {'<chrom> <block_idx>': {'SNPs': [samples, n_b] float array,
    'IDs': [[name, chrom, bp, cm, a1, a2], ...]}} in genome order. Drops
    SNPs outside every block, not in `variants` (when given),
    monomorphic or all-missing; genotype codes > 2.1 (the missing
    sentinel) become NaN. One chromosome per plink file, and it must
    appear in the bed file (JAX package semantics)."""
    loci = plink_data.get_loci()
    if not loci:
        return {}
    chroms = np.asarray([str(lo.chromosome) for lo in loci])
    chromosome = chroms[0]
    if chromosome not in blocks:
        raise ValueError('A plink file references a chromosome absent '
                         'from the LD-block bed file.')
    if np.any(chroms != chromosome):
        raise ValueError('Expected a single chromosome per plink '
                         'file; this one mixes several.')

    bp = np.asarray([lo.bp_position for lo in loci], dtype=np.int64)
    starts, ends = blocks[chromosome]
    block_idx = np.searchsorted(starts, bp - 1, side='right') - 1
    in_block = block_idx >= 0
    in_block[in_block] &= bp[in_block] <= ends[block_idx[in_block]]

    keep = in_block
    if variants:
        names = np.asarray([lo.name for lo in loci], dtype=object)
        keep = keep & np.isin(names, list(variants))
    keep_rows = np.flatnonzero(keep)
    if keep_rows.size == 0:
        return {}

    genos = np.asarray(plink_data._genotypes[keep_rows], dtype=float)
    genos[genos > 2.1] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # all-NaN rows
        spread = np.nanstd(genos, axis=1)
    polymorphic = ~np.isnan(spread) & (spread != 0)
    keep_rows = keep_rows[polymorphic]
    genos = genos[polymorphic]

    kept_idx = block_idx[keep_rows]
    _, first = np.unique(kept_idx, return_index=True)
    out = {}
    for b in kept_idx[np.sort(first)]:
        members = kept_idx == b
        ids = [[loci[i].name, chromosome, loci[i].bp_position,
                loci[i].position, loci[i].allele1, loci[i].allele2]
               for i in keep_rows[members]]
        out['{} {}'.format(chromosome, b)] = {
            'SNPs': genos[members].T,        # samples x snps
            'IDs': ids,
        }
    return out


def write_block(out_root, key, payload, ldthresh, device):
    """Write one block's .npy and .var; return its manifest line."""
    chrom, idx = key.split()
    tag = '{}_{}:{}'.format(out_root, chrom, idx)
    corr = nan_corr(payload['SNPs'], device)
    if ldthresh >= 0:
        stored = truncate(corr, ldthresh)
    else:
        stored = corr.cpu().numpy()
    np.save(tag, stored)
    with open(tag + '.var', 'w') as var_file:
        var_file.write(''.join('\t'.join(map(str, row)) + '\n'
                               for row in payload['IDs']))
    base = os.path.basename(tag)
    return '{}.var\t{}.npy'.format(base, base)


def load_extract_set(extract_path):
    """The ID column of a whitespace-separated file with a header."""
    with open(extract_path) as fh:
        rows = [line.split() for line in fh if line.strip()]
    if not rows or 'ID' not in rows[0]:
        raise ValueError('The extract file ' + extract_path
                         + ' has no ID column.')
    j = rows[0].index('ID')
    return {r[j] for r in rows[1:]}


def main(args):
    device = resolve_device(args.device)
    logging.info('Reading LD blocks from %s', args.block_file)
    ld_blocks = get_ld_blocks(args.block_file)

    variants = None
    if args.extract:
        logging.info('Loading Variants from %s', args.extract)
        variants = load_extract_set(args.extract)

    if os.path.exists(args.out_root + '.schema'):
        raise ValueError('Refusing to overwrite the existing manifest '
                         + args.out_root + '.schema; delete it first.')

    list_path = Path(args.plink_file_list)
    with open(list_path, 'r') as manifest:
        basenames = [line.strip() for line in manifest if line.strip()]
    for file_num, basename in enumerate(basenames, start=1):
        logging.info('Working on plink file %d', file_num)
        plink_data = plink.open_plink(str(Path(list_path.parents[0],
                                               basename)))
        logging.info('...assigning SNPs to blocks')
        blocked = assign_to_blocks(ld_blocks, plink_data, variants)
        logging.info('...processing LD blocks')
        manifest_lines = []
        for key, payload in blocked.items():
            logging.info('...computing correlations for block %s', key)
            manifest_lines.append(write_block(args.out_root, key, payload,
                                              args.ldthresh, device))
        with open(args.out_root + '.schema', 'a') as schema_file:
            schema_file.write('\n'.join(manifest_lines) + '\n')
    logging.info('Done!')
