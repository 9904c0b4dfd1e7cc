"""The `check_ld_schema` command: inspect and analyze LD schemas.

Port of vilma_tpu/commands/check_ld_schema.py with the same flags, plus
--device: `--listvars` writes every variant the schema lists, and
`--trace` how much of the LD matrix's diagonal a low-rank approximation
keeps (in all and, with --trace-annotations, per annotation), the
diagnostic for choosing `--ldthresh`.

The LD is packed in float64 on --device; ops/blocks.diag reduces its
diagonal over the rank in one fixed order, so the card and the host
write the same text.
"""
import logging

import numpy as np

from vilma_tpu_torch.commands import resolve_device
from vilma_tpu_torch.io import load
from vilma_tpu_torch.ops import blocks


def args(super_parser):
    parser = super_parser.add_parser(
        'check_ld_schema',
        description='Utilities for analyzing LD schema.',
        usage='vilma-tpu-torch check_ld_schema <options>',
    )
    parser.add_argument('--listvars', required=False, type=str, default='',
                        help='Path at which to print a list of all variants '
                             'present in this schema.')
    parser.add_argument('--trace', required=False, type=str, default='',
                        help='Path at which to print information about the '
                             'trace of the low rank approximation of the LD '
                             'matrix relative to its size.')
    parser.add_argument('--trace-ldthresh', required=False, type=float,
                        default=1.,
                        help='Threshold for singular value approximation of '
                             'LD matrix used when computing the trace.')
    parser.add_argument('--trace-annotations', required=False, type=str,
                        default='',
                        help='Path to an annotations file; if provided the '
                             'trace is also reported per annotation.')
    parser.add_argument('--ld-schema', required=True, type=str,
                        help='Path to LD panel schema.')
    parser.add_argument('--trace-mmap', dest='mmap', action='store_true',
                        help='Accepted for compatibility and ignored (see fit '
                             '--mmap).')
    parser.add_argument('--trace-extract', required=False, type=str,
                        default='',
                        help='List of SNPs to include in trace analysis, '
                             'with ID, A1, and A2 columns.')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='Where the LD is packed and its diagonal '
                             'reduced (float64). cuda (default) fails if '
                             'no CUDA device is present.')
    return parser


def compute_trace(block_ld_mat, one_hot_annotations):
    """Trace of the (approximated) LD matrix, in all and per annotation.

    A full-fidelity LD correlation matrix has trace == number of
    non-missing SNPs, so `ratio` is the fraction of the signal the
    low-rank truncation kept (reference check_ld_schema.py:72-123).
    Rows: 'all_snps', then one 'annotation_<j>' row per annotation
    column when there are several."""
    one_hot_annotations = np.asarray(one_hot_annotations)
    if not np.all(one_hot_annotations.sum(axis=1) == 1):
        raise ValueError('Annotation rows must be one-hot (exactly one '
                         '1 per row).')
    ld_diags = blocks.diag(block_ld_mat).cpu().numpy()
    present = np.ones(ld_diags.shape[0])
    present[list(block_ld_mat.missing)] = 0.

    labels = ['all_snps']
    traces = [ld_diags.sum()]
    counts = [present.sum()]
    num_annot = one_hot_annotations.shape[1]
    if num_annot > 1:
        labels += ['annotation_' + str(j) for j in range(num_annot)]
        traces += list(ld_diags @ one_hot_annotations)
        counts += list(present @ one_hot_annotations)
    traces = np.asarray(traces)
    counts = np.asarray(counts)
    return load.Table([('annotation', np.array(labels, dtype=object)),
                       ('trace', traces), ('num_snps', counts),
                       ('ratio', traces / counts)])


def combine_vars(ld_schema):
    """Every .var file of a schema as one variant table (reference
    check_ld_schema.py:126-144)."""
    return load.read_var_table(
        var_path for var_path, _ in load.schema_iterator(ld_schema))


def _validate(args):
    if args.trace_annotations and not args.trace:
        raise ValueError('--trace-annotations only makes sense '
                         'together with --trace.')
    if args.trace_ldthresh != 1 and not args.trace:
        raise ValueError('--trace-ldthresh only makes sense together '
                         'with --trace.')
    if not args.trace and not args.listvars:
        raise ValueError('Nothing to do: pass --trace and/or '
                         '--listvars.')


def _run_trace(args, all_vars, device):
    logging.info('Computing trace statistics.')
    variants = (load.load_variant_list(args.trace_extract)
                if args.trace_extract else all_vars.copy())
    for col in ('ID', 'A1', 'A2'):
        # the loaders match IDs and alleles as text
        variants[col] = np.array([str(v) for v in variants[col]],
                                 dtype=object)
    annotations, denylist = load.load_annotations(args.trace_annotations,
                                                  variants)
    ld_mat, _ = load.load_ld_from_schema(
        args.ld_schema, variants=variants, denylist=denylist,
        ldthresh=args.trace_ldthresh, device=device)
    compute_trace(ld_mat, annotations).to_tsv(args.trace)


def main(args):
    _validate(args)
    device = resolve_device(args.device)
    logging.info('Collecting list of variants in LD Schema.')
    all_vars = combine_vars(args.ld_schema)
    if args.trace:
        _run_trace(args, all_vars, device)
    if args.listvars:
        logging.info('Saving list of variants')
        all_vars.to_tsv(args.listvars)
