"""Loading and matching of GWAS summary stats, annotations, and LD.

Port of vilma_tpu/io/load.py without pandas: whitespace-separated tables
are parsed with the standard library and numpy, with the same column
rules, allele flip/mismatch detection and missing-data semantics as the
reference (reference load.py:21-354). LD blocks are packed into the
port's device tensors (vilma_tpu_torch.ops.blocks).

Not ported: --mmap disk staging and the --factor-cache memo (ROADMAP
queue 1, "Bounded-memory I/O"). The JAX package's mmap mode also takes
two draws of the global numpy RNG per loaded block; `rng_draws=True`
takes those draws alone (`sim` needs them for its seeded outputs).
"""
import logging
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from vilma_tpu_torch.ops import blocks as blocks_mod
from vilma_tpu_torch.ops import lowrank


class Table:
    """A small column table: ordered name -> 1-D numpy array, all of one
    length (the subset of a pandas DataFrame the loaders and `fit` use)."""

    def __init__(self, columns):
        self.columns = OrderedDict(columns)

    def __getitem__(self, name):
        return self.columns[name]

    def __setitem__(self, name, values):
        self.columns[name] = np.asarray(values)

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def take(self, rows):
        """The table's rows `rows` (an index array or a boolean mask)."""
        return Table((n, v[rows]) for n, v in self.columns.items())

    def copy(self):
        return self.take(slice(None))

    def to_tsv(self, path):
        """Write a tab-separated file with a header row (pandas
        to_csv(sep='\\t', index=False) layout)."""
        names = list(self.columns)
        cols = [[str(v) for v in self.columns[n]] for n in names]
        with open(path, 'w') as fh:
            fh.write('\t'.join(names) + '\n')
            for row in zip(*cols):
                fh.write('\t'.join(row) + '\n')


def _read_table(path, header=True, names=None):
    """Whitespace-separated text -> (column names, list of row tuples)."""
    with open(path) as fh:
        rows = [line.split() for line in fh if line.strip()]
    if header:
        names, rows = rows[0], rows[1:]
    width = len(names)
    for r in rows:
        if len(r) != width:
            raise ValueError(f'{path}: a row has {len(r)} fields, the '
                             f'header {width}')
    return list(names), rows


def _floats(values):
    """Parse numbers as pandas does: unparseable fields are NaN."""
    out = np.empty(len(values))
    for j, v in enumerate(values):
        try:
            out[j] = float(v)
        except ValueError:
            out[j] = np.nan
    return out


def _str_array(values):
    return np.array(values, dtype=object)


def _typed(values):
    """(kind, array) of a text column, typed as pandas.read_csv infers
    it: 'int' when every field parses as an integer, 'float' when every
    field parses as a number, else 'str'."""
    try:
        return 'int', np.array([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return 'float', np.array([float(v) for v in values])
    except ValueError:
        return 'str', _str_array(values)


def concat_columns(parts):
    """pandas.concat of typed columns ((kind, array) pairs): int stays
    int, int with float becomes float, and anything with text becomes an
    object column whose values keep their own types."""
    kinds = {k for k, _ in parts}
    if kinds <= {'int'}:
        return np.concatenate([a for _, a in parts]).astype(np.int64)
    if kinds <= {'int', 'float'}:
        return np.concatenate([a.astype(np.float64) for _, a in parts])
    out = []
    for kind, a in parts:
        out.extend(int(v) if kind == 'int' else float(v) if kind == 'float'
                   else v for v in a)
    return _str_array(out)


def concat_tables(tables):
    """Row-wise concatenation of tables with the same columns."""
    names = list(tables[0].columns)
    return Table((n, np.concatenate([t[n] for t in tables]))
                 for n in names)


def read_var_table(var_paths):
    """The .var files of a schema as one typed table (columns ID, CHROM,
    BP, CM, A1, A2), each column typed as pandas.read_csv followed by
    pandas.concat types it: an integer-valued CM column stays int and
    prints as `0`, a fractional one prints as `0.0`."""
    names = ['ID', 'CHROM', 'BP', 'CM', 'A1', 'A2']
    parts = {n: [] for n in names}
    for path in var_paths:
        _, rows = _read_table(path, header=False, names=names)
        if not rows:
            continue
        for j, n in enumerate(names):
            parts[n].append(_typed([r[j] for r in rows]))
    if not parts['ID']:
        return Table((n, _str_array([])) for n in names)
    return Table((n, concat_columns(parts[n])) for n in names)


def load_variant_list(variant_filename):
    """Read the analysis variant list (reference load.py:21-39): ID and
    A1 columns; A2 given directly or derived from REF/ALT (A2 = REF
    unless A1 == REF, then ALT). Duplicate rows are dropped."""
    names, rows = _read_table(variant_filename)
    rows = list(OrderedDict.fromkeys(tuple(r) for r in rows))
    if 'ID' not in names:
        raise ValueError('The variant list has no ID column.')
    if 'A1' not in names:
        raise ValueError('The variant list has no A1 column.')
    col = {n: _str_array([r[j] for r in rows]) for j, n in enumerate(names)}
    if 'A2' not in names:
        if 'REF' not in names or 'ALT' not in names:
            raise ValueError('The variant list needs an A2 column (or '
                             'REF and ALT columns to derive one).')
        col['A2'] = np.where(col['A1'] == col['REF'], col['ALT'],
                             col['REF'])
    return Table([('ID', col['ID']), ('A1', col['A1']), ('A2', col['A2'])])


def load_annotations(annotations_filename, variants):
    """One-hot annotations matched to `variants` (reference load.py:42-68).

    Returns (one_hot [num_variants, num_annotations], denylist) where
    denylist holds the unannotated variants (given annotation 0 in the
    one-hot matrix but excluded from LD)."""
    if not annotations_filename:
        return np.ones((len(variants), 1)), []
    names, rows = _read_table(annotations_filename)
    if 'ID' not in names:
        raise ValueError('The annotation file has no ID column.')
    if 'ANNOTATION' not in names:
        raise ValueError('The annotation file has no ANNOTATION column.')
    id_j, ann_j = names.index('ID'), names.index('ANNOTATION')
    by_id = {}
    for r in rows:
        by_id.setdefault(r[id_j], r[ann_j])
    raw = [by_id.get(v) for v in variants['ID']]
    denylist = [j for j, v in enumerate(raw) if v is None]
    if denylist:
        logging.warning('No annotation found for %d of %d variants; '
                        'assigning them the first annotation category.',
                        len(denylist), len(raw))
    present = [v for v in raw if v is not None]
    numeric = not np.isnan(_floats(present)).any()
    if numeric:
        values = [0.0 if v is None else float(v) for v in raw]
    else:
        values = ['0' if v is None else v for v in raw]
    levels = sorted(set(values))
    index = {lv: j for j, lv in enumerate(levels)}
    one_hot = np.zeros((len(values), len(levels)))
    one_hot[np.arange(len(values)), [index[v] for v in values]] = 1.0
    return one_hot, denylist


def load_sumstats(sumstats_filename, variants):
    """GWAS summary statistics matched to `variants`
    (reference load.py:71-139).

    OR -> log(OR); allele flips change the BETA sign; missing or
    mismatched rows get BETA=0, SE=1 and are listed in the returned
    missing list. Returns (Table with BETA and SE, missing)."""
    names, rows = _read_table(sumstats_filename)
    if 'ID' not in names:
        raise ValueError('The summary statistics file has no ID column.')
    if 'A1' not in names:
        raise ValueError('The summary statistics file has no A1 column.')
    if 'A2' not in names and ('REF' not in names or 'ALT' not in names):
        raise ValueError('The summary statistics file needs an A2 '
                         'column (or REF and ALT columns to derive '
                         'one).')
    if 'SE' not in names:
        raise ValueError('The summary statistics file has no SE column.')
    if 'BETA' not in names and 'OR' not in names:
        raise ValueError('The summary statistics file needs an '
                         'effect-size column: either BETA or OR.')
    j = {n: names.index(n) for n in names}
    by_id = {}
    for r in rows:
        by_id.setdefault(r[j['ID']], r)

    n = len(variants)
    beta = np.full(n, np.nan)
    se = np.full(n, np.nan)
    a1 = _str_array([None] * n)
    a2 = _str_array([None] * n)
    for i, vid in enumerate(variants['ID']):
        r = by_id.get(vid)
        if r is None:
            continue
        a1[i] = r[j['A1']]
        if 'A2' in j:
            a2[i] = r[j['A2']]
        else:
            ref, alt = r[j['REF']], r[j['ALT']]
            a2[i] = alt if a1[i] == ref else ref
        if 'BETA' in j:
            beta[i] = _floats([r[j['BETA']]])[0]
        else:
            with np.errstate(divide='ignore', invalid='ignore'):
                beta[i] = np.log(_floats([r[j['OR']]])[0])
        se[i] = _floats([r[j['SE']]])[0]

    stay = (variants['A1'] == a1) & (variants['A2'] == a2)
    flip = (variants['A1'] == a2) & (a1 == variants['A2'])
    missing = np.isnan(beta) | np.isnan(se) | (~stay & ~flip)
    logging.warning('No usable summary statistics for %d of %d variants.',
                    int(missing.sum()), n)
    logging.warning('Allele order flipped for %d variants.',
                    int(flip.sum()))
    beta[missing] = 0.
    se[missing] = 1.
    beta[flip] = -beta[flip]
    return (Table([('BETA', beta), ('SE', se)]),
            np.where(missing)[0].tolist())


def schema_iterator(schema_path):
    """Yield (.var path, .npy path) pairs from an LD schema manifest,
    resolving paths relative to the manifest (reference load.py:142-163)."""
    schema_path = Path(schema_path)
    with open(schema_path, 'r') as schema:
        for line in schema:
            snp_path, ld_path = line.split()
            yield (Path(schema_path.parents[0], snp_path),
                   Path(schema_path.parents[0], ld_path))


def load_ld_mat(ld_path, variant_indices=None, mismatch=None, signs=None):
    """Load one LD block .npy, subset/flip, return a dense matrix
    (reference load.py:166-234). Square arrays are dense LD; tall (n+1) x
    k arrays are a stacked eigendecomposition [eigenvectors; eigenvalues],
    reconstructed densely after row subsetting/sign flipping."""
    ld_matrix = np.load(ld_path)

    if signs is not None and not np.allclose(np.asarray(signs) ** 2, 1):
        raise ValueError('Every entry of the sign-flip vector must be '
                         '+1 or -1.')
    if len(ld_matrix.shape) == 0:
        return ld_matrix[None, None]

    num_snps = ld_matrix.shape[0]
    if ld_matrix.shape[0] > ld_matrix.shape[1]:
        num_snps -= 1
    if variant_indices is None:
        variant_indices = np.ones(num_snps, dtype=bool)
    if mismatch is None:
        mismatch = np.zeros(int(np.sum(variant_indices)), dtype=bool)
    if signs is None:
        signs = np.ones(num_snps)

    if ld_matrix.shape[0] == ld_matrix.shape[1]:
        if not np.allclose(ld_matrix, ld_matrix.T):
            raise ValueError('The LD matrix on disk is not symmetric.')
        accepted = np.copy(ld_matrix[np.ix_(variant_indices,
                                            variant_indices)])
        accepted = accepted * np.outer(signs, signs)
        return accepted[np.ix_(~mismatch, ~mismatch)]

    if ld_matrix.shape[0] < ld_matrix.shape[1]:
        raise ValueError('Unrecognized LD matrix layout: wider than tall.')

    num_snps = ld_matrix.shape[0] - 1
    if num_snps != variant_indices.shape[0]:
        raise ValueError('Stacked-eigendecomposition LD matrix row count '
                         'does not match its .var file.')
    u_mat = np.copy(ld_matrix[0:num_snps])
    s_vec = np.copy(ld_matrix[num_snps])
    u_mat = u_mat[variant_indices, :]
    u_mat = np.asarray(signs).reshape((-1, 1)) * u_mat
    u_mat = np.copy(u_mat[~mismatch])
    return (u_mat * s_vec).dot(u_mat.T)


def matched_schema_entries(schema_path, variants, denylist):
    """Metadata-only pass over a schema: which rows of each block survive
    variant matching, and with which allele-flip signs (reference
    load.py:269-329). Yields one dict per included manifest entry:
    {ld_path, variant_indices, mismatch, signs, idx, num_flipped}."""
    position = {}
    for j, vid in enumerate(variants['ID']):
        position.setdefault(vid, j)
    deny = set(int(d) for d in denylist)
    var_a1, var_a2 = variants['A1'], variants['A2']
    for snp_path, ld_path in schema_iterator(schema_path):
        _, rows = _read_table(snp_path, header=False,
                              names=['ID', 'CHROM', 'BP', 'CM', 'A1', 'A2'])
        logging.info('Reading LD block with %d variants.', len(rows))
        ids = [r[0] for r in rows]
        variant_indices = np.array([v in position for v in ids], dtype=bool)
        if not variant_indices.any():
            continue
        idx = np.array([position[v] for v in ids if v in position],
                       dtype=np.int64)
        keep = np.array([i not in deny for i in idx], dtype=bool)
        variant_indices[np.where(variant_indices)[0][~keep]] = False
        logging.info('Keeping %.4f of this block\'s variants.',
                     np.mean(variant_indices))
        idx = idx[keep]
        if len(idx) == 0:
            continue
        kept = [rows[j] for j in np.where(variant_indices)[0]]
        ld_a1 = _str_array([r[4] for r in kept])
        ld_a2 = _str_array([r[5] for r in kept])
        my_a1, my_a2 = var_a1[idx], var_a2[idx]
        stay = (my_a1 == ld_a1) & (my_a2 == ld_a2)
        flip = (my_a1 == ld_a2) & (my_a2 == ld_a1)
        mismatch = (~flip) & (~stay)
        if len(idx[~mismatch]) == 0:
            continue
        signs = np.ones(len(idx))
        signs[flip] = -1
        yield {
            'ld_path': ld_path,
            'variant_indices': variant_indices,
            'mismatch': mismatch,
            'signs': signs,
            'idx': idx[~mismatch],
            'num_flipped': int(flip.sum()),
        }


def load_entry_factor(entry, ldthresh):
    """Load one matched entry's .npy and eigendecompose it (the
    per-block O(n^3) load step)."""
    accepted = load_ld_mat(entry['ld_path'], entry['variant_indices'],
                           entry['mismatch'], entry['signs'])
    return lowrank.factor_block(X=accepted, t=ldthresh,
                                check_symmetric=False)


def consume_mmap_rng_draws(num_blocks=1):
    """Take the reference's two random-dataset-name draws per block.

    The reference's HDF5 spill path draws two random 100-character
    dataset names per block from the global numpy RNG (reference
    matrix_structures.py:31-35,120-135), which shifts every later seeded
    draw (all `sim` outputs: sim hardcodes mmap=True, reference
    sim.py:218-224)."""
    import string
    chars = list(string.ascii_letters + string.digits)
    for _ in range(num_blocks):
        np.random.choice(chars, size=100)
        np.random.choice(chars, size=100)


def load_ld_from_schema(schema_path, variants, denylist, ldthresh,
                        dtype=torch.float64, u_dtype=None, device='cpu',
                        rng_draws=False):
    """Load a block LD matrix from a schema, matched to `variants`
    (reference load.py:237-354). Returns (PackedLD ordered like
    `variants`, list of variant positions missing LD info). rng_draws
    takes the JAX package's mmap-mode RNG draws, two per loaded block
    (consume_mmap_rng_draws), without its disk spill."""
    factors, block_indices = [], []
    total_flipped = 0
    for entry in matched_schema_entries(schema_path, variants, denylist):
        total_flipped += entry['num_flipped']
        factors.append(load_entry_factor(entry, ldthresh))
        block_indices.append(entry['idx'])
        if rng_draws:
            consume_mmap_rng_draws()
    n = len(variants)
    packed = blocks_mod.pack(factors, block_indices, n, dtype=dtype,
                             u_dtype=u_dtype, device=device)
    missing = list(packed.missing)
    logging.info('Schema load complete: %d variants.', n)
    logging.warning('%d variants have no LD information and will be '
                    'treated as missing during optimization.', len(missing))
    logging.warning('Allele order flipped for %d variants while matching '
                    'LD blocks.', total_flipped)
    return packed, missing
