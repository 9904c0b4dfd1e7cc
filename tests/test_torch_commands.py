"""`make_ld_schema`, `check_ld_schema` and `sim` of vilma_tpu_torch
(--device cpu) against vilma_tpu on the same small inputs, and the
powered-matrix ops of the port's ops/blocks.py (matrix_power, dot_i,
to_dense) against the JAX package's.

The repo has no PLINK fixture, so the tests write their own .bed/.bim/
.fam files: two chromosomes of haplotype-copying genotypes with about 2%
missing calls, a monomorphic SNP, an all-missing SNP, SNPs outside
every block, and blocks under and over 128 SNPs (the JAX package sends
the former through pandas.DataFrame.corr and the port through the GEMM
form). No block's eigenvalue lies within 1e-6 of 1 - sqrt(0.8), the
--ldthresh 0.8 cut, so rounding cannot move a rank (asserted).

Tolerances: schema, .var, --listvars and the text columns of every
table byte for byte; dense correlations to 1e-12 absolute; eigenvalues
to 1e-10 relative and U diag(s) U^T to 1e-10 absolute (eigenvector signs
differ between LAPACK builds, so U itself is not compared); traces to
1e-12 relative; sim's true_beta bit for bit, BETA to 1e-10 and SE to
1e-12 of their scale (pandas parses floats up to an ulp away from
Python's float()); the powered-matrix ops to 1e-12.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from vilma_tpu import frontend as jfrontend
from vilma_tpu.io import plink as jplink
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.ops import lowrank as jlowrank
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.io import plink as tplink
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops import lowrank as tlowrank

from tests.test_torch_cli import _read_tsv, _write_case
from tests.torch_parity import ld_to_torch, t2n

NUM_SAMPLES = 60
THRESH = 0.8
# chromosome -> LD blocks (start, end] and SNP counts per block; a few
# SNPs fall between blocks and past the last one
LAYOUT = {'1': [(0, 10_000, 40), (10_000, 30_000, 150), (30_000, 40_000, 9)],
          '2': [(5_000, 9_000, 30), (9_000, 20_000, 135)]}


def _haplotype_genotypes(rng, num_snps):
    """[num_snps, samples] genotypes 0/1/2 of two haplotypes each, every
    SNP copying its neighbour's allele with probability 0.8."""
    freqs = rng.uniform(0.1, 0.5, num_snps)
    haps = np.empty((num_snps, 2 * NUM_SAMPLES), dtype=np.int8)
    haps[0] = rng.random(2 * NUM_SAMPLES) < freqs[0]
    for j in range(1, num_snps):
        fresh = rng.random(2 * NUM_SAMPLES) < freqs[j]
        copy = rng.random(2 * NUM_SAMPLES) < 0.8
        haps[j] = np.where(copy, haps[j - 1], fresh)
    return haps[:, :NUM_SAMPLES] + haps[:, NUM_SAMPLES:]


def _write_plink(root, seed=0):
    """PLINK files per chromosome, the plink list, the block bed file and
    an extract list; returns their paths and every SNP ID."""
    rng = np.random.default_rng(seed)
    basenames, all_ids, bed_lines = [], [], []
    for chrom, blocks in LAYOUT.items():
        bps = []
        for start, end, count in blocks:
            bed_lines.append(f'{chrom}\t{start}\t{end}')
            bps.extend(np.sort(rng.choice(np.arange(start + 1, end + 1),
                                          count, replace=False)))
        bps.extend([blocks[-1][1] + 50, blocks[-1][1] + 90])  # no block
        bps = np.array(sorted(bps))
        n = len(bps)
        genos = _haplotype_genotypes(rng, n)
        genos[rng.random(genos.shape) < 0.02] = 3          # missing calls
        genos[3] = 0                                       # monomorphic
        genos[7] = 3                                       # all missing
        base = os.path.join(root, f'chr{chrom}')
        tplink.encode_bed(base + '.bed', genos)
        ids = [f'rs{chrom}_{j}' for j in range(n)]
        alleles = rng.choice(['A', 'C', 'G', 'T'], (n, 2))
        with open(base + '.bim', 'w') as fh:
            for j in range(n):
                cm = round(bps[j] * 1e-6, 6)
                fh.write(f'{chrom}\t{ids[j]}\t{cm}\t{bps[j]}\t'
                         f'{alleles[j, 0]}\t{alleles[j, 1]}\n')
        with open(base + '.fam', 'w') as fh:
            fh.writelines(f'f{i} i{i} 0 0 0 -9\n' for i in range(NUM_SAMPLES))
        basenames.append(f'chr{chrom}')
        all_ids.extend(ids)
    plist = os.path.join(root, 'plink_list.txt')
    with open(plist, 'w') as fh:
        fh.write('\n'.join(basenames) + '\n')
    bed = os.path.join(root, 'blocks.bed')
    with open(bed, 'w') as fh:
        fh.write('# LD blocks\n' + '\n'.join(bed_lines[::-1]) + '\n')
    extract = os.path.join(root, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\tA1\n')
        fh.writelines(f'{i}\tA\n' for i in all_ids[::3])
    return plist, bed, extract, all_ids


def _make_both(root, ldthresh, extract=None, device='cpu'):
    plist, bed, ext, _ = _write_plink(root)
    roots = {}
    for pkg, main, dev in (('jax', jfrontend.main, []),
                           ('torch', tfrontend.main, ['--device', device])):
        os.makedirs(os.path.join(root, pkg), exist_ok=True)
        roots[pkg] = os.path.join(root, pkg, 'ld')
        argv = ['make_ld_schema', '-o', roots[pkg], '-b', bed, '-p', plist,
                '--ldthresh', str(ldthresh)] + dev
        if extract:
            argv += ['--extract', ext]
        main(argv)
    return roots


def _schema_files(root):
    with open(root + '.schema') as fh:
        text = fh.read()
    return text, [line.split() for line in text.splitlines() if line]


def test_plink_reader_matches_jax(tmp_path):
    plist, _, _, _ = _write_plink(str(tmp_path))
    for base in ('chr1', 'chr2'):
        path = os.path.join(str(tmp_path), base)
        j, t = jplink.open_plink(path), tplink.open_plink(path)
        assert t.num_samples == j.num_samples == NUM_SAMPLES
        assert t.get_loci() == [tplink.Locus(**vars(lo))
                                for lo in j.get_loci()]
        np.testing.assert_array_equal(t._genotypes, j._genotypes)
        assert set(np.unique(t._genotypes)) == {0, 1, 2, 3}


@pytest.mark.parametrize('ldthresh,extract', [(-1, False), (THRESH, False),
                                              (THRESH, True)])
def test_make_ld_schema_matches_jax(ldthresh, extract, tmp_path):
    roots = _make_both(str(tmp_path), ldthresh, extract)
    jtext, jentries = _schema_files(roots['jax'])
    ttext, tentries = _schema_files(roots['torch'])
    assert ttext == jtext
    sizes = []
    dirs = {pkg: os.path.dirname(r) for pkg, r in roots.items()}
    for var, npy in jentries:
        with open(os.path.join(dirs['jax'], var)) as fh:
            jvar = fh.read()
        with open(os.path.join(dirs['torch'], var)) as fh:
            assert fh.read() == jvar
        j = np.load(os.path.join(dirs['jax'], npy))
        t = np.load(os.path.join(dirs['torch'], npy))
        assert t.dtype == j.dtype == np.float64
        assert t.shape == j.shape, npy
        n = len(jvar.splitlines())
        sizes.append(n)
        if ldthresh < 0:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
            w = np.linalg.eigvalsh(j)
            assert np.min(np.abs(w - (1 - np.sqrt(THRESH)))) > 1e-6
            continue
        ju, js = j[:n], j[n]
        tu, ts = t[:n], t[n]
        np.testing.assert_allclose(ts, js, rtol=1e-10, atol=0)
        np.testing.assert_allclose((tu * ts) @ tu.T, (ju * js) @ ju.T,
                                   rtol=0, atol=1e-10)
    assert len(jentries) == 5
    if not extract:
        # the monomorphic, all-missing and off-block SNPs are gone, and
        # both sides of the 128-SNP pandas cut were built
        assert sum(sizes) < sum(c for b in LAYOUT.values() for *_, c in b)
        assert min(sizes) < 128 < max(sizes)


def test_make_ld_schema_refuses_to_overwrite(tmp_path):
    roots = _make_both(str(tmp_path), -1)
    plist, bed, _, _ = _write_plink(str(tmp_path))
    with pytest.raises(ValueError, match='Refusing to overwrite'):
        tfrontend.main(['make_ld_schema', '-o', roots['torch'], '-b', bed,
                        '-p', plist, '--device', 'cpu'])


def test_make_ld_schema_rejects_overlapping_blocks(tmp_path):
    plist, _, _, _ = _write_plink(str(tmp_path))
    bed = os.path.join(str(tmp_path), 'overlap.bed')
    with open(bed, 'w') as fh:
        fh.write('1\t0\t100\n1\t50\t200\n2\t0\t10\n')
    with pytest.raises(ValueError, match='overlapping'):
        tfrontend.main(['make_ld_schema', '-o', str(tmp_path / 'x'), '-b',
                        bed, '-p', plist, '--device', 'cpu'])


def _write_var_schema(root, cm_values):
    """A schema of two dense blocks whose .var files carry the given CM
    texts (one list per block), and an annotation file with one
    variant unannotated."""
    rng = np.random.default_rng(3)
    manifest, ids = [], []
    for b, cms in enumerate(cm_values):
        n = len(cms)
        lag = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        np.save(os.path.join(root, f'b{b}.npy'),
                rng.uniform(0.3, 0.9) ** lag)
        with open(os.path.join(root, f'b{b}.var'), 'w') as fh:
            for j, cm in enumerate(cms):
                ids.append(f'v{b}_{j}')
                fh.write(f'{ids[-1]}\t{b + 1}\t{1000 * b + j}\t{cm}\tA\tG\n')
        manifest.append(f'b{b}.var\tb{b}.npy')
    schema = os.path.join(root, 'v.schema')
    with open(schema, 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')
    annot = os.path.join(root, 'annot.tsv')
    with open(annot, 'w') as fh:
        fh.write('ID\tANNOTATION\n')
        fh.writelines(f'{v}\t{j % 3}\n' for j, v in enumerate(ids) if j != 4)
    extract = os.path.join(root, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.writelines(f'{v}\tA\tG\n' for v in ids[::2])
    return schema, annot, extract


CM_CASES = {
    'integer': [['0', '0', '1', '2'] * 5, ['3', '4', '4'] * 6],
    'fractional': [['0.0', '0.25', '1.5', '2.125'] * 5, ['3.0'] * 18],
    'mixed': [['0', '1', '2', '3'] * 5, ['3.5', '4.0', '4.25'] * 6],
}


@pytest.mark.parametrize('cms', sorted(CM_CASES))
@pytest.mark.parametrize('flags', [
    ['--trace', 'T'], ['--trace', 'T', '--trace-annotations', 'A'],
    ['--trace', 'T', '--trace-ldthresh', '0.8', '--trace-extract', 'E',
     '--trace-mmap']], ids=['trace', 'annotations', 'extract'])
def test_check_ld_schema_matches_jax(cms, flags, tmp_path):
    root = str(tmp_path)
    schema, annot, extract = _write_var_schema(root, CM_CASES[cms])
    outs = {}
    for pkg, main, dev in (('jax', jfrontend.main, []),
                           ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = {k: os.path.join(root, f'{pkg}.{k}')
                     for k in ('trace', 'vars')}
        argv = [{'T': outs[pkg]['trace'], 'A': annot,
                 'E': extract}.get(f, f) for f in flags]
        main(['check_ld_schema', '--ld-schema', schema, '--listvars',
              outs[pkg]['vars']] + argv + dev)
    with open(outs['jax']['vars']) as fh:
        jvars = fh.read()
    with open(outs['torch']['vars']) as fh:
        assert fh.read() == jvars
    assert ('\t0.0\t' in jvars) == (cms != 'integer')
    jh, jcols = _read_tsv(outs['jax']['trace'])
    th, tcols = _read_tsv(outs['torch']['trace'])
    assert th == jh == ['annotation', 'trace', 'num_snps', 'ratio']
    assert tcols['annotation'] == jcols['annotation']
    assert len(jcols['annotation']) == (4 if 'A' in flags else 1)
    assert tcols['num_snps'] == jcols['num_snps']
    for col in ('trace', 'ratio'):
        np.testing.assert_allclose(np.array(tcols[col], dtype=float),
                                   np.array(jcols[col], dtype=float),
                                   rtol=1e-12, atol=0)


def test_check_ld_schema_validates_flags(tmp_path):
    for argv, msg in ((['--trace-annotations', 'a'], 'only makes sense'),
                      (['--trace-ldthresh', '0.5'], 'only makes sense'),
                      ([], 'Nothing to do')):
        with pytest.raises(ValueError, match=msg):
            tfrontend.main(['check_ld_schema', '--ld-schema', 'x.schema',
                            '--device', 'cpu'] + argv)


def _sim_inputs(root, weights_kind):
    schema, paths, extract, annot = _write_case(root)
    rng = np.random.default_rng(8)
    covs = []
    for k in range(3):
        a = rng.standard_normal((2, 2))
        covs.append(10.0 ** (-4 + k) * (a @ a.T + np.eye(2)))
    cov_path = os.path.join(root, 'sim.covariance.pkl')
    with open(cov_path, 'wb') as fh:
        pickle.dump([np.array(covs)], fh)
    # categories 1-3 and the 0 the unannotated variant gets
    weights = rng.uniform(0.1, 1.0, (4, 3))
    weights /= weights.sum(axis=1, keepdims=True)
    wpath = os.path.join(root, 'w.' + weights_kind)
    if weights_kind == 'npy':
        np.save(wpath, weights)
    else:
        np.savez(wpath, hyper_delta=weights, vi_mu=np.zeros(1))
    return schema, paths, annot, cov_path, wpath


@pytest.mark.parametrize('weights_kind', ['npy', 'npz'])
@pytest.mark.parametrize('num_pops', [1, 2])
@pytest.mark.parametrize('fast', [False, True], ids=['default', 'fast'])
def test_sim_matches_jax(fast, num_pops, weights_kind, tmp_path):
    root = str(tmp_path)
    schema, paths, annot, cov_path, wpath = _sim_inputs(root, weights_kind)
    names = ['eur', 'afr'][:num_pops]
    outs = {}
    for pkg, main, dev in (('jax', jfrontend.main, []),
                           ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = os.path.join(root, pkg)
        main(['sim', '--sumstats', ','.join(paths[:num_pops]),
              '--covariance', cov_path, '--weights', wpath,
              '--annotations', annot, '--output', outs[pkg],
              '--names', ','.join(names),
              '--ld-schema', ','.join([schema] * num_pops),
              '--gwas-n-scaling', ','.join(['1.5', '0.5'][:num_pops]),
              '--seed', '3'] + (['--fast-rng'] if fast else []) + dev)
    for name in names:
        jh, jcols = _read_tsv(f'{outs["jax"]}.{name}.simgwas.tsv')
        th, tcols = _read_tsv(f'{outs["torch"]}.{name}.simgwas.tsv')
        assert th == jh == ['ID', 'A1', 'A2', 'SE', 'BETA', 'true_beta']
        for col in ('ID', 'A1', 'A2', 'true_beta'):
            assert tcols[col] == jcols[col], col
        # the missing sumstats row is dropped
        assert 0 < len(jcols['ID']) < 184
        for col, atol in (('SE', 1e-12), ('BETA', 1e-10)):
            j = np.array(jcols[col], dtype=float)
            np.testing.assert_allclose(np.array(tcols[col], dtype=float), j,
                                       rtol=0, atol=atol * np.abs(j).max(),
                                       err_msg=col)


def _permuted_ld(seed=2):
    """Factors of four blocks over 50 of 60 genome slots, in a shuffled
    genome order (10 slots missing), packed by both packages."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(60)
    factors, indices, start = [], [], 0
    for size in (7, 20, 9, 14):
        lag = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        mat = rng.uniform(0.3, 0.9) ** lag
        factors.append((mat, order[start:start + size]))
        start += size
    jld = jblocks.pack([jlowrank.factor_block(X=m, t=0.9)
                        for m, _ in factors], [ix for _, ix in factors], 60)
    tld = tblocks.pack([tlowrank.factor_block(X=m, t=0.9)
                        for m, _ in factors], [ix for _, ix in factors], 60)
    return jld, tld


@pytest.mark.parametrize('route', ['pack', 'convert'])
@pytest.mark.parametrize('power', [0.5, 2.0])
def test_matrix_power_matches_jax(route, power):
    jld, tld = _permuted_ld()
    if route == 'convert':
        tld = ld_to_torch(jld)
    x = np.random.default_rng(1).standard_normal(60)
    jp = jblocks.matrix_power(jld, power)
    tp = tblocks.matrix_power(tld, power)
    want = np.asarray(jblocks.dot(jp, x))
    got = t2n(tblocks.dot(tp, torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the powered matrix scatters to sequential offsets: the missing
    # slots sit at the end, not where the genome order has them
    assert np.all(got[50:] == 0) and np.any(got[list(tld.missing)] != 0)
    np.testing.assert_allclose(tblocks.to_dense(tp), jblocks.to_dense(jp),
                               rtol=0, atol=1e-12)


def test_matrix_power_refuses_diagonal():
    f = tlowrank.factor_block(u=np.eye(3)[:, :1], s=np.ones(1),
                              d=np.full(3, 0.5))
    ld = tblocks.pack([f], [np.arange(3)], 3)
    with pytest.raises(NotImplementedError, match='diagonal'):
        tblocks.matrix_power(ld, 0.5)


def test_dot_i_and_to_dense_match_jax():
    jld, tld = _permuted_ld()
    x = np.random.default_rng(4).standard_normal(60)
    for i in range(60):
        assert np.isclose(tblocks.dot_i(tld, torch.as_tensor(x), i),
                          jblocks.dot_i(jld, x, i), rtol=0, atol=1e-12)
    dense = tblocks.to_dense(tld)
    np.testing.assert_allclose(dense, jblocks.to_dense(jld), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dense @ x, t2n(tblocks.dot(
        tld, torch.as_tensor(x))), rtol=0, atol=1e-12)
