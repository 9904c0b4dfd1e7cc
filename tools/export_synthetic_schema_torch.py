"""Export bench's synthetic genome as an on-disk LD schema + sumstats.

The twin of tools/export_synthetic_schema.py on the PyTorch port: the
same argv (out_dir [num_loci]) and the same files, named and formatted
alike: stacked-eigendecomposition `.npy` blocks (rows [eigenvectors;
eigenvalues], float32), `.var` variant files, a `.schema` manifest, one
sumstats TSV per cohort and an extract list, so that the production CLI
(`vilma-tpu-torch fit`) can be driven end to end at genome scale:

    python tools/export_synthetic_schema_torch.py /tmp/demo 1000000
    python -m vilma_tpu_torch.frontend fit \\
        --sumstats /tmp/demo/pop1.sumstats.tsv,/tmp/demo/pop2.sumstats.tsv \\
        --ld-schema /tmp/demo/schema.schema,/tmp/demo/schema.schema \\
        --extract /tmp/demo/extract.tsv --names pop1,pop2 \\
        --samplesizes 1e5,1e5 --init-hg 0.3,0.3 -K 2 --seed 42 \\
        --precision f32 --ld-precision bf16 --num-its 30 \\
        --output /tmp/demo/run --logfile -

The factors are bench.py's AR(1) blocks of 1024 SNPs at half rank. They
come from bench.py's factor archive (`.bench_cache/ld_{n}_1024_0.5.npz`
beside `tools/`) where one exists, else from
vilma_tpu_torch.utils.synthetic's factoring of the same problem: on the
card by default (batched float64 eigh), on the host with `--device cpu`
(numpy's eigh, the bits the archive holds). Blocks are written one at a
time, so host memory stays bounded at 6M SNPs.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BLOCK_SIZE = 1024
RANK_FRAC = 0.5


def _archive_factors(path):
    """(variant indices, U, s) of each block of a bench.py archive."""
    with np.load(path) as z:
        for b in range(int(z['num_blocks'])):
            yield z[f'ix{b}'], z[f'u{b}'], z[f's{b}']


def _synthetic_factors(num_loci, device):
    from vilma_tpu_torch.utils import synthetic
    for ix, f in synthetic.synthetic_factors(num_loci, BLOCK_SIZE,
                                             RANK_FRAC, seed=0,
                                             device=device):
        yield ix, f.u, f.s


def _write_rows(path, header, rows, chunk=1 << 16):
    """Write `header` and then the text lines of `rows`, in chunks."""
    with open(path, 'w') as fh:
        fh.write(header)
        batch = []
        for line in rows:
            batch.append(line)
            if len(batch) == chunk:
                fh.write(''.join(batch))
                batch.clear()
        fh.write(''.join(batch))


def export(out_dir, num_loci=100_000, num_pops=2, seed=1, device=None):
    """Write the schema, sumstats and extract list for `num_loci` SNPs
    into `out_dir`. Returns (blocks written, bytes written, the factors'
    source: 'archive' or the device that factored them)."""
    archive = os.path.join(REPO, '.bench_cache',
                           f'ld_{num_loci}_{BLOCK_SIZE}_{RANK_FRAC}.npz')
    if os.path.exists(archive):
        factors, source = _archive_factors(archive), 'archive'
    else:
        from vilma_tpu_torch.inference import engine
        device = engine.resolve_device(device)
        factors, source = _synthetic_factors(num_loci, device), str(device)
    os.makedirs(out_dir, exist_ok=True)

    manifest = []
    for b, (ix, u, s) in enumerate(factors):
        base = f'schema_1:{b}'
        # stacked eigendecomposition layout: (n+1) x k, last row = s, in
        # C order as bench.py's archive holds U
        np.save(os.path.join(out_dir, base + '.npy'),
                np.vstack([np.ascontiguousarray(u),
                           s[None, :]]).astype(np.float32))
        _write_rows(os.path.join(out_dir, base + '.var'), '',
                    (f'snp{i}\t1\t{i}\t0.0\tA\tG\n' for i in ix.tolist()))
        manifest.append(f'{base}.var\t{base}.npy')
    with open(os.path.join(out_dir, 'schema.schema'), 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')

    # the JAX tool's draws: bench._build's marginal effects
    rng = np.random.default_rng(seed)
    std_errs = rng.uniform(0.01, 0.05, (num_pops, num_loci))
    betas = rng.standard_normal((num_pops, num_loci)) * std_errs * 2
    for p in range(num_pops):
        _write_rows(
            os.path.join(out_dir, f'pop{p + 1}.sumstats.tsv'),
            'ID\tA1\tA2\tBETA\tSE\n',
            (f'snp{i}\tA\tG\t{b:.6e}\t{s:.6e}\n' for i, (b, s) in
             enumerate(zip(betas[p].tolist(), std_errs[p].tolist()))))
    _write_rows(os.path.join(out_dir, 'extract.tsv'), 'ID\tA1\tA2\n',
                (f'snp{i}\tA\tG\n' for i in range(num_loci)))
    nbytes = sum(e.stat().st_size for e in os.scandir(out_dir)
                 if e.is_file())
    return len(manifest), nbytes, source


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('out_dir', nargs='?', default='/tmp/vilma_tpu_demo')
    parser.add_argument('num_loci', nargs='?', type=int, default=100_000)
    parser.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                        help='where the factors are computed when no '
                             'bench.py archive exists (default: the card)')
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    nb, nbytes, source = export(args.out_dir, args.num_loci,
                                device=args.device)
    print(f'wrote {nb} blocks + 2 sumstats for {args.num_loci} SNPs to '
          f'{args.out_dir}: {nbytes} bytes in '
          f'{time.perf_counter() - t0:.1f} s (factors: {source})')


if __name__ == '__main__':
    main()
