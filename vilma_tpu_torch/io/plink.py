"""PLINK 1.9 .bed/.bim/.fam reading, without pandas.

Port of vilma_tpu/io/plink.py: the .bim and .fam text files are parsed
here, and the 2-bit SNP-major genotype matrix is decoded by a copy of
its numpy decoder (_decode_bed_numpy).

Genotype convention (libplinkio's): 0 = hom first allele (bim allele1),
1 = het, 2 = hom second allele, 3 = missing; readers turn 3 into NaN
through `> 2.1`.
"""
from dataclasses import dataclass, field

import numpy as np

# bed 2-bit code -> genotype (00 -> 0, 01 -> 3 missing, 10 -> 1, 11 -> 2)
_CODE_TO_GENO = np.array([0, 3, 1, 2], dtype=np.int8)


@dataclass
class Locus:
    """One .bim row (libplinkio Locus field names)."""
    chromosome: str
    name: str
    position: float       # genetic distance (cM)
    bp_position: int
    allele1: str
    allele2: str


@dataclass
class PlinkFile:
    """An opened PLINK fileset: loci metadata and the decoded genotypes."""
    basename: str
    loci: list = field(default_factory=list)
    num_samples: int = 0
    _genotypes: np.ndarray = None   # [num_snps, num_samples] int8

    def get_loci(self):
        return self.loci

    def __iter__(self):
        return iter(self._genotypes)


def _rows(path, width=None):
    with open(path) as fh:
        rows = [line.split() for line in fh if line.strip()]
    if width is not None:
        for r in rows:
            if len(r) != width:
                raise ValueError(f'{path}: a row has {len(r)} fields, '
                                 f'expected {width}')
    return rows


def open_plink(basename):
    """Open basename{.bed,.bim,.fam}, decoding all genotypes. cM parses
    to a Python float and bp to an int, as in the JAX package."""
    basename = str(basename)
    bim = _rows(basename + '.bim', width=6)
    num_samples = len(_rows(basename + '.fam'))
    loci = [Locus(chromosome=chrom, name=name, position=float(cm),
                  bp_position=int(bp), allele1=a1, allele2=a2)
            for chrom, name, cm, bp, a1, a2 in bim]
    genotypes = decode_bed(basename + '.bed', num_samples, len(loci))
    return PlinkFile(basename=basename, loci=loci, num_samples=num_samples,
                     _genotypes=genotypes)


def decode_bed(bed_path, num_samples, num_snps):
    """Decode a SNP-major .bed into an int8 [num_snps, num_samples]."""
    raw = np.fromfile(bed_path, dtype=np.uint8)
    if raw.size < 3 or raw[0] != 0x6c or raw[1] != 0x1b or raw[2] != 0x01:
        raise ValueError(f'{bed_path} is not a SNP-major PLINK .bed file')
    bytes_per_snp = (num_samples + 3) // 4
    body = raw[3:]
    if body.size < bytes_per_snp * num_snps:
        raise ValueError(f'{bed_path} is truncated')
    body = body[:bytes_per_snp * num_snps].reshape(num_snps, bytes_per_snp)
    # expand 2-bit codes, little-endian within each byte
    codes = np.stack([(body >> shift) & 3 for shift in (0, 2, 4, 6)],
                     axis=-1).reshape(num_snps, -1)[:, :num_samples]
    return _CODE_TO_GENO[codes]


def encode_bed(bed_path, genotypes):
    """Write an int8 [num_snps, num_samples] genotype matrix (0, 1, 2;
    3 = missing) as a SNP-major .bed file (the inverse of decode_bed)."""
    geno_to_code = np.array([0, 2, 3, 1], dtype=np.uint8)
    codes = geno_to_code[np.asarray(genotypes, dtype=np.int64)]
    num_snps, num_samples = codes.shape
    pad = (-num_samples) % 4
    codes = np.pad(codes, ((0, 0), (0, pad))).reshape(num_snps, -1, 4)
    packed = (codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
              | (codes[..., 3] << 6)).astype(np.uint8)
    with open(bed_path, 'wb') as fh:
        fh.write(bytes([0x6c, 0x1b, 0x01]))
        fh.write(packed.tobytes())
