"""The benchmark's inputs, made from --seed: the GWAS summary statistics of
every cohort, the one-hot annotations and the LD panel's factors.

Every seed gets the same problem in another order. The problem is drawn
once from the configuration's `problem_seed`, and the run's seed draws
the order of the panel's full blocks along the genome (each block with
its SNPs' statistics and annotations). A fit's work (its line-search
trials, its EM events) depends on the problem: different problems of
the same sizes moved the steps a second by 7-9% (PERF.md), the same
problem in another order moves them by rounding alone.

Everything is drawn on the run's device by torch.Generators, in a few
large calls, so that set-up stays short:

* standard errors U(se_low, se_high) and effect sizes N(0, 1) * se *
  beta_scale, [P, I] each, in float64;
* one annotation category a SNP, uniform over `annotations` categories;
* the LD: AR(1) correlation blocks of `block_size` SNPs (rho_ij =
  rho^|i - j|, rho ~ U(rho_low, rho_high)) at `rank_frac` of their rank.
  Only a bank of `bank_blocks` distinct blocks is factored, by one batched
  float64 eigh on the device; the panel's full blocks take bank entries
  by a seeded draw, and a last, shorter block (the SNP count past the
  last full block) gets a factor of its own.

Both sides are handed the same inputs: the program packs the bank's
factors (as numpy arrays, one object per bank entry, repeated), and the
plain reference reads the same bank tensors.
"""
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Factor:
    """One factored LD block: u [n, r] and s [r] (float64), largest
    eigenvalue first."""
    u: torch.Tensor
    s: torch.Tensor


@dataclass
class Panel:
    """The LD panel: `bank` factors, `assign[b]` the bank entry of full
    block b (blocks of `block_size` SNPs from SNP 0 on), and `tail` the
    factor of the last, shorter block (None when the SNPs fill whole
    blocks)."""
    bank: list
    assign: torch.Tensor
    tail: Factor
    block_size: int
    num_snps: int

    def to(self, device):
        def mv(f):
            return Factor(u=f.u.to(device), s=f.s.to(device))
        return Panel(bank=[mv(f) for f in self.bank], assign=self.assign,
                     tail=mv(self.tail) if self.tail is not None else None,
                     block_size=self.block_size, num_snps=self.num_snps)

    @property
    def num_full(self):
        return int(self.assign.shape[0])


@dataclass
class Inputs:
    betas: torch.Tensor        # [P, I] float64
    std_errs: torch.Tensor     # [P, I] float64
    annotations: torch.Tensor  # [I] int64 category ids
    num_annotations: int
    panel: Panel

    def to(self, device):
        """The same inputs on `device`."""
        return Inputs(betas=self.betas.to(device),
                      std_errs=self.std_errs.to(device),
                      annotations=self.annotations.to(device),
                      num_annotations=self.num_annotations,
                      panel=self.panel.to(device))


def _ar1_factors(rhos, n, rank, device):
    """Factors of AR(1) blocks of n SNPs, one per rho: one batched
    float64 eigh, the top `rank` eigenpairs of each."""
    idx = torch.arange(n, device=device, dtype=torch.float64)
    lag = (idx[:, None] - idx[None, :]).abs()
    vals, vecs = torch.linalg.eigh(rhos[:, None, None] ** lag[None])
    # eigh sorts ascending; keep the largest `rank`, largest first
    vals = vals[:, -rank:].flip(-1).contiguous()
    vecs = vecs[:, :, -rank:].flip(-1).contiguous()
    return [Factor(u=vecs[b], s=vals[b]) for b in range(rhos.shape[0])]


def _rank(n, rank_frac):
    return max(1, int(n * rank_frac))


def make(config, traffic, seed, device):
    """The inputs of one run: `config` (the panel and the summary
    statistics' assumptions), `traffic` (the cohorts) and the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config['problem_seed']))
    f64 = dict(dtype=torch.float64, device=device)
    I = int(config['num_snps'])
    P = int(traffic['cohorts'])
    lo, hi = config['se_range']
    std_errs = lo + (hi - lo) * torch.rand((P, I), generator=gen, **f64)
    betas = (torch.randn((P, I), generator=gen, **f64) * std_errs
             * float(config['beta_scale']))
    A = int(config['annotations'])
    annotations = torch.randint(0, A, (I,), generator=gen, device=device)

    n = int(config['block_size'])
    nbank = int(config['bank_blocks'])
    r_lo, r_hi = config['rho_range']
    rhos = r_lo + (r_hi - r_lo) * torch.rand(nbank + 1, generator=gen, **f64)
    full, rest = divmod(I, n)
    assign = torch.randint(0, nbank, (full,), generator=gen, device=device)
    frac = float(config['rank_frac'])
    bank = _ar1_factors(rhos[:nbank], n, _rank(n, frac), device)
    tail = (_ar1_factors(rhos[nbank:], rest, _rank(rest, frac), device)[0]
            if rest else None)

    # the run's seed orders the full blocks; the shorter last block stays
    order = torch.Generator(device=device)
    order.manual_seed(int(seed))
    perm = torch.randperm(full, generator=order, device=device)
    snps = torch.cat([(perm[:, None] * n + torch.arange(
        n, device=device)[None]).reshape(-1),
        torch.arange(full * n, I, device=device)])
    panel = Panel(bank=bank, assign=assign[perm].cpu(), tail=tail,
                  block_size=n, num_snps=I)
    return Inputs(betas=betas[:, snps].contiguous(),
                  std_errs=std_errs[:, snps].contiguous(),
                  annotations=annotations[snps].contiguous(),
                  num_annotations=A, panel=panel)


def numpy_factors(panel):
    """The panel's factors as numpy float64 (u, s) pairs: one per bank
    entry, then the tail's."""
    out = [(f.u.cpu().numpy(), f.s.cpu().numpy()) for f in panel.bank]
    if panel.tail is not None:
        out.append((panel.tail.u.cpu().numpy(), panel.tail.s.cpu().numpy()))
    return out


def numpy_float(x):
    return x.detach().cpu().numpy().astype(np.float64)
