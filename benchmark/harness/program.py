"""The system under test: vilma_tpu_torch's production fit, built as
`vilma-tpu-torch fit` builds it, and the window that drives it.

`build` packs the panel with the port's public `ops/blocks.pack`, draws
the covariance grid with `models/mixture.py` as `fit` draws it (the
global numpy RNG seeded first, as `fit --seed` seeds it), and constructs
`inference.MultiPopVI` with the CLI's defaults: --seed 42 (the mix's
`fit_seed`), no checkpoints,
--num-its 1000 with the convergence test, --samplesizes 100e3,
--init-hg 0.1, the configuration's state type (float32, as
`--precision auto` gives on cuda) and U at its storage type.

`Steps` replaces `engine.outer_step`, the module attribute
`MultiPopVI.optimize` calls once a step, by a wrapper that counts steps,
marks their ends on the host clock, copies the program's states at the
steps the check reads to the host (held on the card they would add to
the memory peak of a later fit's start), and ends
`optimize` by raising `WindowClosed` at the first step end past the
window's length (or `WarmedUp` after the warm-up's steps).
"""
import time

import numpy as np
import torch

from harness import inputs as inputs_mod

TORCH_DTYPES = {'float64': torch.float64, 'float32': torch.float32,
                'bfloat16': torch.bfloat16}


class WindowClosed(Exception):
    """The window's first step end past its length."""


class WarmedUp(Exception):
    """The warm-up's last step."""


def _np_factors(panel):
    """lowrank.LowRankFactor objects of the panel's blocks: one per bank
    entry, repeated, in genome order; and each block's SNP indices."""
    from vilma_tpu_torch.ops import lowrank
    objs = [lowrank.LowRankFactor(u=u, s=s, d=np.zeros(u.shape[0]),
                                  rank=int(u.shape[1]))
            for u, s in inputs_mod.numpy_factors(panel)]
    bank, tail = objs[:len(panel.bank)], objs[len(panel.bank):]
    factors, indices = [], []
    for b, j in enumerate(panel.assign.tolist()):
        factors.append(bank[j])
        indices.append(np.arange(b * panel.block_size,
                                 (b + 1) * panel.block_size))
    if tail:
        start = panel.num_full * panel.block_size
        factors.append(tail[0])
        indices.append(np.arange(start, panel.num_snps))
    return factors, indices


class Fit:
    """The port's objects of one run, and the timings of their set-up."""

    def __init__(self, inp, config, traffic, seed, device, u_storage):
        from vilma_tpu_torch.inference import MultiPopVI
        from vilma_tpu_torch.models import mixture
        from vilma_tpu_torch.ops import blocks
        self.timings = {}
        # fit's main seeds the global RNG (--seed) before anything draws
        np.random.seed(int(traffic['fit_seed']))
        betas = inputs_mod.numpy_float(inp.betas)
        std_errs = inputs_mod.numpy_float(inp.std_errs)
        I = betas.shape[1]
        annotations = np.zeros((I, inp.num_annotations))
        annotations[np.arange(I), inp.annotations.cpu().numpy()] = 1.0
        factors, indices = _np_factors(inp.panel)

        dtype = TORCH_DTYPES[config['state_dtype']]
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        sync(device)
        t0 = time.perf_counter()
        self.ld = blocks.pack(factors, indices, I, dtype=dtype,
                              u_dtype=TORCH_DTYPES[u_storage],
                              device=device)
        sync(device)
        self.timings['pack_s'] = time.perf_counter() - t0

        P = int(traffic['cohorts'])
        K = int(traffic['components'])
        t0 = time.perf_counter()
        mins, maxes = mixture.effect_size_ranges(betas, std_errs, False)
        self.covs = mixture.make_simple(P, K, mins, maxes)
        # the cohorts read one panel: one loaded matrix, as fit shares it
        self.vi = MultiPopVI(
            marginal_effects=betas.astype(np_dtype),
            std_errs=std_errs.astype(np_dtype),
            ld_mats=[self.ld] * P,
            mixture_covs=self.covs,
            annotations=annotations,
            checkpoint=False,
            checkpoint_freq=-1,
            output='',
            scaled=False,
            scale_se=bool(traffic['learn_scaling']),
            gwas_N=np.full(P, float(traffic['samplesizes'])),
            init_hg=np.full(P, float(traffic['init_hg'])),
            num_its=int(traffic['num_its']),
            dtype=dtype,
            device=device,
        )
        sync(device)
        self.timings['model_build_s'] = time.perf_counter() - t0

    def shapes(self):
        """What the roofline counts read: the packed buckets' shapes and
        U's element size, and the fit's P, K, A, I."""
        data = self.vi.data
        return dict(
            buckets=[(bk.num_blocks, bk.pmax, bk.rmax, bk.u.element_size())
                     for bk in self.ld.buckets],
            P=int(data.marginal_effects.shape[0]),
            I=int(data.marginal_effects.shape[1]),
            K=int(data.mixture_prec.shape[0]),
            A=int(data.num_annotations))


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _counters():
    """The port's own counters: host syncs, and the launches of the
    hand-written kernels by kind."""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    la = compact_obj.launches
    return dict(
        host_syncs=engine.host_syncs,
        prologue=sum(v for k, v in la.items() if k.startswith('prologue')
                     and k != 'prologue_merge'),
        sums=sum(v for k, v in la.items() if k.startswith('delta_sums')),
        matvec=block_matvec.launches + block_matvec.launches_group)


class Steps:
    """The wrapper of engine.outer_step (see the module docstring)."""

    def __init__(self, device, trace=False):
        from vilma_tpu_torch.inference import engine
        self.engine = engine
        self.inner = engine.outer_step
        self.device = device
        self.trace = trace
        self.limit = None
        self.deadline = None
        self.records = []
        self.held = {}
        self.fit_steps = 0
        self.fits = 0

    def __enter__(self):
        self.engine.outer_step = self
        return self

    def __exit__(self, *exc):
        self.engine.outer_step = self.inner
        return False

    def warm_up(self, vi, steps):
        """optimize() from the initialization for `steps` steps."""
        self.limit = steps
        try:
            vi.optimize()
        except WarmedUp:
            pass
        self.limit = None

    def window(self, vi, seconds, rng_states):
        """Fits in a closed loop until the first step end past `seconds`;
        (steps, seconds) of the window. rng_states gets the global numpy
        RNG state each fit starts from."""
        self.records = []
        self.held = {}
        self.fits = 0
        sync(self.device)
        self.at_open = _counters()
        self.t_open = time.perf_counter()
        self.deadline = self.t_open + seconds
        try:
            while True:
                rng_states.append(np.random.get_state())
                self.fit_steps = 0
                vi.optimize()
                self.fits += 1
        except WindowClosed:
            pass
        self.deadline = None
        self.totals = {k: self.at_close[k] - self.at_open[k]
                       for k in self.at_open}
        return len(self.records), self.t_close - self.t_open

    def __call__(self, data, st, line_search_rate=2.0):
        before = _counters()
        if self.trace:
            with torch.profiler.record_function('vi_step'):
                out = self.inner(data, st, line_search_rate=line_search_rate)
        else:
            out = self.inner(data, st, line_search_rate=line_search_rate)
        now = time.perf_counter()
        self.fit_steps += 1
        if self.deadline is None:
            if self.limit is not None and self.fit_steps >= self.limit:
                raise WarmedUp()
            return out
        after = _counters()
        new, pm = out
        n_in, n_out = st.nat_hist_n, new.nat_hist_n
        form = ('epoch' if st.nat_hist is not None else
                'kdim' if st.nat_mu.dim() == 3 else 'shared')
        self.records.append(dict(
            t=now - self.t_open, fit=self.fits, form=form, live_in=n_in or 0,
            live_out=n_out or 0,
            **{k: after[k] - before[k] for k in after}))
        if self.fits == 0 and self.fit_steps <= 3:
            self.held[f'step{self.fit_steps - 1}'] = _kept(st, new, pm)
        if (n_in is not None and n_out > n_in
                and 'em' not in self.held):
            self.held['em'] = _kept(st, new, pm)
        if now >= self.deadline:
            sync(self.device)
            self.t_close = time.perf_counter()
            self.at_close = _counters()
            self.held['last'] = _kept(st, new, pm)
            raise WindowClosed()
        return out


def _kept(st, new, pm):
    return host_state(st), host_state(new), pm.cpu()


def host_state(st):
    """A VIState's public fields the reference reads, copied to the host:
    the compact state's natural mean (the epoch state's accumulator) and
    its live epochs, the hyper-delta, the error scaling, the ELBO the
    program holds, the line search's Lipschitz estimates and the running
    ELBO gain (NaN before a fit's first step)."""
    out = dict(nat=st.nat_mu.cpu(), hyper=st.hyper_delta.cpu(),
               scaling=st.error_scaling.cpu(), elbo=float(st.elbo),
               L=tuple(float(x) for x in st.L),
               running_gain=float(st.running_elbo_delta))
    if st.nat_hist is not None:
        n = st.nat_hist_n
        out.update(hist=st.nat_hist[:n].cpu(),
                   hist_scale=st.nat_hist_scale[:n].cpu(),
                   hist_c=st.nat_hist_c[:n].cpu())
    return out


def for_reference(state, device):
    """A host_state's tensors as float64 on `device`."""
    return {k: (v.to(device=device, dtype=torch.float64)
                if torch.is_tensor(v) else v) for k, v in state.items()}
