"""What decides `correct`: the program's own outputs at the steps the
window kept, against the plain reference (harness/reference.py) worked
out again from the inputs.

The reference follows the program step by step from the program's
states (it cannot replay the line search's accept and reject decisions
bit for bit), and checks the start by itself:

* init_nat, init_hyper: the state the window's first fit starts from
  (the LDpred-inf ridge solve, the jitter, the responsibilities, the
  annotation sums) against the reference's start from the same jitter
  draws. init_nat is a gap of norms, ||x - ref|| / ||ref||: with U in
  bfloat16 the start passes the pseudo-inverse's output through the
  matvec's bfloat16 operands, where an f32 sum that lands on the other
  side of a bfloat16 rounding boundary than the reference's moves single
  SNPs' starts by up to 1e-2 of the largest (PERF.md);
* elbo: the ELBO the program holds at each kept state (its objective:
  the prologue, the block matvec over every bucket, the likelihood and
  the KL) against the reference's objective of that state;
* post_mean: the posterior means each kept step returned against the
  reference's means of the step's new state;
* hyper: the hyper-delta each kept step set against the reference's
  update from the step's new parameters under the old hyper-delta and
  error scaling (the annotation sums);
* scaling: at a kept step whose EM appended an epoch, the new error
  scaling against the reference's EM (--learn-scaling fits);
* update: at a kept step that is a fit's first (its running ELBO gain
  not yet set, so the beta loop makes one update), the natural mean the
  beta update made against the reference's own line search from the
  step's old state (reference.Model.line_search): the gap of norms
  ||x - ref|| / ||ref - old|| to the nearest of the states the reference
  may step to (a trial within DECISION_MARGIN of the line search's
  threshold may go either way). A step that keeps its old parameters
  reads 1.

The kept steps are the first three of the window's first fit, the
first whose EM appended an epoch, and the window's last step (the state
the fit ends the window in). Each number is the largest relative gap
over the states it reads: max |x - ref| / max |ref| over the tensor
(init_nat and update: gaps of norms). A number the cell's limits name
and the run has nothing to read for (no kept step whose EM appended an
epoch, say) fails the run.
"""
import math

import torch

from harness import reference

NUMBERS = ('init_nat', 'init_hyper', 'elbo', 'post_mean', 'hyper',
           'scaling', 'update')

# a line-search trial whose objective lies within this share of |orig|
# of the threshold may be accepted or rejected: 4x the float32
# program's largest gap in an ELBO, 2.5e-6 (PERF.md)
DECISION_MARGIN = 1e-5


def rel_gap(x, ref):
    """max |x - ref| / max |ref| (inf when x is not finite)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64, device=x.device)
    if not bool(torch.isfinite(x).all()):
        return float('inf')
    return float((x - ref).abs().max() / ref.abs().max())


def norm_gap(x, ref):
    """||x - ref|| / ||ref|| (inf when x is not finite)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64, device=x.device)
    if not bool(torch.isfinite(x).all()):
        return float('inf')
    return float((x - ref).norm() / ref.norm())


def pre_em(s_in, s_out):
    """The state after a step's beta loop and before its EM, under the
    step's old hyper-delta and error scaling: the new parameters, or
    where the EM appended an epoch, the ones it filed (the accumulator
    it moved into the history and the scaling it ended)."""
    n_in = s_in['hist'].shape[0] if 'hist' in s_in else None
    if n_in is not None and s_out['hist'].shape[0] > n_in:
        n = s_out['hist'].shape[0]
        return dict(nat=s_out['hist'][n - 1], hist=s_out['hist'][:n - 1],
                    hist_scale=s_out['hist_scale'][:n - 1],
                    hist_c=s_out['hist_c'][:n - 1],
                    scaling=s_out['hist_scale'][n - 1],
                    hyper=s_in['hyper']), True
    return dict(s_out, scaling=s_in['scaling'], hyper=s_in['hyper']), False


class ProgramValues:
    """The values the program produced, read off its kept states."""

    def __init__(self, start):
        self.start = start            # (nat, hyper) of the first state

    def init(self, model, normals):
        return self.start

    def elbo(self, model, st):
        return st['elbo']

    def post_mean(self, model, st, returned):
        return returned

    def hyper(self, model, pre, st_out):
        return st_out['hyper']

    def scaling(self, model, pre, st_out):
        return st_out['scaling']

    def update(self, model, s_in, pre):
        return pre['nat']


class ReferenceValues:
    """The control: the reference put in the program's place, computed
    by a lower-precision `model` on the program's states."""

    def __init__(self, model):
        self.model = model

    def init(self, model, normals):
        return self.model.initial_state(normals)

    def elbo(self, model, st):
        return float(self.model.objective(_cast(st, self.model))[0])

    def post_mean(self, model, st, returned):
        return self.model.moments(_cast(st, self.model))[0]

    def hyper(self, model, pre, st_out):
        return self.model.hyper_update(_cast(pre, self.model))

    def scaling(self, model, pre, st_out):
        return self.model.em_scaling(
            _cast(dict(pre, hyper=st_out['hyper']), self.model))

    def update(self, model, s_in, pre):
        st = _cast(s_in, self.model)
        target, sizes = self.model.line_search(st)
        return self.model.stepped(st, target, sizes[0])['nat']


def _cast(st, model):
    return {k: (v.to(model.dtype) if torch.is_tensor(v) else v)
            for k, v in st.items()}


def first_step(s_in):
    """Whether a step is its fit's first (no running ELBO gain yet)."""
    return math.isnan(s_in['running_gain'])


def update_gap(model, s_in, nat):
    """The gap of the natural mean `nat` a fit's first beta update made
    from `s_in` to the nearest state the reference's line search may
    step to, over the reference's move (over the old natural mean's
    norm where the reference keeps it)."""
    nat = torch.as_tensor(nat, dtype=torch.float64)
    if not bool(torch.isfinite(nat).all()):
        return float('inf')
    target, sizes = model.line_search(s_in, margin=DECISION_MARGIN)
    old = s_in['nat']
    gaps = []
    for s in sizes:
        ref = model.stepped(s_in, target, s)['nat']
        scale = (ref - old).norm() if s > 0 else old.norm()
        gaps.append(float((nat.to(ref.device) - ref).norm() / scale))
    return min(gaps)


def numbers(model, kept, normals, values):
    """The compared numbers of a run (the NUMBERS, those the run has
    something to read for). kept: {label: (state in, state out, the
    returned posterior means)}, states as program.state_dict gives them;
    normals: the jitter draws of the first fit's start."""
    out = {}
    nat0, hyper0 = model.initial_state(normals)
    c_nat, c_hyper = values.init(model, normals)
    out['init_nat'] = norm_gap(c_nat, nat0)
    out['init_hyper'] = rel_gap(c_hyper, hyper0)
    elbo, pmean, hyper, scaling, update = [], [], [], [], []

    def check_elbo(st, ref_obj):
        elbo.append(abs(values.elbo(model, st) - float(ref_obj))
                    / abs(float(ref_obj)))

    if 'step0' in kept:
        st = kept['step0'][0]
        check_elbo(st, model.objective(st)[0])
    for s_in, s_out, returned in kept.values():
        ref_obj, ref_pm, _, _ = model.objective(s_out)
        check_elbo(s_out, ref_obj)
        pmean.append(rel_gap(values.post_mean(model, s_out, returned),
                             ref_pm))
        pre, appended = pre_em(s_in, s_out)
        if first_step(s_in):
            update.append(update_gap(model, s_in,
                                     values.update(model, s_in, pre)))
        hyper.append(rel_gap(values.hyper(model, pre, s_out),
                             model.hyper_update(pre)))
        if appended:
            ref_e = model.em_scaling(dict(pre, hyper=s_out['hyper']))
            scaling.append(rel_gap(values.scaling(model, pre, s_out),
                                   ref_e))
    out['elbo'] = max(elbo)
    out['post_mean'] = max(pmean)
    out['hyper'] = max(hyper)
    if scaling:
        out['scaling'] = max(scaling)
    if update:
        out['update'] = max(update)
    return out


def verdict(nums, limits):
    """(correct, [(name, value, limit)]): every number the cell's limits
    file names is read and at most its limit; one the run has nothing to
    read for (value None) fails."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise ValueError(f'limits of unknown numbers: {sorted(unknown)}')
    rows = [(k, nums.get(k), limits[k]) for k in NUMBERS if k in limits]
    return all(v is not None and v <= lim for _, v, lim in rows), rows


def model_of(inp, cell, seed_state, u_storage=None, dtype=torch.float64):
    """The reference Model of a run's inputs: the grid drawn from the
    run's seeded RNG state, U at the configuration's storage type (or
    `u_storage`), computed in `dtype`."""
    config, traffic = cell['config'], cell['traffic']
    betas = inp.betas.cpu().numpy()
    std_errs = inp.std_errs.cpu().numpy()
    covs, _ = reference.grid(betas, std_errs, seed_state,
                             int(traffic['components']),
                             float32=config['state_dtype'] == 'float32')
    P = betas.shape[0]
    return reference.model(
        inp, covs, [float(traffic['samplesizes'])] * P,
        [float(traffic['init_hg'])] * P,
        u_storage or config['u_storage'], dtype)
