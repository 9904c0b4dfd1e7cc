"""The plain reference of the fit: the variational objective of the
multi-cohort RSS model with a mixture-of-Gaussians prior, its pieces and
its initialization, written out in plain PyTorch (float64 by default).

It imports nothing of the program. From the benchmark's inputs (the
summary statistics, the annotations, the LD bank's float64 factors and
the global numpy RNG state the fit starts from) it works everything out
again: the covariance grid the `fit` command draws, its precisions and
log-determinants, the LD diagonal, the adjusted effects, chi^2, the
LDpred-inf start (a ridge solve by conjugate gradients), and then, at
any state of the compact fit (the shared [P, I] natural mean, or the
epoch history of --learn-scaling fits), the objective, the posterior
moments, the annotation sums behind the hyper-delta update and the
error-scaling EM.

The math, per SNP i and mixture component k (P cohorts, P <= 2 here):

    M_ki = prec_k + diag(sld_i / e)            precision of q(beta_i | k)
    y_ki = M_ki^-1 n_i                         (shared state; the epoch
           state adds sum_e c_e M_ki^(e)^-1 v_e, M^(e) at epoch e's e)
    z_ki = 0.5 (y' M y - log det M) + log H[a_i, k] - 0.5 log det C_k
    q_ki = softmax_k z_ki
    E[beta_i] = sum_k q y,  Var = sum_k q (diag M^-1 + y^2) - E^2
    KL_i = sum_k q (log q - log H + 0.5 y' prec y
                    + 0.5 (log det C_k + log det M + tr(prec M^-1)))
    ll_p = sum_i -0.5 (sld Var + (R (E / se)) E / se) + E adj
    objective = sum_p ((ll_p - 0.5 chi_p) / e_p - 0.5 rank_p log e_p)
                - sum_i KL_i

(the constant -P/2 of each KL is left out, as the fit leaves it out).
The LD operator R is block-diagonal with blocks U diag(s) U', the U and
s of the panel at the precision the configuration stores them in.

A beta update is a natural-gradient step of size s towards the target

    g_p = (adj_p - (R (E_p / se_p)) / se_p + E_p sld_p) / e_p

(the same for every component): nat <- (1 - s) nat + s g, and on the
epoch state also c_e <- (1 - s) c_e. The step size comes from a
backtracking line search: s = 1 / L0 with L0 = max(1, L / 1.25), halved
while the objective falls below orig - REL_TOL |orig| - ABS_TOL, until
L0 passes L_MAX, where the old parameters are kept (the original vilma's
variational_inference.py:762-802).
"""
import itertools

import numpy as np
import torch

# [K, chunk] temporaries of the per-component terms hold at most this
# many elements each
CHUNK_ELEMS = 1 << 24

# the line search of the beta update
REL_TOL = 1e-6
ABS_TOL = 1e-6
L_MAX = 1e12
LINE_SEARCH_RATE = 2.0


# ---------------------------------------------------------------------------
# The covariance grid the `fit` command builds (vi_options.py:196-337 of
# the original vilma), drawn from the global numpy RNG stream
# ---------------------------------------------------------------------------

def effect_size_ranges(betas, std_errs):
    """Per-cohort (mins, maxes) anchoring the grid's variance ladder
    (natural-scale effects)."""
    P = betas.shape[0]
    maxes, mins = np.zeros(P), np.zeros(P)
    for p in range(P):
        keep = ~np.isnan(betas[p])
        b = np.abs(betas[p, keep])
        se = std_errs[p, keep]
        psi = 1. / len(b)
        probs = 1. / (1. + ((1. - psi) / psi * np.sqrt(b ** 2 / se ** 2)
                            * np.exp(-0.5 * b ** 2 / se ** 2 + 0.5)))
        ebayes = np.maximum(b ** 2 - se ** 2, 1e-10)
        raw = b / (1. + se ** 2 / ebayes ** 2)
        maxes[p] = np.max(probs * raw) ** 2
        mins[p] = np.nanpercentile(betas[p, betas[p] ** 2 > 0] ** 2, 2.5)
    return mins, maxes


def covariance_grid(rs, P, K, mins, maxes):
    """The grid of prior covariances: a near-zero component and a
    log-spaced ladder of K + 1 variances, crossed (P > 1) with K
    correlations per cohort pair and three random diagonal rescalings
    each, plus cohort-specific components. `rs` is the RandomState whose
    draws the fit makes."""
    ladder = [[m * 1e-6 for m in mins]]
    for k in range(K + 1):
        ladder.append([mins[p] * np.exp(np.log(maxes[p] / mins[p]) / K * k)
                       for p in range(P)])
    if P == 1:
        return np.array(ladder).reshape((K + 2, 1, 1))
    corrs = [-.99 + 1.98 * (k + 1) / K for k in range(K)]
    covs = []
    upper = np.triu_indices(P, k=1)
    for idx, diag in enumerate(ladder):
        root = np.sqrt(np.asarray(diag))
        for off in itertools.product(*[corrs] * (P * (P - 1) // 2)):
            corr = np.eye(P)
            corr[upper] = off
            corr.T[upper] = off
            mat = corr * root[:, None] * root[None, :]
            for _ in range(3):
                sc = np.sqrt(np.exp(rs.uniform(-1, 1, P)))
                covs.append(mat * sc[:, None] * sc[None, :])
        if idx > 0:
            for p in range(P):
                single = np.array(ladder[0], dtype=float)
                single[p] = diag[p]
                for _ in range(3):
                    sc = np.sqrt(np.exp(rs.uniform(-1, 1, P)))
                    covs.append(np.diag(single) * sc * sc)
    return np.array(covs)


def floor_covariances(covs, rel_floor=1e-10):
    """Eigenvalues below rel_floor of the grid's largest raised to it:
    the float32 fit's definition of its prior (a near-zero spike
    component lies below float32's range)."""
    w, v = np.linalg.eigh(covs)
    floor = float(w.max()) * rel_floor
    if w.min() >= floor:
        return covs
    w = np.maximum(w, floor)
    return np.einsum('kpq,kq,krq->kpr', v, w, v)


def replay_normals(rng_state, shape):
    """The standard normals a numpy RandomState in `rng_state` draws
    next, in C order (numpy's normal(loc, scale) is loc + scale times
    these)."""
    rs = np.random.RandomState()
    rs.set_state(rng_state)
    return rs.standard_normal(size=shape)


# ---------------------------------------------------------------------------
# The LD panel
# ---------------------------------------------------------------------------

def stored(t, storage):
    """A float64 tensor as the program stores it: as it is at float64;
    else rounded to float32, then to `storage` (float32, bfloat16, or
    float8_e4m3fn with one scale per tensor), and back to float64."""
    if storage == 'float64':
        return t.to(torch.float64)
    t32 = t.to(torch.float32)
    if storage == 'float32':
        return t32.to(torch.float64)
    if storage == 'bfloat16':
        return t32.to(torch.bfloat16).to(torch.float64)
    if storage == 'float8_e4m3fn':
        scale = t32.abs().max() / 448.0
        q = (t32 / scale).to(torch.float8_e4m3fn)
        return q.to(torch.float64) * scale.to(torch.float64)
    raise ValueError(f'unknown storage type {storage}')


class LD:
    """The block-diagonal LD operator of an inputs.Panel: U stored at
    `u_storage`, s at float32, computed in `dtype`."""

    def __init__(self, panel, u_storage, dtype=torch.float64):
        self.dtype = dtype
        # below float32, the matvec's operands (x, and s * U'x) are
        # rounded to bfloat16 before each contraction, the sums kept
        # wide: the port's defined arithmetic of --ld-precision bf16
        self.round_operands = u_storage in ('bfloat16', 'float8_e4m3fn')
        self.n = panel.block_size
        self.num_full = panel.num_full
        self.num_snps = panel.num_snps

        def cast(f):
            return (stored(f.u, u_storage).to(dtype),
                    stored(f.s, 'float32').to(dtype))

        self.bank = [cast(f) for f in panel.bank]
        self.tail = cast(panel.tail) if panel.tail is not None else None
        assign = panel.assign.to(self.bank[0][0].device)
        self.groups = [torch.nonzero(assign == j).flatten()
                       for j in range(len(self.bank))]
        ranks = [u.shape[1] for u, _ in self.bank]
        self.rank = float(sum(ranks[j] for j in panel.assign.tolist())
                          + (self.tail[0].shape[1] if self.tail else 0))

    def _apply(self, x, fn):
        """fn(u, s, xb) block by block over x [C, I] (xb [C, m, n])."""
        C = x.shape[0]
        cut = self.num_full * self.n
        full = x[:, :cut].reshape(C, self.num_full, self.n)
        out = torch.empty_like(x)
        oful = out[:, :cut].view(C, self.num_full, self.n)
        for (u, s), idx in zip(self.bank, self.groups):
            if idx.numel():
                oful[:, idx] = fn(u, s, full[:, idx])
        if self.tail is not None:
            u, s = self.tail
            out[:, cut:] = fn(u, s, x[:, None, cut:])[:, 0]
        return out

    def dot(self, x):
        """R x as the fit's block matvec forms it (operands rounded where
        `round_operands`)."""
        if not self.round_operands:
            return self.exact_dot(x)

        def bf16(t):
            return t.to(torch.bfloat16).to(self.dtype)

        return self._apply(
            x, lambda u, s, xb: bf16((bf16(xb) @ u) * s) @ u.T)

    def exact_dot(self, x):
        """R x."""
        return self._apply(x, lambda u, s, xb: ((xb @ u) * s) @ u.T)

    def pinv_dot(self, x):
        """R^+ x (the inverse on the span of U)."""
        return self._apply(x, lambda u, s, xb: ((xb @ u) / s) @ u.T)

    def diag(self):
        """diag(R) [I]."""
        out = torch.empty(self.num_snps, dtype=self.dtype,
                          device=self.bank[0][0].device)
        cut = self.num_full * self.n
        d = torch.stack([(u * u * s).sum(1) for u, s in self.bank])
        assign = torch.zeros(self.num_full, dtype=torch.long,
                             device=d.device)
        for j, idx in enumerate(self.groups):
            assign[idx] = j
        out[:cut] = d[assign].reshape(-1)
        if self.tail is not None:
            u, s = self.tail
            out[cut:] = (u * u * s).sum(1)
        return out

    def ridge_solve(self, b, reg, max_iter=1000):
        """(R + diag(reg))^-1 b for [C, I] b and reg, by conjugate
        gradients preconditioned with the diagonal, to a relative
        residual of 100 ulps of `dtype`."""
        tol = 100 * torch.finfo(self.dtype).eps
        dinv = 1.0 / (self.diag()[None] + reg)
        x = b * dinv
        r = b - (self.exact_dot(x) + reg * x)
        z = r * dinv
        p = z
        rz = (r * z).sum(1, keepdim=True)
        bnorm = b.norm(dim=1)
        for _ in range(max_iter):
            ap = self.exact_dot(p) + reg * p
            alpha = rz / (p * ap).sum(1, keepdim=True)
            x = x + alpha * p
            r = r - alpha * ap
            if float((r.norm(dim=1) / bnorm).max()) < tol:
                break
            z = r * dinv
            rz_new = (r * z).sum(1, keepdim=True)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Model:
    """The fit's sufficient statistics, worked out from the inputs.

    betas, std_errs: [P, I] float64 tensors; annotations [I] category
    ids; covs [K, P, P] numpy (the grid, floored for a float32 fit);
    gwas_n, init_hg: per cohort; ld: an `LD`."""

    def __init__(self, betas, std_errs, annotations, num_annotations, covs,
                 gwas_n, init_hg, ld):
        dt = ld.dtype
        dev = betas.device
        self.ld = ld
        self.dtype = dt
        self.P, self.I = betas.shape
        self.A = int(num_annotations)
        self.se = std_errs.to(dt)
        self.ann = annotations.long()
        self.counts = torch.bincount(self.ann, minlength=self.A).to(dt)
        covs = np.asarray(covs, dtype=np.float64)
        self.K = covs.shape[0]
        self.prec = torch.as_tensor(np.linalg.inv(covs), device=dev).to(dt)
        self.log_det = torch.as_tensor(np.linalg.slogdet(covs)[1],
                                       device=dev).to(dt)
        self.ld_diag = ld.diag()
        self.sld = self.ld_diag[None] / self.se ** 2
        z = betas.to(dt) / self.se
        mle = ld.pinv_dot(z)
        adj_raw = ld.dot(mle)
        self.adj = adj_raw / self.se
        self.chi = (z * mle).sum(1)
        self.rank = torch.full((self.P,), ld.rank, dtype=dt, device=dev)
        se_sum = (self.se ** -2).sum(1)
        n = torch.as_tensor(np.asarray(gwas_n, dtype=np.float64),
                            device=dev).to(dt)
        h = torch.as_tensor(np.asarray(init_hg, dtype=np.float64),
                            device=dev).to(dt)
        prior = 2 * n * h / se_sum
        inv_z = ld.ridge_solve(adj_raw, self.se ** 2 / prior[:, None])
        self.inverse_betas = inv_z * self.se

    # -- per-component closed forms over a chunk of SNPs ------------------
    def _sigma(self, dt):
        """Entries of M^-1 ([K, c], or [K, 1] where constant) and
        log det M of M_k = prec_k + diag(dt), dt [P, c]."""
        pr = self.prec
        if self.P == 1:
            a = pr[:, 0, 0, None] + dt[0][None]
            return [[1.0 / a]], torch.log(a)
        if self.P == 2:
            a = pr[:, 0, 0, None] + dt[0][None]
            b = pr[:, 0, 1, None]
            d = pr[:, 1, 1, None] + dt[1][None]
            det = a * d - b * b
            inv = 1.0 / det
            off = -b * inv
            return [[d * inv, off], [off, a * inv]], torch.log(det)
        raise NotImplementedError('the reference covers P <= 2 cohorts')

    @staticmethod
    def _apply(S, n):
        """M^-1 n for n a list of P rows ([c] or [K, c])."""
        P = len(S)
        return [sum(S[p][q] * n[q] for q in range(P)) for p in range(P)]

    def _chunks(self):
        step = max(1, CHUNK_ELEMS // self.K)
        return [(i0, min(self.I, i0 + step))
                for i0 in range(0, self.I, step)]

    def _terms(self, st, c0, c1):
        """The per-component terms of a state over SNPs [c0, c1)."""
        P = self.P
        if st['nat'].dim() != 2:
            raise NotImplementedError('the reference covers the shared and '
                                      'the epoch-history states')
        sld = self.sld[:, c0:c1]
        dt = sld / st['scaling'][:, None]
        S, logdet = self._sigma(dt)
        y = self._apply(S, [st['nat'][p, c0:c1][None] for p in range(P)])
        for e in range(st['hist'].shape[0] if 'hist' in st else 0):
            Se, _ = self._sigma(sld / st['hist_scale'][e][:, None])
            ye = self._apply(Se, [st['hist'][e, p, c0:c1][None]
                                  for p in range(P)])
            y = [yp + st['hist_c'][e] * yep for yp, yep in zip(y, ye)]
        pr = self.prec
        py = [sum(pr[:, p, q, None] * y[q] for q in range(P))
              for p in range(P)]
        quadform = sum(y[p] * py[p] for p in range(P))
        quad = quadform + sum(dt[p][None] * y[p] * y[p] for p in range(P))
        matches = sum(pr[:, p, q, None] * S[q][p]
                      for p in range(P) for q in range(P))
        log_h = torch.log(st['hyper']).T[:, self.ann[c0:c1]]    # [K, c]
        z = 0.5 * (quad - logdet) + log_h - 0.5 * self.log_det[:, None]
        log_q = z - torch.logsumexp(z, dim=0, keepdim=True)
        return dict(S=S, y=y, logdet=logdet, quadform=quadform,
                    matches=matches, log_h=log_h, log_q=log_q,
                    q=torch.exp(log_q))

    def moments(self, st):
        """(posterior means [P, I], variances [P, I], KL) of a state."""
        pm = torch.empty((self.P, self.I), dtype=self.dtype,
                         device=self.se.device)
        pv = torch.empty_like(pm)
        kl = 0.0
        for c0, c1 in self._chunks():
            t = self._terms(st, c0, c1)
            q, y = t['q'], t['y']
            for p in range(self.P):
                m1 = (q * y[p]).sum(0)
                pm[p, c0:c1] = m1
                pv[p, c0:c1] = (q * (t['S'][p][p] + y[p] * y[p])).sum(0) \
                    - m1 * m1
            kl = kl + (q * (t['log_q'] - t['log_h'] + 0.5 * t['quadform']
                            + 0.5 * (self.log_det[:, None] + t['logdet']
                                     + t['matches']))).sum()
        return pm, pv, kl

    def objective(self, st):
        """(objective, posterior means, variances, linked = R (pm / se))
        of a state."""
        pm, pv, kl = self.moments(st)
        scaled = pm / self.se
        linked = self.ld.dot(scaled)
        ll = (-0.5 * (self.sld * pv + linked * scaled)
              + pm * self.adj).sum(1)
        e = st['scaling']
        obj = ((ll - 0.5 * self.chi) / e
               - 0.5 * self.rank * torch.log(e)).sum() - kl
        return obj, pm, pv, linked

    def annotation_sums(self, st):
        """[A, K]: the sums over each category's SNPs of q_ki."""
        out = torch.zeros((self.A, self.K), dtype=self.dtype,
                          device=self.se.device)
        for c0, c1 in self._chunks():
            q = self._terms(st, c0, c1)['q']
            out.index_add_(0, self.ann[c0:c1], q.T)
        return out

    def hyper_update(self, st):
        """The hyper-delta update from a state (its own hyper_delta the
        one the sums are taken under)."""
        h = self.annotation_sums(st) / self.counts[:, None]
        return h / h.sum(1, keepdim=True)

    def em_scaling(self, st):
        """The error-scaling EM's new scaling [P] at a state."""
        _, pm, pv, linked = self.objective(st)
        cross = (pm * self.adj).sum(1)
        quad = (pm / self.se * linked).sum(1)
        var = (self.ld_diag[None] * pv / self.se ** 2).sum(1)
        return (self.chi - 2 * cross + quad + var) / self.rank

    @staticmethod
    def stepped(st, target, s):
        """The state a beta update of size s towards `target` makes."""
        out = dict(st, nat=s * target + (1.0 - s) * st['nat'])
        if 'hist_c' in st:
            out['hist_c'] = (1.0 - s) * st['hist_c']
        return out

    def line_search(self, st, margin=0.0):
        """(target [P, I], step sizes) of one beta update from a state
        with its Lipschitz estimates `L`: the sizes the line search may
        take, 0 where it keeps the old parameters. A trial whose
        objective lies within margin |orig| of the threshold may go
        either way, and adds its size to those of the later trials."""
        orig, pm, _, linked = self.objective(st)
        orig = float(orig)
        target = ((self.adj - linked / self.se + pm * self.sld)
                  / st['scaling'][:, None])
        threshold = orig - REL_TOL * abs(orig) - ABS_TOL
        room = margin * abs(orig)
        L0 = max(1.0, float(st['L'][0]) / 1.25)
        sizes = []
        while True:
            s = 1.0 / L0
            obj = float(self.objective(self.stepped(st, target, s))[0])
            if obj >= threshold - room:
                sizes.append(s)
            if obj >= threshold + room:
                return target, sizes
            if L0 > L_MAX:
                return target, sizes + [0.0]
            L0 *= LINE_SEARCH_RATE

    def initial_state(self, normals):
        """(natural mean [P, I], hyper_delta [A, K]) of the fit's start
        from the jitter draws `normals` [P, I]: the LDpred-inf means
        jittered by 1e-3 SE, their responsibilities under the prior at an
        error scaling of 1, the annotation sums of those, and each SNP's
        natural mean under the responsibility-weighted covariance."""
        P = self.P
        mu = self.inverse_betas + 1e-3 * self.se * torch.as_tensor(
            normals, device=self.se.device).to(self.dtype)
        nat = torch.empty_like(mu)
        sums = torch.zeros((self.A, self.K), dtype=self.dtype,
                           device=mu.device)
        pr = self.prec
        for c0, c1 in self._chunks():
            S, _ = self._sigma(self.sld[:, c0:c1])
            m = [1.6 * mu[p, c0:c1][None] for p in range(P)]
            quadform = sum(m[p] * pr[:, p, q, None] * m[q]
                           for p in range(P) for q in range(P))
            matches = sum(pr[:, p, q, None] * S[q][p]
                          for p in range(P) for q in range(P))
            score = quadform + matches - self.log_det[:, None]
            w = torch.exp(-0.5 * (score - score.amin(0, keepdim=True)))
            q = w / w.sum(0, keepdim=True)
            sums.index_add_(0, self.ann[c0:c1], q.T)
            avg = [[(q * S[p][r]).sum(0) for r in range(P)]
                   for p in range(P)]
            x = [mu[p, c0:c1] for p in range(P)]
            if P == 1:
                nat[0, c0:c1] = x[0] / avg[0][0]
            else:
                det = avg[0][0] * avg[1][1] - avg[0][1] * avg[1][0]
                nat[0, c0:c1] = (avg[1][1] * x[0] - avg[0][1] * x[1]) / det
                nat[1, c0:c1] = (avg[0][0] * x[1] - avg[1][0] * x[0]) / det
        hyper = sums + 1.0
        return nat, hyper / hyper.sum(1, keepdim=True)


def model(inputs, covs, gwas_n, init_hg, u_storage, dtype=torch.float64):
    """The reference Model of the benchmark's inputs."""
    ld = LD(inputs.panel, u_storage, dtype)
    return Model(inputs.betas, inputs.std_errs, inputs.annotations,
                 inputs.num_annotations, covs, gwas_n, init_hg, ld)


def grid(betas, std_errs, seed_state, K, float32):
    """The covariance grid of the fit (numpy), drawn as `fit` draws it
    from the global RNG in `seed_state`, floored for a float32 fit; and
    the RNG state after the draws."""
    rs = np.random.RandomState()
    rs.set_state(seed_state)
    mins, maxes = effect_size_ranges(betas, std_errs)
    covs = covariance_grid(rs, betas.shape[0], K, mins, maxes)
    if float32:
        covs = floor_covariances(covs)
    return covs, rs.get_state()
