"""Operations and bytes of each hand-written kernel's call, counted from
the algorithm's shapes (not from any kernel's source), and the chip's
published peaks they are held against.

Bytes: every input the call needs read once and every output written
once, at the stored types (float32 = 4 bytes; U at its own type).
Operations: the floating-point operations the math of one call needs,
an add, a multiply, a division, an exp or a log counting one each; an
implementation may need more (a two-pass softmax, recomputed terms), and
that is its loss against the bound, not more work counted.

A call's least time is the larger of bytes over PEAK_BYTES_S and
operations over PEAK_FP32_S; its roofline share is that over the time it
took. The peaks are NVIDIA's data sheet for the H100 SXM at 700 W: 3.35
TB/s of HBM3 and 67 TFLOP/s of FP32 outside the tensor cores (the
kernels compute in FP32 on the CUDA cores).
"""
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
F32 = 4

# per (SNP, component) operations of the compact objective's pieces, by
# cohort count P (see PERF.md "Roofline counts" for the term-by-term sum)
#   solve: M = prec_k + diag(dt) (P adds), its determinant and inverse,
#          y = M^-1 n
#   z: y . n, log det M, z = 0.5 (quad - logdet) + score
#   softmax: the running max, exp(z - m), the sum
#   moments: sum_k q y_p, and sum_k q (diag M^-1 + y_p^2)
#   kl: log q, log H, y' prec y, tr(prec M^-1), the bracket, q times it
#   epoch: one more solve, and y += c_e y_e, for each live epoch
#   epoch_quad: M y, which the epoch form needs for y' M y
_OPS = {
    1: dict(solve=3, z=5, softmax=4, moments=6, kl=15, epoch=5,
            epoch_quad=1, normalize=2),
    2: dict(solve=14, z=7, softmax=4, moments=14, kl=27, epoch=18,
            epoch_quad=6, normalize=2),
}


def _ops(P):
    if P not in _OPS:
        raise ValueError(f'operation counts cover P in {sorted(_OPS)}')
    return _OPS[P]


def ncol(P):
    """Columns of the prior table: prec's upper triangle and log det."""
    return P * (P + 1) // 2 + 1


def matvec(B, Pmax, R, C, u_bytes):
    """(operations, bytes) of one bucket matvec y = U (s * (U' x)) + d * x
    over B blocks of [Pmax, R] and C cohorts."""
    ops = B * C * (2 * Pmax * R + R + 2 * Pmax * R + 2 * Pmax)
    nbytes = (B * Pmax * R * u_bytes + B * R * F32 + B * Pmax * F32
              + 2 * B * C * Pmax * F32)
    return ops, nbytes


def _compact(I, P, K, A, form, live, terms):
    """(operations, bytes read) of one compact-objective call whose per
    (SNP, component) work is `terms`, on the state `form`: 'shared' (the
    [P, I] natural mean), 'kdim' ([K, P, I]) or 'epoch' (the [P, I]
    accumulator and `live` epochs of [P, I], their scalings and
    coefficients)."""
    o = _ops(P)
    per = sum(o[t] for t in terms)
    # the prior table, the annotation ids, the diagonal term, the state
    inputs = K * (ncol(P) + A) * F32 + I * F32 + 2 * P * I * F32
    if form == 'kdim':
        inputs += (K - 1) * P * I * F32
    elif form == 'epoch':
        per += o['epoch_quad'] + o['epoch'] * live
        inputs += live * P * I * F32 + (live + 1) * P * F32 + live * F32
    return I * K * per, inputs


def prologue(I, P, K, A, form='shared', live=0):
    """(operations, bytes) of one prologue call: posterior means and
    variances [P, I] and the KL scalar."""
    ops, inputs = _compact(I, P, K, A, form, live,
                           ('solve', 'z', 'softmax', 'moments', 'kl'))
    return ops, inputs + 2 * P * I * F32 + F32


def sums(I, P, K, A, form='shared', live=0):
    """(operations, bytes) of one annotation-sums call: [A, K] sums of
    the responsibilities q over each category's SNPs."""
    ops, inputs = _compact(I, P, K, A, form, live,
                           ('solve', 'z', 'softmax', 'normalize'))
    return ops, inputs + A * K * F32


def least_s(ops, nbytes):
    """The least seconds a call can take on the chip."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)


def window_work(shapes, records, totals):
    """{kind: (operations, bytes, least seconds)} of the hand-written
    kernels' calls in a window, from the fit's shapes, the per-step
    records (launches a step, the state's form and live epochs) and the
    window's launch totals. Launches outside the steps (each fit's start)
    see a fresh state: no live epoch. In a step whose EM filed an epoch,
    the step's last prologue (the evaluation after the EM) sees the new
    count."""
    I, P, K, A = shapes['I'], shapes['P'], shapes['K'], shapes['A']
    form = records[0]['form'] if records else 'shared'
    out = {}
    for kind, fn in (('prologue', prologue), ('sums', sums)):
        calls = []
        for r in records:
            n = r[kind]
            if kind == 'prologue' and r['live_out'] > r['live_in'] and n:
                calls += [(1, r['live_out']), (n - 1, r['live_in'])]
            else:
                calls.append((n, r['live_in']))
        calls.append((totals[kind] - sum(r[kind] for r in records), 0))
        ops = nbytes = least = 0.0
        for n, live in calls:
            o, b = fn(I, P, K, A, form, live)
            ops += n * o
            nbytes += n * b
            least += n * least_s(o, b)
        out[kind] = (ops, nbytes, least)
    ops = nbytes = least = 0.0
    buckets = shapes['buckets']
    passes = totals['matvec'] / max(1, len(buckets))
    for B, Pmax, R, ub in buckets:
        o, b = matvec(B, Pmax, R, P, ub)
        ops += passes * o
        nbytes += passes * b
        least += passes * least_s(o, b)
    out['matvec'] = (ops, nbytes, least)
    return out


def roofline_share(run, kind):
    """The roofline share (%) of a kind of hand-written kernel in a
    traced window: the least time of its calls (`window_work`) over the
    device time the trace gives its kernels by name; None where the
    window has none."""
    if run.trace is None:
        return None
    secs = run.trace['by_kind'][kind]
    least = run.work[kind][2]
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
