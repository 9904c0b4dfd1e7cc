"""The LD panel's real block widths, from the configuration alone, set
against the padded buckets a run packed (`run.shapes['buckets']`), for
metrics that must not move with the program's tiers:

* `real_blocks`: the configuration's blocks as (count, rows, rank): the
  full blocks of block_size SNPs and the shorter last one, each at
  rank_frac of its rows (harness/inputs.py's draw);
* `held`: which real blocks each bucket holds;
* `u_pad_pct`: the share of U's bytes on the card that is zero pad;
* `group_work`: the least seconds of the group route's matvec calls in
  a window, their bytes and operations counted at the real widths
  (harness/counts.matvec), not at the padded ones.
"""
from harness import counts, inputs


def real_blocks(config):
    """[(count, rows, rank)] of the configuration's LD blocks."""
    I, n = int(config['num_snps']), int(config['block_size'])
    frac = float(config['rank_frac'])
    full, rest = divmod(I, n)
    out = [(full, n, inputs._rank(n, frac))] if full else []
    if rest:
        out.append((1, rest, inputs._rank(rest, frac)))
    return out


def held(buckets, config):
    """The real blocks of each bucket (B, Pmax, R, itemsize): [[(count,
    rows, rank)]] in the buckets' order. The buckets are filled from the
    narrowest up, each with the narrowest real blocks left that fit it;
    None where the buckets do not hold the configuration's blocks
    exactly."""
    left = sorted([list(b) for b in real_blocks(config)],
                  key=lambda b: (b[1], b[2]))
    out = [None] * len(buckets)
    for i in sorted(range(len(buckets)),
                    key=lambda i: (buckets[i][1], buckets[i][2])):
        room, pmax, rmax = buckets[i][:3]
        mine = []
        for b in left:
            take = min(room, b[0]) if b[1] <= pmax and b[2] <= rmax else 0
            if take:
                mine.append((take, b[1], b[2]))
                b[0] -= take
                room -= take
        if room:
            return None
        left = [b for b in left if b[0]]
        out[i] = mine
    return None if left else out


def u_pad_pct(buckets, config):
    """100 x (bytes of U the buckets hold - bytes of the real blocks) /
    bytes held, at the buckets' element size."""
    total = sum(B * pmax * rmax * ub for B, pmax, rmax, ub in buckets)
    if not total:
        return None
    real = sum(c * n * r for c, n, r in real_blocks(config)) * buckets[0][3]
    return 100.0 * (total - real) / total


def group_work(shapes, totals, config, is_group):
    """(operations, bytes, least seconds) of the window's group-route
    matvec calls: `totals['matvec']` calls spread evenly over the buckets
    (one a bucket an evaluation), those of the buckets `is_group(B, Pmax,
    R, itemsize, C)` puts on the group route counted at their real
    blocks' widths; None where the buckets do not match the
    configuration."""
    buckets = shapes['buckets']
    blocks = held(buckets, config)
    if blocks is None or not buckets:
        return None
    C = shapes['P']
    passes = totals['matvec'] / len(buckets)
    ops = nbytes = least = 0.0
    for (B, pmax, rmax, ub), mine in zip(buckets, blocks):
        if not is_group(B, pmax, rmax, ub, C):
            continue
        o = b = 0
        for count, n, r in mine:
            oc, bc = counts.matvec(count, n, r, C, ub)
            o += oc
            b += bc
        ops += passes * o
        nbytes += passes * b
        least += passes * counts.least_s(o, b)
    return ops, nbytes, least
