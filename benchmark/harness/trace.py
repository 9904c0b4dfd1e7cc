"""Reading the window's torch.profiler trace (CUPTI): the device's busy
time, each kernel's time by name, the hand-written kernels by kind, and
the idle gaps by what the host was doing in them.

Busy time is the union of the kernel, memcpy and memset intervals from
the start of the window's `bench_window` annotation to the later of its
end and the last device interval (the arithmetic of the port's
chip_smoke.timeline, copied here).

Kinds, by the kernels' names:

* matvec: the block matvec's kernels (`*_matvec_kernel`);
* prologue: the compact objective's kernel without the sums
  (`compact_kernel<P, false, ...>`) and its KL reduction
  (`reduce_scalar`);
* sums: the annotation sums (`compact_kernel<P, true, ...>`) and their
  reduction (`reduce_rows`);
* glue: every other kernel (plain PyTorch's).
"""
import json
import os
import re
import tempfile

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cuda_runtime', 'cuda_driver', 'cpu_op', 'user_annotation',
             'python_function')
SPAN = 'bench_window'
#: bytes of the last trace file `events` read (then removed)
last_trace_bytes = 0
_COMPACT = re.compile(r'compact_kernel<\s*\d+\s*,\s*(true|false)')


def events(prof):
    """The trace's events (its Chrome trace JSON, read from a temporary
    file under TMPDIR that is removed again)."""
    global last_trace_bytes
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        last_trace_bytes = os.path.getsize(path)
        with open(path) as fh:
            return json.load(fh)['traceEvents']


def kind(name):
    """The kind of a device kernel by its name (module docstring)."""
    if 'matvec_kernel' in name:
        return 'matvec'
    m = _COMPACT.search(name)
    if m:
        return 'sums' if m.group(1) == 'true' else 'prologue'
    if 'reduce_scalar' in name:
        return 'prologue'
    if 'reduce_rows' in name:
        return 'sums'
    return 'glue'


def _label(name):
    """A short name for a kernel or host event: without its return type,
    its namespaces and its argument list."""
    name = name.replace('(anonymous namespace)::', '')
    name = re.sub(r'\(.*', '', name)
    name = re.sub(r'^void\s+', '', name)
    name = re.sub(r'^(\w+::)+', '', name)
    return name[:120]


def summary(evts, gaps_top=10, ops_top=10):
    """What the per-layer metrics read from a trace: window_s, busy_s,
    seconds by kind and by kernel name, and the
    breakdown (the kernels that took most time; the idle time by the
    host's activity at each gap's start)."""
    marks = [e for e in evts if e.get('name') == SPAN
             and e.get('cat') == 'user_annotation' and e.get('ph') == 'X']
    if not marks:
        raise RuntimeError(f'the trace has no {SPAN} annotation')
    t0 = marks[0]['ts']
    t1 = t0 + marks[0]['dur']
    dev = sorted((e['ts'], e['ts'] + e['dur'], e['cat'], e['name'])
                 for e in evts if e.get('cat') in DEVICE_CATS
                 and e.get('ph') == 'X' and e['ts'] >= t0)
    if not dev:
        raise RuntimeError('the trace holds no device events')
    t1 = max(t1, dev[-1][1])
    busy, cur_s, cur_e = 0.0, None, None
    gaps = []
    by_kind = {'matvec': 0.0, 'prologue': 0.0, 'sums': 0.0, 'glue': 0.0}
    by_name = {}
    prev_end = t0
    for start, end, cat, name in dev:
        if cat == 'kernel':
            k = kind(name)
            by_kind[k] += (end - start) / 1e6
            lab = _label(name)
            by_name[lab] = by_name.get(lab, 0.0) + (end - start) / 1e6
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gap_from = cur_e if cur_e is not None else prev_end
            if start > gap_from:
                gaps.append((gap_from, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))
    return dict(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
                by_kind=by_kind,
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])
                [:ops_top],
                idle_gaps=_gaps_by_host(evts, gaps, t0, t1)[:gaps_top])


def _gaps_by_host(evts, gaps, t0, t1):
    """[(host activity, idle seconds)], largest first: each gap's idle
    time under the host event that was running at its start, the
    innermost (shortest) of those that cover it; 'host: none' where no
    host event was."""
    host = sorted((e['ts'], e['ts'] + e['dur'], e['name'])
                  for e in evts if e.get('cat') in HOST_CATS
                  and e.get('ph') == 'X' and e.get('name') != SPAN
                  and e['ts'] + e['dur'] >= t0 and e['ts'] <= t1)
    out = {}
    j = 0
    active = []
    for g0, g1 in sorted(gaps):
        while j < len(host) and host[j][0] <= g0:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] > g0]
        label = ('host: ' + re.sub(r'\(.*', '', min(
            active, key=lambda h: h[1] - h[0])[2])[:120]
                 if active else 'host: none')
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
