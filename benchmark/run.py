"""The benchmark of vilma_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1> [--control]

A run makes its inputs from the seed on the card (harness/inputs.py),
builds the port's production fit as `vilma-tpu-torch fit` builds it
(harness/program.py), warms it up, then runs fits from the production
initialization in a closed loop until the first step end past
--seconds. Then the reference (harness/reference.py) checks what the
window's steps produced (harness/check.py). The last line of standard
output is one JSON object: correct, attempted (steps), failed, the
metrics (with --trace 0 the end-to-end ones, with --trace 1 the
per-layer ones, read from the window's torch.profiler trace), the
device, with --trace 1 the breakdown, and last the compared numbers
beside their limits, which also end standard error.

--control runs the cell's control (not part of a benchmark run): the
configuration's `control` says whether the program runs its own
lower-precision path or the reference, at a lower precision, takes the
program's place in the check. A correct control is a fault.

Without a CUDA device (or with fewer than the cell's chips) the run
exits 2 and prints no result. So does it, with 3, if a JAX module or the
JAX package (`vilma_tpu`, by its whole top-level name) is loaded when
the result would be printed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

# JAX, its relatives, and the JAX package this port was made from: none
# may be loaded in a run (names compared whole, before the first dot)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vilma_tpu')


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is a FORBIDDEN one."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', required=True, type=int)
    ap.add_argument('--seconds', required=True, type=float)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', action='store_true')
    return ap.parse_args(argv)


def execute(cell, seed, seconds, trace, device, control=False,
            t_start=T_START):
    """One run of `cell` on `device`: the result's dict (its keys in the
    order they are printed)."""
    import numpy as np
    import torch
    from harness import check, counts, inputs, program, reference, registry
    from harness import trace as trace_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell['config'], cell['traffic']
    ctl = config.get('control', {}) if control else {}
    u_storage = ctl.get('program_u_storage', config['u_storage'])
    cuda = torch.device(device).type == 'cuda'

    # the inputs wait on the host: the device's peak is the program's
    inp = inputs.make(config, traffic, seed, device).to('cpu')
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    fit = program.Fit(inp, config, traffic, seed, device, u_storage)
    shapes = fit.shapes()
    rng_states = []
    summary = None
    with program.Steps(device, trace=bool(trace)) as steps:
        steps.warm_up(fit.vi, int(traffic.get('warmup_steps', 2)))
        program.sync(device)
        setup_s = time.perf_counter() - t_start
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(trace_mod.SPAN):
                    n_steps, window_s = steps.window(fit.vi, seconds,
                                                     rng_states)
            summary = trace_mod.summary(trace_mod.events(prof))
            del prof
        else:
            n_steps, window_s = steps.window(fit.vi, seconds, rng_states)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept, records, totals = steps.held, steps.records, steps.totals
    run = types.SimpleNamespace(
        cell=cell, setup_s=setup_s, timings=dict(fit.timings),
        steps=n_steps, window_s=window_s, peak_bytes=peak, shapes=shapes,
        records=records, totals=totals, trace=summary,
        work=counts.window_work(shapes, records, totals))
    # the program's state is freed before the reference runs
    del fit, steps
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    inp = inp.to(device)
    kept = {label: (program.for_reference(a, device),
                    program.for_reference(b, device),
                    pm.to(device=device, dtype=torch.float64))
            for label, (a, b, pm) in kept.items()}
    seed_state = np.random.RandomState(
        int(traffic['fit_seed'])).get_state()
    model = check.model_of(inp, cell, seed_state)
    normals = reference.replay_normals(rng_states[0],
                                       tuple(inp.betas.shape))
    if ctl.get('reference_u_storage'):
        values = check.ReferenceValues(check.model_of(
            inp, cell, seed_state, u_storage=ctl['reference_u_storage'],
            dtype=getattr(torch, ctl['reference_dtype'])))
    else:
        s0 = kept['step0'][0]
        values = check.ProgramValues((s0['nat'], s0['hyper']))
    nums = check.numbers(model, kept, normals, values)
    ok, rows = check.verdict(nums, cell['limits'])
    run.check_s = time.perf_counter() - t_check

    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for name, mod in registry.metrics(kind).items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {'value': value, 'unit': mod.UNIT}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    if summary is not None:
        dev.update(busy_s=summary['busy_s'], window_s=summary['window_s'])
    result = {'correct': ok, 'attempted': n_steps, 'failed': 0,
              'metrics': metrics, 'device': dev}
    if summary is not None:
        result['breakdown'] = {
            'device_ops': [list(kv) for kv in summary['device_ops']],
            'idle_gaps': [list(kv) for kv in summary['idle_gaps']]}
    result['compared'] = {k: {'value': v, 'limit': lim}
                          for k, v, lim in rows}
    result['info'] = info(run)
    return result


def info(run):
    """What else a reader of the run wants: fits, live epochs, EM
    events, set-up timings (not read by any check)."""
    import resource
    from harness import trace
    recs = run.records
    written = None
    try:
        with open('/proc/self/io') as fh:
            for line in fh:
                if line.startswith('write_bytes:'):
                    written = int(line.split()[1])
    except OSError:
        pass
    return {'fits_started': 1 + (recs[-1]['fit'] if recs else 0),
            'host_peak_rss_gib': resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
            'written_bytes': written,
            'trace_file_bytes': trace.last_trace_bytes,
            'live_epochs_end': recs[-1]['live_out'] if recs else 0,
            'em_steps': [i for i, r in enumerate(recs)
                         if r['live_out'] > r['live_in']][:8],
            'timings': run.timings, 'check_s': run.check_s,
            'totals': run.totals}


def main(argv=None):
    args = parse(argv)
    from harness import registry
    cell = registry.cell(args.workload)
    chips = int(cell['config'].get('chips', 1))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'benchmark: needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ': no result', file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, args.trace, 'cuda',
                     control=args.control)
    found = forbidden_modules()
    if found:
        print('benchmark: loaded in this process: ' + ', '.join(found),
              file=sys.stderr)
        return 3
    info_line = result.pop('info')
    print('info ' + json.dumps(info_line), file=sys.stderr)
    for name, row in result['compared'].items():
        print(f'compared {name} {row["value"]!r} limit {row["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
