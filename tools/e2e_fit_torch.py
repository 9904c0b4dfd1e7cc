"""Time the stages of one `vilma-tpu-torch fit` run and print an E2E line.

    python3 tools/e2e_fit_torch.py [--tag NAME] [--stop-after N] \\
        [--text-only] fit --ld-schema ... --output ...

Everything from `fit` on is the CLI's own argv, parsed and run as
`python -m vilma_tpu_torch.frontend fit` runs it, in this process. The
script wraps the functions `commands/fit.py:main` calls and times them:

- text: the variant list, annotations and sumstats loaders, and the
  `.var` reads and variant matching of the LD load;
- ld: the LD load less its `.var` text: each block's `.npy` read and
  dense rebuild (`ld_read`), its host eigendecomposition (`ld_eigh`),
  and the pack onto the device (`pack`);
- setup: from the end of the LD load to the first outer step (the grid,
  MultiPopVI's data on the device, the initialization, the first ELBO);
- iterations: the outer steps, to the end of `optimize`;
- output: from there to the end of `main` (`npz`: write_npz_all_ranks;
  `tsv`: the estimates table).

Before the fit it reckons the output bytes (vi_mu, vi_delta and, unless
--no-save-vi-sigma, vi_sigma, at the fit's precision) beside the free
bytes of the output's file system, and stops with exit code 1 when they
do not fit. `--stop-after N` ends the run after N outer steps, before any
output is written (a load and set-up measurement). `--text-only` runs the
text stage alone and prints `E2E_TEXT {json}` (seconds of each loader
and peak RSS).

The last line is `E2E {json}`: SNPs, K, the state form, U's dtype,
seconds by stage, iterations (converged, capped or stopped), seconds an
iteration (the first 10, the rest, and each tenth of the run), the epoch
state's live epochs at the end, the kernels' launches in all and a step
(initialization included), bytes written by member, peak host
RSS (VmHWM) after the load, the set-up and the run, and peak device
memory of the load, set-up, iterations and outputs.
"""
import argparse
import json
import os
import resource
import shutil
import sys
import time
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _Stop(Exception):
    """Raised by the outer-step wrapper after --stop-after steps."""


def _vm_hwm_gib():
    """Peak host RSS of this process in GiB: VmHWM, or where the kernel
    does not report it, getrusage's ru_maxrss."""
    with open('/proc/self/status') as fh:
        for line in fh:
            if line.startswith('VmHWM:'):
                return int(line.split()[1]) / 2 ** 20
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _precision(args):
    if args.precision != 'auto':
        return args.precision
    return 'f32' if args.device == 'cuda' else 'f64'


def reckon_outputs(args):
    """(variants, components, reckoned bytes of the big .npz members)."""
    from vilma_tpu_torch.models import mixture
    with open(args.extract, 'rb') as fh:
        n = sum(chunk.count(b'\n') for chunk in iter(
            lambda: fh.read(1 << 24), b'')) - 1
    pops = args.sumstats.count(',') + 1
    rng = np.random.get_state()
    K = len(mixture.make_simple(pops, args.components, np.full(pops, 1e-6),
                                np.full(pops, 1e-2),
                                drop_non_psd=args.drop_non_psd))
    np.random.set_state(rng)
    item = 8 if _precision(args) == 'f64' else 4
    members = {'vi_mu': K * pops * n, 'vi_delta': n * K}
    if args.save_vi_sigma:
        members['vi_sigma'] = K * pops * pops * n
    return n, K, {k: v * item for k, v in members.items()}


def text_only(args, tag):
    """The text stage alone, as fit runs it: the variant list, the
    annotations, each cohort's sumstats and each distinct schema's .var
    matching (against the annotations' denylist). Returns the E2E_TEXT
    record."""
    from vilma_tpu_torch.io import load
    seconds = {}

    def timed(key, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t
        return out

    variants = timed('variants', load.load_variant_list, args.extract)
    _, denylist = timed('annotations', load.load_annotations,
                        args.annotations, variants)
    for path in args.sumstats.split(','):
        timed('sumstats', load.load_sumstats, path, variants)
    for schema in dict.fromkeys(args.ld_schema.split(',')):
        timed('var', lambda: sum(1 for _ in load.matched_schema_entries(
            schema, variants, denylist)))
    seconds['text'] = sum(seconds.values())
    return dict(tag=tag, snps=len(variants), seconds=seconds,
                rss_gib=_vm_hwm_gib())


class Stages:
    """Wraps the functions fit's main calls and accumulates their
    seconds (see the module docstring)."""

    def __init__(self, device, stop_after=None):
        self.device = device
        self.stop_after = stop_after
        self.s = dict(text_files=0.0, var_text=0.0, ld_read=0.0,
                      ld_eigh=0.0, pack=0.0, ld=0.0, model=0.0, init=0.0,
                      npz=0.0, tsv=0.0)
        self.mark = {}
        self.step_t = []
        self.vi = None
        self.u_dtype = None
        self.peak = {}
        self.rss = {}
        self._undo = []

    def _sync(self):
        import torch
        if self.device == 'cuda':
            torch.cuda.synchronize()

    def _peak(self, tag):
        import torch
        if self.device == 'cuda':
            torch.cuda.synchronize()
            self.peak[tag] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()

    def _patch(self, owner, name, make):
        real = getattr(owner, name)
        setattr(owner, name, make(real))
        self._undo.append((owner, name, real))

    def _timed(self, key, sync=False):
        def make(real):
            def wrapped(*a, **k):
                if sync:
                    self._sync()
                t = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    if sync:
                        self._sync()
                    self.s[key] += time.perf_counter() - t
            return wrapped
        return make

    def install(self):
        from vilma_tpu_torch.inference import engine
        from vilma_tpu_torch.io import load
        from vilma_tpu_torch.ops import blocks, lowrank
        for name in ('load_variant_list', 'load_annotations',
                     'load_sumstats'):
            self._patch(load, name, self._timed('text_files'))
        self._patch(load, 'load_ld_mat', self._timed('ld_read'))
        self._patch(lowrank, 'factor_block', self._timed('ld_eigh'))
        self._patch(blocks, 'pack', self._timed('pack', sync=True))
        self._patch(engine.MultiPopVI, '__init__',
                    self._timed('model', sync=True))
        self._patch(engine.MultiPopVI, '_initialize',
                    self._timed('init', sync=True))
        self._patch(engine, 'write_npz_all_ranks', self._timed('npz'))
        self._patch(load.Table, 'to_tsv', self._timed('tsv'))

        def entries(real):
            def wrapped(*a, **k):
                it = real(*a, **k)
                while True:
                    t = time.perf_counter()
                    try:
                        entry = next(it)
                    except StopIteration:
                        return
                    finally:
                        self.s['var_text'] += time.perf_counter() - t
                    yield entry
            return wrapped
        self._patch(load, 'matched_schema_entries', entries)

        def ld_load(real):
            def wrapped(*a, **k):
                t = time.perf_counter()
                out = real(*a, **k)
                self._sync()
                self.s['ld'] += time.perf_counter() - t
                self._peak('load')
                self.mark['loaded'] = time.perf_counter()
                self.u_dtype = str(out[0].buckets[0].u.dtype)
                self.rss['load'] = _vm_hwm_gib()
                return out
            return wrapped
        self._patch(load, 'load_ld_from_schema', ld_load)

        def optimize(real):
            def wrapped(vi, *a, **k):
                self.vi = vi
                try:
                    return real(vi, *a, **k)
                finally:
                    self._sync()
                    self.mark['optimized'] = time.perf_counter()
                    self._peak('iterations')
            return wrapped
        self._patch(engine.MultiPopVI, 'optimize', optimize)

        def outer_step(real):
            def wrapped(*a, **k):
                if not self.step_t:
                    self._sync()
                    self._peak('setup')
                    self.rss['setup'] = _vm_hwm_gib()
                if (self.stop_after is not None
                        and len(self.step_t) == self.stop_after):
                    raise _Stop()
                self.step_t.append(time.perf_counter())
                return real(*a, **k)
            return wrapped
        self._patch(engine, 'outer_step', outer_step)

    def uninstall(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo.clear()


def state_form(vi):
    if vi is None:
        return None
    if not vi._compact:
        return 'materialized'
    if vi._epoch:
        return 'epoch'
    return 'kdim' if vi.scale_se else 'shared'


def launch_counts():
    """The kernels' launch counters (the matvec's cluster and group
    routes, the compact kernels by name), read as they stand."""
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    counts = dict(bucket_matvec_multi=block_matvec.launches,
                  bucket_matvec_multi_group=block_matvec.launches_group)
    counts.update(compact_obj.launches)
    return counts


def live_epochs(vi):
    """The epoch-history state's live epochs at the end of the run."""
    if vi is None or vi.state is None or not vi._epoch:
        return None
    return int(vi._states(vi.state)[0].nat_hist_n)


def written(prefix):
    """Bytes of each output file, and of each .npz member."""
    out = {}
    if os.path.exists(prefix + '.npz'):
        with zipfile.ZipFile(prefix + '.npz') as z:
            out['npz'] = {i.filename[:-4]: i.file_size for i in z.infolist()}
        out['npz_file'] = os.path.getsize(prefix + '.npz')
    for ext in ('.estimates.tsv', '.covariance.pkl'):
        if os.path.exists(prefix + ext):
            out[ext[1:]] = os.path.getsize(prefix + ext)
    return out


def run(cli, tag='fit', stop_after=None):
    """Run `fit` with the CLI argv `cli` (from 'fit' on) under the stage
    wrappers, print the E2E_RECKON and E2E lines, and return the E2E
    record; None when the reckoned outputs do not fit on the disk."""
    import torch
    from vilma_tpu_torch import frontend
    parser, _ = frontend.build_parser()
    args = parser.parse_args(cli)
    n, K, members = reckon_outputs(args)
    out_dir = os.path.dirname(os.path.abspath(args.output))
    free = shutil.disk_usage(out_dir).free
    need = sum(members.values())
    reckon = dict(tag=tag, snps=n, K=K, members=members, need_bytes=need,
                  free_bytes=free)
    print('E2E_RECKON ' + json.dumps(reckon), flush=True)
    if stop_after is None and need > free:
        print(f'{tag}: the outputs need {need} bytes, the disk has {free} '
              'free: not run', flush=True)
        return None

    device = args.device
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    stages = Stages(device, stop_after)
    before = launch_counts()
    stages.install()
    t0 = time.perf_counter()
    stopped = False
    try:
        frontend.main(cli)
    except _Stop:
        stopped = True
    finally:
        stages.uninstall()
    t_end = time.perf_counter()
    stages._peak('after_stop' if stopped else 'output')
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v > before[k]}
    s = stages.s
    m = stages.mark
    steps = stages.step_t
    first = steps[0] if steps else t_end
    ends = steps[1:] + [m.get('optimized', t_end)]
    per_it = [b - a for a, b in zip(steps, ends)]
    seconds = dict(
        total=t_end - t0,
        text=s['text_files'] + s['var_text'],
        text_files=s['text_files'], var_text=s['var_text'],
        ld_load_and_pack=s['ld'] - s['var_text'],
        ld_read=s['ld_read'], ld_eigh=s['ld_eigh'], pack=s['pack'],
        setup=first - m.get('loaded', first),
        model=s['model'], init=s['init'],
        iterations=(m.get('optimized', t_end) - first) if steps else 0.0,
        output=(t_end - m['optimized']) if 'optimized' in m and not stopped
        else 0.0,
        npz=s['npz'], tsv=s['tsv'])
    vi = stages.vi
    its = len(steps)
    line = dict(
        tag=tag, snps=n, K=vi.num_mix if vi is not None else K,
        state=state_form(vi), u_dtype=stages.u_dtype,
        precision=_precision(args), seconds=seconds, iterations=its,
        end=('stopped' if stopped else 'capped' if its >= args.num_its
             else 'converged'),
        s_per_it_first10=(float(np.mean(per_it[:10])) if per_it else None),
        s_per_it_rest=(float(np.mean(per_it[10:])) if len(per_it) > 10
                       else None),
        s_per_it_tenths=[float(np.mean(c)) for c in
                         np.array_split(per_it, min(10, len(per_it)))],
        live_epochs=live_epochs(vi),
        launches=launches,
        launches_per_step={k: v / max(its, 1) for k, v in launches.items()},
        written=written(args.output), reckoned=members,
        rss_gib=dict(stages.rss, end=_vm_hwm_gib()),
        device_peak_gib=stages.peak)
    print('E2E ' + json.dumps(line), flush=True)
    return line


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if 'fit' not in argv:
        raise SystemExit('usage: e2e_fit_torch.py [--tag NAME] '
                         '[--stop-after N] [--text-only] fit <fit options>')
    cut = argv.index('fit')
    own = argparse.ArgumentParser()
    own.add_argument('--tag', default='fit')
    own.add_argument('--stop-after', type=int, default=None)
    own.add_argument('--text-only', action='store_true')
    opts = own.parse_args(argv[:cut])
    cli = argv[cut:]
    if opts.text_only:
        from vilma_tpu_torch import frontend
        args = frontend.build_parser()[0].parse_args(cli)
        print('E2E_TEXT ' + json.dumps(text_only(args, opts.tag)),
              flush=True)
        return 0
    return 0 if run(cli, opts.tag, opts.stop_after) is not None else 1


if __name__ == '__main__':
    sys.exit(main())
