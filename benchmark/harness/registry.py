"""Finding a cell's files by name. Nothing of a cell, a traffic mix or a
metric is written into the harness's code: a later cell or metric is a
file added beside the others.

* a cell `<config>.<traffic>` (the configuration's name holds no '.')
  reads configs/<config>.json, traffic/<traffic>.json and
  limits/<config>.<traffic>.json (the limits of its compared numbers);
* a metric `<name>` is metrics/<name>.py: a module with KIND
  ('end_to_end' or 'per_layer'), UNIT, and read(run), which returns the
  metric's value or None where the run has nothing for it to read.
"""
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def cell(workload):
    """{'name', 'config', 'traffic', 'limits'} of a cell."""
    config, dot, traffic = workload.partition('.')
    if not dot or not config or not traffic:
        raise ValueError(f'a workload is <config>.<traffic>: {workload!r}')
    return dict(name=workload, config=_json('configs', config + '.json'),
                traffic=_json('traffic', traffic + '.json'),
                limits=_json('limits', workload + '.json'))


def metrics(kind):
    """{name: module} of every metric of `kind`, by file name."""
    folder = os.path.join(ROOT, 'metrics')
    out = {}
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith('.py') or fname.startswith('_'):
            continue
        name = fname[:-3]
        spec = importlib.util.spec_from_file_location(
            f'bench_metric_{name}', os.path.join(folder, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.KIND == kind:
            out[name] = mod
    return out
