"""The block matvec's group route (clusters on column panels, which the
blocks too wide for the cluster route take: csrc/block_matvec.cu
group_matvec_kernel): the least time of its calls in the window, their
bytes (U at its stored type, s, d, and x and y per cohort) and
operations counted at the configuration's real block widths
(harness/widths.py), not the padded buckets', at 3.35 TB/s, over the
device time of the kernels named group_matvec_kernel. So a change of
the pack's tiers moves the time, not the bound. Silent where no group
kernel ran. Moves vi_steps_per_s."""
from harness import widths

KIND = 'per_layer'
UNIT = '%'


def _is_group(B, pmax, rmax, itemsize, C):
    """Whether the program's matvec planner puts a bucket shape on the
    group route."""
    from vilma_tpu_torch.ops.cuda import block_matvec
    return block_matvec.plan(pmax, rmax, itemsize,
                             block_matvec.width(C)).route == 'group'


def read(run):
    if run.trace is None:
        return None
    secs = sum(t for name, t in run.trace['device_ops']
               if name.startswith('group_matvec_kernel'))
    if secs <= 0:
        return None
    work = widths.group_work(run.shapes, run.totals, run.cell['config'],
                             _is_group)
    if work is None or work[2] <= 0:
        return None
    return 100.0 * work[2] / secs
