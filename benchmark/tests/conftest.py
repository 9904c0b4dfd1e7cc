"""Helpers of the benchmark's CPU tests: the harness on sys.path, and a
cell cut to a size the CPU runs in seconds (the same code paths: a bank
of 3 blocks of 256 SNPs and a shorter last block, 42 components)."""
import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (REPO, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

torch.set_num_threads(2)


def tiny_cell(workload='hm3_1m.default', config=None, traffic=None):
    """A registered cell at a CPU test's size."""
    from harness import registry
    cell = registry.cell(workload)
    cell['config'] = dict(cell['config'], num_snps=1100, block_size=256,
                          bank_blocks=3, **(config or {}))
    cell['traffic'] = dict(cell['traffic'], components=2, **(traffic or {}))
    return cell


def run_cpu(cell, seed=20260101, seconds=1.0, control=False):
    """One run of `cell` on the CPU (the chip's look skipped)."""
    import run
    return run.execute(cell, seed, seconds, 0, 'cpu', control=control)


@pytest.fixture
def epoch_state(monkeypatch):
    """--learn-scaling fits take the epoch-history state at any size, as
    they do at 1M and 6M SNPs."""
    from vilma_tpu_torch.inference import engine
    monkeypatch.setattr(engine, '_EPOCH_STATE_BYTES', 0)
