"""The most device memory the program held (torch.cuda.max_memory_allocated
from the pack on, set-up included, read as the window closes; the
benchmark's own inputs wait on the host by then), in GiB. Whether a fit
fits on one card."""
KIND = 'end_to_end'
UNIT = 'GiB'


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
