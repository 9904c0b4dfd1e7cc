"""The share of U's bytes on the card that is zero pad: 100 x (the
bytes the packed buckets hold - the bytes of the configuration's real
blocks, each block_size rows by its rank at U's stored type) / the bytes
held (harness/widths.py). Read from the buckets' shapes, so a parent and
a change that pack alike read alike. Moves device_peak_gib."""
from harness import widths

KIND = 'per_layer'
UNIT = '%'


def read(run):
    return widths.u_pad_pct(run.shapes['buckets'], run.cell['config'])
