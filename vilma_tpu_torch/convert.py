"""Carry a parameter point of the JAX package into the port.

The functions take the JAX package's arrays as numpy (np.asarray of each
leaf) and build the port's objects on `device`, so both packages can be
fed the same point. bfloat16 eigenvectors arrive as ml_dtypes arrays;
their bits are reinterpreted without importing ml_dtypes.
"""
import dataclasses
import math

import numpy as np
import torch

from vilma_tpu_torch.inference.engine import ModelData, VIState
from vilma_tpu_torch.models.sigma import SigmaSummaries
from vilma_tpu_torch.ops.blocks import BlockBucket, PackedLD


def tensor_from_numpy(array, device='cpu'):
    """A torch tensor with the array's values and dtype (bfloat16
    included)."""
    array = np.ascontiguousarray(array)
    if array.dtype.name == 'bfloat16':
        bits = torch.from_numpy(array.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(array.copy()).to(device)


def packed_ld_from_numpy(buckets, n, has_diag, rank, missing,
                         device='cpu'):
    """PackedLD from bucket leaves: `buckets` is a sequence of mappings
    with keys u, s, inv_s, d, perm and optionally seq (numpy arrays)."""
    out = []
    for bk in buckets:
        out.append(BlockBucket(
            u=tensor_from_numpy(bk['u'], device),
            s=tensor_from_numpy(bk['s'], device),
            inv_s=tensor_from_numpy(bk['inv_s'], device),
            d=tensor_from_numpy(bk['d'], device),
            perm=tensor_from_numpy(np.asarray(bk['perm'], dtype=np.int64),
                                   device),
            seq=(tensor_from_numpy(np.asarray(bk['seq'], dtype=np.int64),
                                   device) if 'seq' in bk else None)))
    return PackedLD(buckets=tuple(out), n=int(n), has_diag=bool(has_diag),
                    rank=float(rank), missing=tuple(int(m) for m in missing))


MODEL_DATA_FIELDS = ('marginal_effects', 'std_errs', 'scalings',
                     'ld_diags', 'scaled_ld_diags', 'adj_marginal_effects',
                     'chi_stat', 'ld_ranks', 'inverse_betas', 'annotations',
                     'annotation_counts', 'mixture_prec', 'log_det')


def model_data_from_numpy(fields, ld, num_annotations, scale_se, ld_index,
                          device='cpu'):
    """ModelData from every field as numpy (`fields` maps the names of
    ModelData's tensor fields to arrays); `ld` is a sequence of PackedLD
    (see packed_ld_from_numpy)."""
    tensors = {}
    for name in MODEL_DATA_FIELDS:
        arr = np.asarray(fields[name])
        if name == 'annotations':
            arr = arr.astype(np.int32)
        tensors[name] = tensor_from_numpy(arr, device)
    return ModelData(ld=tuple(ld), num_annotations=int(num_annotations),
                     scale_se=bool(scale_se),
                     ld_index=tuple(int(i) for i in ld_index), **tensors)


def state_from_numpy(nat_mu, hyper_delta, error_scaling, L, elbo,
                     running_elbo_delta, num_err, nat_hist=None,
                     nat_hist_scale=None, nat_hist_c=None, nat_hist_n=None,
                     vi_mu=None, vi_delta=None, nat_grad_vi_delta=None,
                     sigma=None, device='cpu'):
    """A VIState from numpy. Compact states: nat_mu is the shared [P, I]
    or the kdim [K, P, I] natural mean, or, with the nat_hist* arrays,
    the current-epoch accumulator of an epoch-history state. The
    materialized state: nat_mu is None and vi_mu [K, P, I], vi_delta
    [K, I], nat_grad_vi_delta [K-1, I] and `sigma` (a mapping of the
    SigmaSummaries fields) are given."""
    def t(x):
        return None if x is None else tensor_from_numpy(x, device)

    extra = {}
    if nat_hist is not None:
        extra = dict(nat_hist=t(nat_hist), nat_hist_scale=t(nat_hist_scale),
                     nat_hist_c=t(nat_hist_c), nat_hist_n=int(nat_hist_n))
    if nat_mu is None:
        extra = dict(vi_mu=t(vi_mu), vi_delta=t(vi_delta),
                     nat_grad_vi_delta=t(nat_grad_vi_delta),
                     sigma=SigmaSummaries(**{
                         f.name: t(sigma[f.name])
                         for f in dataclasses.fields(SigmaSummaries)}))
    return VIState(
        nat_mu=t(nat_mu),
        hyper_delta=t(hyper_delta),
        error_scaling=t(error_scaling),
        L=tuple(float(x) for x in np.asarray(L)),
        elbo=float(elbo),
        running_elbo_delta=(math.nan if running_elbo_delta is None
                            else float(running_elbo_delta)),
        num_err=int(num_err), **extra)
