"""Shared helpers of the port's parity tests: the JAX package's arrays,
as numpy, handed to vilma_tpu_torch through its convert module."""
import numpy as np
import torch

from vilma_tpu_torch import convert

# tier-1 runs the suite under xdist workers; one intra-op thread each
torch.set_num_threads(1)

BUCKET_LEAVES = ('u', 's', 'inv_s', 'd', 'perm', 'seq')


def ld_to_torch(ld):
    """A JAX PackedLD as the port's PackedLD."""
    buckets = [{k: np.asarray(getattr(bk, k)) for k in BUCKET_LEAVES}
               for bk in ld.buckets]
    return convert.packed_ld_from_numpy(buckets, ld.n, ld.has_diag,
                                        ld.rank, ld.missing)


def data_to_torch(data):
    """A JAX ModelData as the port's ModelData."""
    fields = {name: np.asarray(getattr(data, name))
              for name in convert.MODEL_DATA_FIELDS}
    return convert.model_data_from_numpy(
        fields, [ld_to_torch(ld) for ld in data.ld], data.num_annotations,
        data.scale_se, data.ld_index)


def state_to_torch(st):
    """A JAX VIState (compact: shared, kdim or epoch-history; or
    materialized) as the port's VIState."""
    extra = {}
    if st.nat_hist is not None:
        extra = dict(nat_hist=np.asarray(st.nat_hist),
                     nat_hist_scale=np.asarray(st.nat_hist_scale),
                     nat_hist_c=np.asarray(st.nat_hist_c),
                     nat_hist_n=int(st.nat_hist_n))
    if st.nat_mu is None:
        extra = dict(
            vi_mu=np.asarray(st.vi_mu), vi_delta=np.asarray(st.vi_delta),
            nat_grad_vi_delta=np.asarray(st.nat_grad_vi_delta),
            sigma={f: np.asarray(getattr(st.sigma, f))
                   for f in ('log_det_sigma', 'sigma_summary', 'diag',
                             'matches')})
    return convert.state_from_numpy(
        None if st.nat_mu is None else np.asarray(st.nat_mu),
        np.asarray(st.hyper_delta), np.asarray(st.error_scaling),
        np.asarray(st.L), float(st.elbo), float(st.running_elbo_delta),
        int(st.num_err), **extra)


def t2n(x):
    return x.detach().cpu().numpy()
