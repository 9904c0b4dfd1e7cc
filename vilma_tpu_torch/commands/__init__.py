"""The subcommands of vilma-tpu-torch, one module each."""
import torch


def resolve_device(name):
    """The torch device of a subcommand's --device: cuda raises without a
    card; nothing falls back to the host."""
    if name == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda needs a CUDA device; pass '
                           '--device cpu to run on the host')
    return torch.device(name)
