"""vilma_tpu_torch: the PyTorch + CUDA port of vilma_tpu.

The JAX package `vilma_tpu` stays the reference; this package mirrors its
module layout (ops/, models/, inference/, io/, commands/) so each
counterpart is easy to find. It imports torch and never jax, pandas or
ml_dtypes. The hot kernels are hand-written CUDA for Hopper
(vilma_tpu_torch/csrc), built with nvcc at first use on a CUDA device;
on CPU tensors every kernel wrapper runs its plain PyTorch version.

Importing the package is cheap: subpackages load on first use.
"""

VERSION = '0.1.0'
