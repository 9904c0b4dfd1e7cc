from setuptools import setup, find_packages

from vilma_tpu import VERSION

setup(
    name='vilma_tpu',
    version=VERSION,
    description='TPU-native variational inference of variant effect sizes '
                'and effect-size distributions from GWAS summary data',
    packages=find_packages(exclude=('tests',)),
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'numpy',
        'pandas>=1.2.1',
        'h5py>=3.6.0',
    ],
    extras_require={
        # gradient-/MCMC-based posterior validation tooling
        'validation': ['optax'],
        # the PyTorch + CUDA port (vilma_tpu_torch); its kernels build
        # from the shipped csrc/*.cu with nvcc at first use on a card
        'torch': ['torch'],
    },
    package_data={'vilma_tpu_torch': ['csrc/*.cu']},
    entry_points={
        'console_scripts': ['vilma-tpu=vilma_tpu.frontend:main',
                            'vilma-tpu-torch=vilma_tpu_torch.frontend:main'],
    },
)
