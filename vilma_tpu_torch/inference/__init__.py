from vilma_tpu_torch.inference.engine import MultiPopVI  # noqa: F401
