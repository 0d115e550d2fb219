from bigdl_torch.optim import optimizer  # noqa: F401
