from bigdl_torch.nn import criterion, layer  # noqa: F401
