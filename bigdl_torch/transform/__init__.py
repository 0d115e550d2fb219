from bigdl_torch.transform import vision  # noqa: F401
