from bigdl_torch.transform.vision import image  # noqa: F401
