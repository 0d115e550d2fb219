from bigdl_torch.keras import converter  # noqa: F401
