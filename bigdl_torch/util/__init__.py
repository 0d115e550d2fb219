from bigdl_torch.util import common  # noqa: F401
