from bigdl_torch.dlframes import dl_classifier  # noqa: F401
