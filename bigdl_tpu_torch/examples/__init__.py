"""Example scripts of the port (counterparts of the repo's ``examples/``),
run as ``python -m bigdl_tpu_torch.examples.<name>``."""
