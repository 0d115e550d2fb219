"""«py»/transform/vision/image.py shim — vision transforms."""

from bigdl_tpu_torch.transform.vision import *  # noqa: F401,F403
