from bigdl_tpu_torch.dataset import *  # noqa: F401,F403
from bigdl_tpu_torch.dataset import mnist, text  # noqa: F401
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample  # noqa: F401
