"""«py»/nn/layer.py shim — every layer under its classic name.

``Layer`` is the module base with the stateful BigDL API
(``forward``/``backward`` are ``update_output``/``backward`` there;
``forward`` itself is torch's), ``Model`` the graph constructor
(functional API), as in Python-BigDL."""

from bigdl_tpu_torch.nn import *  # noqa: F401,F403
from bigdl_tpu_torch.nn import Graph, Input, Model, Sequential  # noqa: F401
from bigdl_tpu_torch.nn.module import AbstractModule as Layer  # noqa: F401
