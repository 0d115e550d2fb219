"""Parallelism of the port beyond ``DistriOptimizer``'s data plane
(counterpart of ``bigdl_tpu.parallel``).

* :mod:`~bigdl_tpu_torch.parallel.wire`: the compressed-collective
  layer, one :class:`WireSpec` (bfloat16 / int8 / fp8 with blockwise
  scales and error feedback) behind ``reduce_scatter``, ``psum``,
  ``all_to_all`` and ``ppermute`` over a ``torch.distributed`` group,
  used by ``DistriOptimizer``'s gradient exchange.

Ring attention, Ulysses, tensor parallelism, the pipeline and MoE of
the JAX package are not ported yet (ROADMAP.md queue 1 item 11).
"""

from bigdl_tpu_torch.parallel import wire  # noqa: F401
from bigdl_tpu_torch.parallel.wire import WireSpec  # noqa: F401

__all__ = ["wire", "WireSpec"]
