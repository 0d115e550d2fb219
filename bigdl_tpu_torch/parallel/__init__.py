"""Parallelism of the port beyond ``DistriOptimizer``'s data plane
(counterpart of ``bigdl_tpu.parallel``).

* :mod:`~bigdl_tpu_torch.parallel.wire`: the compressed-collective
  layer, one :class:`WireSpec` (bfloat16 / int8 / fp8 with blockwise
  scales and error feedback) behind ``reduce_scatter``, ``psum``,
  ``all_to_all`` and ``ppermute`` over a ``torch.distributed`` group,
  used by ``DistriOptimizer``'s gradient exchange;
* :mod:`~bigdl_tpu_torch.parallel.ring`: ring attention, K/V rotating
  over the wire's ``ppermute`` with an online softmax;
* :mod:`~bigdl_tpu_torch.parallel.ulysses`: Ulysses attention, the
  sequence resharded onto heads by the wire's ``all_to_all``.

Tensor parallelism, the pipeline and MoE of the JAX package are not
ported yet (ROADMAP.md queue 1, the item after sequence parallelism).
"""

from bigdl_tpu_torch.parallel import ring, ulysses, wire  # noqa: F401
from bigdl_tpu_torch.parallel.ring import (  # noqa: F401
    RingMultiHeadAttention, ring_attention, ring_attention_sharded)
from bigdl_tpu_torch.parallel.ulysses import (  # noqa: F401
    UlyssesMultiHeadAttention, ulysses_attention, ulysses_attention_sharded)
from bigdl_tpu_torch.parallel.wire import WireSpec  # noqa: F401

__all__ = ["wire", "WireSpec", "ring", "ulysses", "ring_attention",
           "ring_attention_sharded", "RingMultiHeadAttention",
           "ulysses_attention", "ulysses_attention_sharded",
           "UlyssesMultiHeadAttention"]
