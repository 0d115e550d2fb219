"""Parallelism of the port beyond ``DistriOptimizer``'s data plane
(counterpart of ``bigdl_tpu.parallel``).  Each process is one rank of a
mesh (``Engine.build_mesh``); where the JAX package lets GSPMD insert
collectives over a device mesh, the port's are explicit, over the
axes' ``torch.distributed`` groups.

* :mod:`~bigdl_tpu_torch.parallel.wire`: the compressed-collective
  layer, one :class:`WireSpec` (bfloat16 / int8 / fp8 with blockwise
  scales and error feedback) behind ``reduce_scatter``, ``psum``,
  ``all_to_all`` and ``ppermute`` over a ``torch.distributed`` group,
  used by ``DistriOptimizer``'s gradient exchange and the opt-in wires
  of the paths below;
* :mod:`~bigdl_tpu_torch.parallel.ring`: ring attention, K/V rotating
  over the wire's ``ppermute`` with an online softmax;
* :mod:`~bigdl_tpu_torch.parallel.ulysses`: Ulysses attention, the
  sequence resharded onto heads by the wire's ``all_to_all``;
* :mod:`~bigdl_tpu_torch.parallel.tensor_parallel`: Megatron's layout
  as (path regex, spec) rules, each rank's local shards, the TP forward
  of ``TransformerLM`` over them, and the wire's all-reduce for TP
  gradients;
* :mod:`~bigdl_tpu_torch.parallel.pipeline`: the collective-permute
  pipeline over stages of one shape;
* :mod:`~bigdl_tpu_torch.parallel.moe`: the GShard-style MoE layer, its
  experts split over an ``expert`` axis.
"""

from bigdl_tpu_torch.parallel import (moe, pipeline, ring,  # noqa: F401
                                      tensor_parallel, ulysses, wire)
from bigdl_tpu_torch.parallel.moe import MoE  # noqa: F401
from bigdl_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, pipelined)
from bigdl_tpu_torch.parallel.ring import (  # noqa: F401
    RingMultiHeadAttention, ring_attention, ring_attention_sharded)
from bigdl_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    TRANSFORMER_TP_RULES, constrain, gradient_psum, param_specs,
    shard_params, wire_psum)
from bigdl_tpu_torch.parallel.ulysses import (  # noqa: F401
    UlyssesMultiHeadAttention, ulysses_attention, ulysses_attention_sharded)
from bigdl_tpu_torch.parallel.wire import WireSpec  # noqa: F401

__all__ = ["wire", "WireSpec", "ring", "ulysses", "tensor_parallel",
           "pipeline", "moe", "ring_attention", "ring_attention_sharded",
           "RingMultiHeadAttention", "ulysses_attention",
           "ulysses_attention_sharded", "UlyssesMultiHeadAttention",
           "shard_params", "constrain", "param_specs", "gradient_psum",
           "wire_psum", "TRANSFORMER_TP_RULES", "pipeline_apply",
           "pipelined", "MoE"]
