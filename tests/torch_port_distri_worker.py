"""One rank of the port's DistriOptimizer for
``tests/test_torch_port_distri.py`` (not a test module itself):

    python tests/torch_port_distri_worker.py RANK WORLD STORE OUT CASE

joins a gloo world of WORLD processes over the ``FileStore`` STORE,
trains the case's model and writes each step's loss, the final
parameters and BN state (JAX leaf order) and the optimizer state to
the npz OUT.  Imports neither JAX nor the JAX package.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bigdl_tpu_torch import nn as TN  # noqa: E402
from bigdl_tpu_torch import optim as TO  # noqa: E402
from bigdl_tpu_torch.common import RandomGenerator  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, DistributedDataSet  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.utils import tree as T  # noqa: E402

# the batch sizes of the "array" case: the last is padded to the world
# and masked
SIZES = (8, 8, 5)


def small_model(N):
    return N.Sequential() \
        .add(N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(N.SpatialBatchNormalization(4)).add(N.ReLU()) \
        .add(N.SpatialAveragePooling(8, 8, 1, 1, global_pooling=True)) \
        .add(N.Reshape([4])).add(N.Linear(4, 3)).add(N.LogSoftMax())


def data(n=22):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 3, 8, 8).astype(np.float32),
            (rs.randint(0, 3, n) + 1).astype(np.float32))


class Batches(DataSet):
    """Fixed batches of SIZES rows, in order (every rank sees the global
    batch)."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def size(self):
        return sum(SIZES)

    def data(self, train=True):
        off = 0
        for b in SIZES:
            yield self.x[off:off + b], self.y[off:off + b]
            off += b


class Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value


def run(rank, world, store, out, case):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    x, y = data()
    RandomGenerator.RNG.set_seed(4)
    model = small_model(TN)
    if case == "array":
        ds = Batches(x, y)
    else:
        ds = DistributedDataSet(x, y, 8, shuffle=True)
    opt = TO.DistriOptimizer(model, ds, TN.ClassNLLCriterion(), 8,
                             wire_dtype="float32", device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9,
                                weightdecay=1e-3))
    opt.set_gradient_clipping_by_l2_norm(1.5)
    opt.set_end_when(TO.Trigger.max_epoch(2))
    losses = Losses()
    opt.set_train_summary(losses)
    RandomGenerator.RNG.set_seed(9)
    opt.optimize()
    arrays = {f"p{i}": v.detach().numpy()
              for i, v in enumerate(T.leaves(model.params()))}
    arrays.update({f"s{i}": v.detach().numpy()
                   for i, v in enumerate(T.leaves(model.state()))})
    arrays["velocity"] = opt.optim_method.state["velocity"].numpy()
    arrays["losses"] = np.asarray([losses.loss[n]
                                   for n in sorted(losses.loss)])
    np.savez(out, **arrays)
    Engine.reset()
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
