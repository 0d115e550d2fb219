"""One rank of the port's DistriOptimizer for
``tests/test_torch_port_optim_methods.py`` (not a test module itself):

    python tests/torch_port_methods_worker.py RANK WORLD STORE OUTDIR

joins a gloo world of WORLD processes over the ``FileStore`` STORE and
trains ``mlp`` with each method of ``CASES`` in turn (2 epochs of
``SIZES`` batches), writing each step's loss, the final parameters
(JAX leaf order) and the gathered optimizer state to
``OUTDIR/<case>.rank<RANK>.npz``; LBFGS must refuse a world above 1.
Imports neither JAX nor the JAX package; the tests build the same
cases from the JAX package's classes.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from bigdl_tpu_torch import nn as TN  # noqa: E402
from bigdl_tpu_torch import optim as TO  # noqa: E402
from bigdl_tpu_torch.common import RandomGenerator  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.utils import tree as T  # noqa: E402

SIZES = (8, 8, 8)


def decay(epoch):
    """``EpochDecay``'s exponent: the rate falls by √10 an epoch."""
    return 0.5 * epoch


# each method built from either package's optim module
CASES = {
    "adam": lambda M: M.Adam(learningrate=0.01, learningrate_decay=0.1),
    "adagrad": lambda M: M.Adagrad(learningrate=0.1, weightdecay=1e-3),
    "adadelta": lambda M: M.Adadelta(decayrate=0.9, epsilon=1e-6),
    "adamax": lambda M: M.Adamax(learningrate=0.01),
    "rmsprop": lambda M: M.RMSprop(learningrate=0.01,
                                   learningrate_decay=0.1),
    "ftrl": lambda M: M.Ftrl(learningrate=0.1, l1_regularization_strength=1e-3,
                             l2_regularization_strength=1e-2,
                             l2_shrinkage_regularization_strength=1e-2),
    # a history of 4 pairs, so 6 steps also drop the oldest
    "lbfgs": lambda M: M.LBFGS(learningrate=0.1, ncorrection=4),
    "larssgd": lambda M: M.LarsSGD(learningrate=0.5, trust_coefficient=0.02,
                                   momentum=0.9, weightdecay=1e-3),
    "sgd_step": lambda M: M.SGD(learningrate=0.1, momentum=0.9,
                                learningrate_schedule=M.Step(2, 0.5)),
    "sgd_exponential": lambda M: M.SGD(
        learningrate=0.1, learningrate_schedule=M.Exponential(3, 0.5)),
    "sgd_epochdecay": lambda M: M.SGD(
        learningrate=0.1, learningrate_schedule=M.EpochDecay(decay)),
}


def mlp(N):
    return N.Sequential().add(N.Linear(6, 8)).add(N.Tanh()) \
        .add(N.Linear(8, 3)).add(N.LogSoftMax())


def data(n=sum(SIZES)):
    rs = np.random.RandomState(3)
    return (rs.randn(n, 6).astype(np.float32),
            (rs.randint(0, 3, n) + 1).astype(np.float32))


class Batches(DataSet):
    """Fixed batches of SIZES rows, in order."""

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


def train(case, ds):
    RandomGenerator.RNG.set_seed(4)
    model = mlp(TN)
    opt = TO.DistriOptimizer(model, ds, TN.ClassNLLCriterion(), 8,
                             wire_dtype="float32", device="cpu")
    opt.set_optim_method(CASES[case](TO))
    opt.set_end_when(TO.Trigger.max_epoch(2))
    losses = Losses()
    opt.set_train_summary(losses)
    opt.optimize()
    return model, opt, losses


def run(rank, world, store, outdir):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    x, y = data()
    for case in CASES:
        if case == "lbfgs":
            try:
                train(case, Batches(x, y))
            except NotImplementedError as e:
                assert "world 1 only" in str(e), e
                continue
            raise AssertionError("LBFGS trained at world > 1")
        model, opt, losses = train(case, Batches(x, y))
        arrays = {f"p{i}": v.detach().numpy()
                  for i, v in enumerate(T.leaves(model.params()))}
        arrays.update({f"opt/{k}": v for k, v in
                       opt.optim_method.get_state_arrays().items()})
        arrays["losses"] = np.asarray([losses.loss[n]
                                       for n in sorted(losses.loss)])
        np.savez(os.path.join(outdir, f"{case}.rank{rank}.npz"), **arrays)
    Engine.reset()
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
