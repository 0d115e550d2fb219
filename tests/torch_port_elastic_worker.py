"""A child trainer for ``tests/test_torch_port_elastic.py`` (not a test
module itself):

    python tests/torch_port_elastic_worker.py MODE CK OUT

trains ``small_model`` with ``DistriOptimizer`` at world 1 on the CPU
(the int8 wire with error feedback, SGD with momentum, 64 rows in
batches of 8 without shuffling, 2 epochs, a checkpoint every epoch into
CK).  MODE ``"plain"`` runs to the end; ``"preempt"`` prints ``STEP 3``
when step 3's loss is read and holds there until a SIGTERM has arrived
(the parent sends it), so the next step boundary takes the preemption
path: an emergency checkpoint into CK and exit code 170; ``"resume"``
resumes from CK's newest checkpoint through ``restore_latest``.  The
final parameters, BN state and optimizer state go to the npz OUT.
Imports neither JAX nor the JAX package.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_port_distri_worker as W  # noqa: E402

from bigdl_tpu_torch import nn as TN  # noqa: E402
from bigdl_tpu_torch import optim as TO  # noqa: E402
from bigdl_tpu_torch.common import RandomGenerator  # noqa: E402
from bigdl_tpu_torch.dataset import ArrayDataSet  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.resilience import elastic  # noqa: E402
from bigdl_tpu_torch.utils import tree as T  # noqa: E402

HOLD_AT = 3


class Hold:
    """A train summary that, in ``"preempt"`` mode, announces step
    ``HOLD_AT`` and waits for the preemption request."""

    def __init__(self, hold: bool):
        self.hold = hold

    def add_scalar(self, tag, value, step):
        if self.hold and tag == "Loss" and step == HOLD_AT:
            print(f"STEP {step}", flush=True)
            deadline = time.time() + 60
            while not elastic.preemption_requested():
                if time.time() > deadline:
                    raise RuntimeError("no SIGTERM arrived")
                time.sleep(0.01)

    def get_summary_trigger(self, name):
        return None


def main(mode, ck, out):
    x, y = W.data(64)
    RandomGenerator.RNG.set_seed(4)
    model = W.small_model(TN)
    opt = TO.DistriOptimizer(model, ArrayDataSet(x, y, 8, shuffle=False),
                             TN.ClassNLLCriterion(), 8, device="cpu",
                             **W.CKPT_KW)
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
    opt.set_end_when(TO.Trigger.max_epoch(2))
    opt.set_checkpoint(ck, TO.Trigger.every_epoch())
    opt.set_train_summary(Hold(mode == "preempt"))
    if mode == "resume":
        extra = elastic.restore_latest(opt)
        print(f"RESUMED {extra['neval']}", flush=True)
    opt.optimize()
    arrays = {f"p{i}": v.detach().numpy()
              for i, v in enumerate(T.leaves(model.params()))}
    arrays.update({f"s{i}": v.detach().numpy()
                   for i, v in enumerate(T.leaves(model.state()))})
    arrays.update({f"opt_{k}": v.numpy()
                   for k, v in opt.optim_method.state.items()})
    np.savez(out, **arrays)


if __name__ == "__main__":
    try:
        main(*sys.argv[1:4])
    finally:
        # the process group goes before the interpreter (a preempted
        # run too: SystemExit passes through here with code 170)
        Engine.reset()
