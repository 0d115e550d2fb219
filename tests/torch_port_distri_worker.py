"""One rank of the port's DistriOptimizer for
``tests/test_torch_port_distri.py`` and
``tests/test_torch_port_image_frame.py`` (not a test module itself):

    python tests/torch_port_distri_worker.py RANK WORLD STORE OUT CASE

joins a gloo world of WORLD processes over the ``FileStore`` STORE,
trains the case's model and writes each step's loss, the final
parameters and BN state (JAX leaf order) and the optimizer state to
the npz OUT.  CASE ``"array"`` feeds every rank the global batch,
``"per_process"`` a ``DistributedDataSet`` and ``"frame"`` a
``DistributedImageFrame`` of ``frame_images()`` read at the world's
rank and size.  ``"wires"`` trains the array case once for each entry
of ``WIRE_CASES`` (the compressed wires, error feedback, buckets),
writing ``<i>_<name>`` arrays; ``"hier"`` does so for ``HIER_CASES``
over ``Engine.build_mesh({"dcn": 2, "data": 2})`` at world 4, and records
what ``LBFGS`` raises there.
``"ckpt"`` trains ``CKPT_KW``'s run one epoch and checkpoints it into
the directory ``OUT``; ``"resume DIR"`` resumes that run from DIR's
checkpoint for epoch 2 and writes its arrays to OUT; ``"eval"`` folds
``evaluate_dataset`` over each rank's rows of a per-process set and
writes the results; ``"health"`` trips the non-finite guard at step 3
with the health monitor every 4 steps (``health_case``);
``"wide_deep"`` trains Wide & Deep (``wide_deep_run``).  Imports
neither JAX nor the JAX package.
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
# 64 f32 elements a bucket: the small model's 135 parameters (160
# padded at block 16 and world 2) in three buckets
BUCKET_MB = 64 * 4 / 2 ** 20
# the trainer keywords of the "wires" case, in order
WIRE_CASES = [
    dict(wire_dtype="int8", wire_block=16),
    dict(wire_dtype="int8", wire_block=16, overlap_bucket_mb=BUCKET_MB),
    dict(wire_dtype="fp8_e4m3", wire_block=16),
    dict(wire_dtype="fp8_e4m3", wire_block=16, overlap_bucket_mb=BUCKET_MB),
    dict(wire_dtype="int8", wire_block=16, wire_ef=True),
    dict(wire_dtype="int8", wire_block=16, wire_ef=True,
         overlap_bucket_mb=BUCKET_MB),
]
# the "hier" case: data_axes=("dcn", "data") at 2 x 2
HIER_CASES = [
    dict(wire_dtype="float32"),
    dict(wire_dtype="float32", overlap_bucket_mb=BUCKET_MB),
]
# the checkpoint cases' run: the int8 wire with EF and two buckets
CKPT_KW = dict(wire_dtype="int8", wire_block=16, wire_ef=True,
               overlap_bucket_mb=96 * 4 / 2 ** 20)
CKPT_N = 32


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


def frame_images(n=22):
    """HWC f32 images of 8x8 and their 1-based labels (3 classes)."""
    rs = np.random.RandomState(0)
    return ([rs.rand(8, 8, 3).astype(np.float32) for _ in range(n)],
            [float(i % 3 + 1) for i in range(n)])


def frame_chain(V):
    """The transforms of the frame case, from ``V`` (either package's
    ``transform.vision``)."""
    return V.ChannelNormalize(0.5, 0.5, 0.5, 0.25, 0.25, 0.25) \
        >> V.MatToTensor()


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

    def get_summary_trigger(self, name):
        return None


def _arrays(model, opt, losses, prefix=""):
    arrays = {f"{prefix}p{i}": v.detach().numpy()
              for i, v in enumerate(T.leaves(model.params()))}
    arrays.update({f"{prefix}s{i}": v.detach().numpy()
                   for i, v in enumerate(T.leaves(model.state()))})
    for k, v in opt.optim_method.state.items():
        arrays[f"{prefix}opt_{k}"] = v.numpy()
    arrays[f"{prefix}losses"] = np.asarray([losses.loss[n]
                                            for n in sorted(losses.loss)])
    return arrays


def _wire_run(ds, kw, epochs=2):
    RandomGenerator.RNG.set_seed(4)
    model = small_model(TN)
    opt = TO.DistriOptimizer(model, ds, TN.ClassNLLCriterion(), 8,
                             device="cpu", **kw)
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9,
                                weightdecay=1e-3))
    opt.set_gradient_clipping_by_l2_norm(1.5)
    opt.set_end_when(TO.Trigger.max_epoch(epochs))
    losses = Losses()
    opt.set_train_summary(losses)
    RandomGenerator.RNG.set_seed(9)
    opt.optimize()
    return model, opt, losses


def ckpt_run(TN_, TO_, make_opt, ds, directory=None, resume=None,
             restore_latest=None):
    """The checkpoint cases' run in either package: SGD with momentum,
    one epoch checkpointed into ``directory``, or epoch 2 resumed from
    ``resume``'s newest checkpoint through ``restore_latest`` (that
    package's ``elastic.restore_latest``, the port's by default).
    ``make_opt(model, ds)`` builds the trainer."""
    model = small_model(TN_)
    opt = make_opt(model, ds)
    opt.set_optim_method(TO_.SGD(learningrate=0.2, momentum=0.9))
    losses = Losses()
    opt.set_train_summary(losses)
    if resume is None:
        opt.set_checkpoint(directory, TO_.Trigger.every_epoch())
        opt.set_end_when(TO_.Trigger.max_epoch(1))
    else:
        if restore_latest is None:
            from bigdl_tpu_torch.resilience.elastic import restore_latest
        restore_latest(opt, resume)
        opt.set_end_when(TO_.Trigger.max_epoch(2))
    opt.optimize()
    return model, opt, losses


def health_case(out):
    """The ``health`` case: ``nan_grad`` at step 3 with the health
    monitor every 4 steps, 5 steps of the small model; writes the
    health steps, the fetches, the calls of ``flat_shard_stats``, the
    layers with non-finite gradients per step and the non-finite
    counter, as JSON."""
    import json

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.obs import health as H
    from bigdl_tpu_torch.obs import names

    os.environ["BIGDL_TORCH_HEALTH_EVERY"] = "4"
    os.environ["BIGDL_TORCH_FAULT_PLAN"] = "step:3:nan_grad"
    calls = []
    orig = H.flat_shard_stats

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    H.flat_shard_stats = counted

    class Health(Losses):
        def __init__(self):
            super().__init__()
            self.health = {}

        def add_health(self, step, layers):
            self.health[step] = layers

    x, y = data(40)
    RandomGenerator.RNG.set_seed(4)
    opt = TO.DistriOptimizer(small_model(TN),
                             ArrayDataSet(x, y, 8, shuffle=False),
                             TN.ClassNLLCriterion(), 8, device="cpu",
                             wire_dtype="float32")
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(0.1)
    summary = Health()
    opt.set_train_summary(summary)
    opt.set_end_when(TO.Trigger.max_iteration(5))
    opt.optimize()
    counters = {}
    for fam in obs.get_registry().families():
        if fam.name == names.NONFINITE_LAYERS_TOTAL:
            counters = {k[0]: c.value for k, c in fam.child_items()}
    with open(out, "w") as f:
        json.dump({"steps": sorted(summary.health),
                   "fetches": opt._health_monitor.fetches,
                   "stats_calls": len(calls),
                   "bad": {s: [n for n, row in rows.items()
                               if row["nonfinite"]]
                           for s, rows in summary.health.items()},
                   "counters": counters}, f)
    Engine.reset()


# the "wide_deep" case: the example's widths, WD_STEPS fixed batches
WD_BATCH, WD_STEPS = 16, 2


def wide_deep_data():
    """The Wide & Deep example's packed rows and labels, from the port's
    copy of its synthetic set."""
    from bigdl_tpu_torch.examples.wide_and_deep_train import \
        synthetic_tabular
    from bigdl_tpu_torch.models import pack_batch

    sp, deep, y = synthetic_tabular(n=WD_BATCH * WD_STEPS)
    return pack_batch(sp, deep, 8), y


def wide_deep_batches(base):
    """The fixed batches of ``wide_deep_data`` as a ``base`` (either
    package's ``DataSet``) subclass instance."""
    x, y = wide_deep_data()

    class Fixed(base):
        def size(self):
            return len(x)

        def data(self, train=True):
            for b in range(0, len(x), WD_BATCH):
                yield x[b:b + WD_BATCH], y[b:b + WD_BATCH]

    return Fixed()


def wide_deep_run(trainer, device="cpu"):
    """``WD_STEPS`` SGD steps (lr 1.0) of the port's Wide & Deep at the
    example's widths through ``trainer`` ("local", or "distri" on the
    f32 wire); returns the losses and the parameters as arrays."""
    from bigdl_tpu_torch.models import build_wide_and_deep

    RandomGenerator.RNG.set_seed(21)
    model = build_wide_and_deep(200, (12, 20, 8), class_num=2, wide_slots=8)
    cls, kw = ((TO.DistriOptimizer, {"wire_dtype": "float32"})
               if trainer == "distri" else (TO.LocalOptimizer, {}))
    opt = cls(model, wide_deep_batches(DataSet), TN.ClassNLLCriterion(),
              WD_BATCH, device=device, **kw)
    opt.set_optim_method(TO.SGD(learningrate=1.0))
    opt.set_end_when(TO.Trigger.max_iteration(WD_STEPS))
    losses = Losses()
    opt.set_train_summary(losses)
    opt.optimize()
    arrays = {f"p{i}": v.detach().cpu().numpy()
              for i, v in enumerate(T.leaves(model.params()))}
    arrays["losses"] = np.asarray([losses.loss[k]
                                   for k in sorted(losses.loss)])
    return arrays


def run(rank, world, store, out, case, extra=None):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    if case in ("wires", "hier"):
        x, y = data()
        arrays = {}
        if case == "hier":
            Engine.init("cpu")
            Engine.build_mesh({"dcn": 2, "data": 2})
        for i, kw in enumerate(WIRE_CASES if case == "wires"
                               else HIER_CASES):
            if case == "hier":
                kw = dict(kw, data_axes=("dcn", "data"))
            model, opt, losses = _wire_run(Batches(x, y), kw)
            arrays.update(_arrays(model, opt, losses, f"{i}_"))
        if case == "hier":
            # LBFGS refuses a world of more than one rank
            opt = TO.DistriOptimizer(small_model(TN), Batches(x, y),
                                     TN.ClassNLLCriterion(), 8,
                                     device="cpu")
            opt.set_optim_method(TO.LBFGS())
            try:
                opt.optimize()
                arrays["lbfgs_error"] = np.asarray("none")
            except NotImplementedError as e:
                arrays["lbfgs_error"] = np.asarray(str(e))
        np.savez(out, **arrays)
        Engine.reset()
        dist.destroy_process_group()
        return
    if case == "eval":
        # each rank folds its own rows of a per-process validation set
        # (whole batches: an eval pass of it skips a ragged tail)
        x, y = data(24)
        RandomGenerator.RNG.set_seed(4)
        model = small_model(TN)
        ds = DistributedDataSet(x, y, 8, shuffle=False)
        res = TO.evaluate_dataset(
            model, ds, [TO.Top1Accuracy(), TO.Loss(TN.ClassNLLCriterion())],
            device="cpu")
        np.savez(out, total=np.asarray([r.total for r in res]),
                 count=np.asarray([r.count for r in res]))
        dist.destroy_process_group()
        return
    if case == "health":
        health_case(out)
        dist.destroy_process_group()
        return
    if case == "wide_deep":
        np.savez(out, **wide_deep_run("distri"))
        Engine.reset()
        dist.destroy_process_group()
        return
    if case in ("ckpt", "resume"):
        from bigdl_tpu_torch.dataset import ArrayDataSet

        x, y = data(CKPT_N)
        make = lambda m, d: TO.DistriOptimizer(  # noqa: E731
            m, d, TN.ClassNLLCriterion(), 8, device="cpu", **CKPT_KW)
        RandomGenerator.RNG.set_seed(4)
        model, opt, losses = ckpt_run(
            TN, TO, make, ArrayDataSet(x, y, 8, shuffle=False),
            directory=out if case == "ckpt" else None,
            resume=extra if case == "resume" else None)
        if case == "resume" and rank == 0:
            np.savez(out, **_arrays(model, opt, losses))
        Engine.reset()
        dist.destroy_process_group()
        return
    x, y = data()
    RandomGenerator.RNG.set_seed(4)
    model = small_model(TN)
    if case == "array":
        ds = Batches(x, y)
    elif case == "frame":
        from bigdl_tpu_torch.transform import vision as V

        arrays, labels = frame_images()
        frame = V.DistributedImageFrame.read(arrays, labels)
        ds = frame.transform(frame_chain(V)).to_dataset(8)
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
        sys.argv[5], sys.argv[6] if len(sys.argv) > 6 else None)
