"""The port's image pipeline (``transform/vision.py``'s transforms,
``ImageFrame``, ``DistributedImageFrame``, ``predict_image``) against
the JAX package's, on the CPU.

- Each transform the slice ported, alone and chained (phase 21's
  chain at a small size), gives the JAX package's array, dtype
  included, bit for bit, under one ``RandomGenerator`` seed; the
  seeded draws (``ColorJitter``'s permutation, ``RandomAspectScale``'s
  ``randint``, ``RandomTransformer``'s ``uniform``) leave both RNGs at
  the same state.
- ``ImageFrame``'s batches, and ``DistributedImageFrame``'s shards and
  per-process batches (explicit ``process_id``/``num_processes``),
  equal JAX's; a frame of paths decodes as JAX's; without Pillow a
  path raises ``ImportError`` in both.
- JAX's ``tests/test_vision.py:202-248`` path (ImageFrame ->
  ``DistriOptimizer`` -> ``predict_image``) at world 1 against a
  1-device mesh, and a ``DistributedImageFrame`` at world 2 (two
  processes over gloo, ``tests/torch_port_distri_worker.py``) against
  a 2-device mesh fed the same global batches: losses, weights and
  predictions within 1e-5.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.evaluator import predict_image as j_predict_image
from bigdl_tpu.transform import vision as JV
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.transform import vision as TV
from bigdl_tpu_torch.utils import tree as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402

TOL = 1e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_distri_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_world():
    Engine.reset()
    yield
    Engine.reset()


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


# (name, builder over either vision module); each is run on a uint8 and
# on a float image
TRANSFORMS = [
    ("Resize", lambda V: V.Resize(13, 19)),
    ("HFlip", lambda V: V.HFlip()),
    ("ChannelScaledNormalizer",
     lambda V: V.ChannelScaledNormalizer(104, 117, 123, 0.017)),
    ("PixelNormalizer",
     lambda V: V.PixelNormalizer(np.arange(17 * 23 * 3, dtype=np.float32)
                                 .reshape(17, 23, 3) / 10)),
    ("Brightness", lambda V: V.Brightness(-32, 32)),
    ("Contrast", lambda V: V.Contrast(0.5, 1.5)),
    ("Saturation", lambda V: V.Saturation(0.5, 1.5)),
    ("ColorJitter", lambda V: V.ColorJitter()),
    ("Hue", lambda V: V.Hue(-18, 18)),
    ("Expand", lambda V: V.Expand(min_expand_ratio=1.0,
                                  max_expand_ratio=2.5)),
    ("FixedCrop", lambda V: V.FixedCrop(0.1, 0.2, 0.8, 0.9)),
    ("FixedCrop_pixels", lambda V: V.FixedCrop(2, 3, 15, 11,
                                               normalized=False)),
    ("RandomAspectScale", lambda V: V.RandomAspectScale([12, 20, 28])),
    ("RandomAspectScale_multiple",
     lambda V: V.RandomAspectScale([15, 21], scale_multiple_of=8)),
    ("ChannelOrder", lambda V: V.ChannelOrder()),
    ("RandomTransformer", lambda V: V.RandomTransformer(V.HFlip(), 0.5)),
    ("AspectScale", lambda V: V.AspectScale(12)),
    ("CenterCrop", lambda V: V.CenterCrop(9, 7)),
    ("RandomCrop", lambda V: V.RandomCrop(9, 7)),
    ("RandomHFlip", lambda V: V.RandomHFlip()),
    ("ChannelNormalize", lambda V: V.ChannelNormalize(1, 2, 3, 4, 5, 6)),
    ("MatToTensor", lambda V: V.MatToTensor(to_rgb=True)),
]


def _image(kind):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    return img if kind == "uint8" else img.astype(np.float32) / 3.0


def _apply(V, R, build, img, seed):
    R.RNG.set_seed(seed)
    out = []
    for _ in range(4):                  # several draws from one seed
        f = V.ImageFeature(img.copy(), label=2.0)
        out.append(build(V).transform(f))
    return out, R.RNG.randint(0, 1 << 30)


def _assert_features_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("name,build", TRANSFORMS,
                         ids=[n for n, _ in TRANSFORMS])
def test_each_transform_equals_jax(name, build, kind):
    img = _image(kind)
    got, t_next = _apply(TV, TRandom, build, img, 7)
    want, j_next = _apply(JV, JRandom, build, img, 7)
    assert t_next == j_next                     # the same draws
    for a, b in zip(got, want):
        _assert_features_equal(a, b)


def _chain(V, size=28):
    """Phase 21's chain at a small size."""
    return (V.RandomAspectScale([size + 4, size + 8])
            >> V.RandomCrop(size, size)
            >> V.RandomTransformer(V.HFlip(), 0.5)
            >> V.ColorJitter()
            >> V.ChannelNormalize(123.0, 117.0, 104.0, 58.4, 57.1, 57.4)
            >> V.MatToTensor())


def _arrays(n=12):
    rs = np.random.RandomState(2)
    return ([rs.randint(0, 256, (30 + i, 41 - i, 3)).astype(np.uint8)
             for i in range(n)], [float(i % 4 + 1) for i in range(n)])


def test_chain_and_frame_batches_equal_jax():
    arrays, labels = _arrays()
    frames = []
    for V, R in ((TV, TRandom), (JV, JRandom)):
        R.RNG.set_seed(5)
        frame = V.ImageFrame.read(arrays, labels).transform(_chain(V))
        ds = frame.to_dataset(batch_size=4)
        frames.append((frame, list(ds.data(train=True)),
                       list(ds.data(train=False))))
    (tf, tb, te), (jf, jb, je) = frames
    assert len(tf) == len(jf) == 12
    for a, b in zip(tf.features, jf.features):
        np.testing.assert_array_equal(a["sample"].features,
                                      b["sample"].features)
        np.testing.assert_array_equal(a["sample"].labels, b["sample"].labels)
        assert a["sample"].features.shape == (3, 28, 28)
    assert len(tb) == len(jb) == 3 and len(te) == len(je) == 3
    for (tx, ty), (jx, jy) in zip(tb + te, jb + je):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("nproc", [1, 2, 3])
def test_distributed_frame_shards_equal_jax(nproc):
    arrays, labels = _arrays(11)
    for pid in range(nproc):
        shards = []
        for V, R in ((TV, TRandom), (JV, JRandom)):
            R.RNG.set_seed(6)
            frame = V.DistributedImageFrame.read(
                arrays, labels, process_id=pid, num_processes=nproc)
            frame.transform(_chain(V, 20))
            ds = frame.to_dataset(batch_size=2 * nproc)
            shards.append((frame, ds.size(), list(ds.data(train=True)),
                           list(ds.data(train=False))))
        (tf, tn, tb, te), (jf, jn, jb, je) = shards
        assert tn == jn == 11 and len(tf) == len(jf)
        assert getattr(TV._LocalShardDataSet, "per_process")
        assert len(tb) == len(jb) > 0 and len(te) == len(je)
        for (tx, ty), (jx, jy) in zip(tb + te, jb + je):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_paths_decode_as_jax_and_need_pillow(tmp_path, monkeypatch):
    arrays, labels = _arrays(3)
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"img{i}.bmp"))
        TV.write_bmp(paths[-1], a)
    t = TV.ImageFrame.read(paths, labels)
    j = JV.ImageFrame.read(paths, labels)
    for a, b, c in zip(t.features, j.features, arrays):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.image, c)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for V in (TV, JV):
        with pytest.raises(ImportError):
            V.ImageFrame.read(paths, labels)
        with pytest.raises(ImportError):
            V.DistributedImageFrame.read(paths, labels, process_id=0,
                                         num_processes=1)


def _vision_model(N):
    return N.Sequential() \
        .add(N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(N.ReLU()).add(N.SpatialMaxPooling(2, 2)) \
        .add(N.Reshape([4 * 4 * 4], batch_mode=True)) \
        .add(N.Linear(64, 2)).add(N.LogSoftMax())


def _vision_data():
    rs = np.random.RandomState(24)
    n = 128
    labels = (np.arange(n) % 2 + 1).astype(np.float32)
    arrays = []
    for i in range(n):
        img = rs.rand(8, 8, 3).astype(np.float32) * 0.3
        if labels[i] == 1:
            img[2:6, 2:6] += 0.7
        arrays.append(img)
    return arrays, list(labels)


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _vision_run(V, N, O, R, make_opt, predict):
    arrays, labels = _vision_data()
    R.RNG.set_seed(3)
    model = _vision_model(N)
    frame = V.ImageFrame.read(arrays, labels)
    frame.transform(V.ChannelNormalize(0.5, 0.5, 0.5) >> V.MatToTensor())
    opt = make_opt(model, frame.to_dataset(batch_size=32))
    opt.set_optim_method(O.SGD(learningrate=0.5))
    opt.set_end_when(O.Trigger.max_epoch(6))
    losses = _Losses()
    opt.set_train_summary(losses)
    R.RNG.set_seed(8)
    trained = opt.optimize()
    frame2 = V.ImageFrame.read(arrays[:16], labels[:16])
    frame2.transform(V.ChannelNormalize(0.5, 0.5, 0.5) >> V.MatToTensor())
    predict(trained, frame2)
    preds = np.stack([f["predict"] for f in frame2.features])
    return model, [losses.loss[k] for k in sorted(losses.loss)], preds


def test_the_jax_vision_path_at_world_1():
    tm, tl, tp = _vision_run(
        TV, TN, TO, TRandom,
        lambda m, ds: TO.DistriOptimizer(m, ds, TN.ClassNLLCriterion(), 32,
                                         wire_dtype="float32",
                                         device="cpu"),
        lambda m, f: TO.predict_image(m, f, batch_size=8, device="cpu"))
    jm, jl, jp = _vision_run(
        JV, JN, JO, JRandom,
        lambda m, ds: JDistri(m, ds, JN.ClassNLLCriterion(), 32,
                              mesh=_mesh(1), wire_dtype="float32"),
        lambda m, f: j_predict_image(m, f, batch_size=8, mesh=None))
    assert len(tl) == len(jl) == 24
    assert max(abs(a - b) for a, b in zip(tl, jl)) <= TOL
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        assert float(np.max(np.abs(a.detach().numpy() - np.asarray(b)))) \
            <= TOL
    assert tp.shape == jp.shape == (16, 2)
    assert float(np.max(np.abs(tp - jp))) <= TOL
    # the model learned the bright centre
    assert (np.argmax(tp, 1) + 1 == np.asarray(_vision_data()[1][:16])).all()


class _FrameBatches(JDataSet):
    """The global batches the two ranks of the worker's frame case
    train: each rank's shard (``arrays[rank::2]``) in its own epoch
    permutation, drawn from seed 9 as each rank draws it."""

    def __init__(self, epochs):
        arrays, labels = W.frame_images()
        chain = W.frame_chain(JV)
        feats = [chain.transform(JV.ImageFeature(a, l))
                 for a, l in zip(arrays, labels)]
        self.shards = [
            (np.stack([f["sample"] for f in feats[r::2]]),
             np.asarray(labels[r::2], np.float32)) for r in range(2)]
        rs = np.random.RandomState(9)
        self.perms = [rs.permutation(len(self.shards[0][1]))
                      for _ in range(epochs)]
        self.epoch = 0

    def size(self):
        return 22

    def data(self, train=True):
        perm = self.perms[self.epoch]
        self.epoch += 1
        for b in range(len(perm) // 4):
            sel = perm[b * 4:(b + 1) * 4]
            yield (np.concatenate([x[sel] for x, _ in self.shards]),
                   np.concatenate([y[sel] for _, y in self.shards]))


def test_a_distributed_frame_at_world_2_over_gloo(tmp_path):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, outs[r], "frame"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    JRandom.RNG.set_seed(4)
    jm = W.small_model(JN)
    jo = JDistri(jm, _FrameBatches(2), JN.ClassNLLCriterion(), 8,
                 mesh=_mesh(2), wire_dtype="float32")
    jo.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9,
                               weightdecay=1e-3))
    jo.set_gradient_clipping_by_l2_norm(1.5)
    jo.set_end_when(JO.Trigger.max_epoch(2))
    losses = _Losses()
    jo.set_train_summary(losses)
    jo.optimize()
    jl = [losses.loss[k] for k in sorted(losses.loss)]
    assert len(jl) == 4
    for out in outs:
        with np.load(out) as r:
            got = list(r["losses"])
            assert max(abs(a - b) for a, b in zip(got, jl)) <= TOL, (got, jl)
            for i, b in enumerate(jax.tree.leaves(jm.params())):
                assert float(np.max(np.abs(r[f"p{i}"] - np.asarray(b)))) \
                    <= TOL
            for i, b in enumerate(jax.tree.leaves(jm.state())):
                assert float(np.max(np.abs(r[f"s{i}"] - np.asarray(b)))) \
                    <= TOL
