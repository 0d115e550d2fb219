"""The port's input feed against the JAX package, on the CPU: the BMP
codec, the image-folder decode chain, ``ImageFolderDataSet``,
``iter_process_batches``/``DistributedDataSet`` and the prefetch
thread.

The same BMP files go through both packages' decode from the same
seeds: the arrays agree within 1e-6 (the two run the same numpy,
Pillow or host-library code; the limit allows a reordered f32 sum),
``read_bmp`` and ``write_bmp`` are bit-equal, and batches, labels and
their order are equal for one process and for each of two
(``process_id`` / ``num_processes``)."""

import sys
import threading

import numpy as np
import pytest
import torch

import bigdl_tpu.native as j_native
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import DistributedDataSet as JDist
from bigdl_tpu.dataset import imagenet as JI
from bigdl_tpu.dataset.dataset import iter_process_batches as j_iter
from bigdl_tpu.transform import vision as JV
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import DistributedDataSet as TDist
from bigdl_tpu_torch.dataset import imagenet as TI
from bigdl_tpu_torch.dataset.dataset import iter_process_batches as t_iter
from bigdl_tpu_torch.dataset.prefetch import PrefetchIterator, to_host_tensor
from bigdl_tpu_torch.transform import vision as TV

DECODE_TOL = 1e-6


def _image(rs, h, w, cls):
    """An RGB image with a class-dependent gradient plus noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (cls + 1)) % 256, (yy * (cls + 2)) % 256,
                     ((xx + yy) * 3) % 256], axis=-1)
    return np.clip(base + rs.randint(-20, 21, (h, w, 3)), 0,
                   255).astype(np.uint8)


def write_folder(root, classes=3, per_class=5, val=2, seed=0,
                 sizes=((40, 52), (48, 36), (45, 45))):
    """``root/{train,val}/c{k}/*.bmp`` with sizes cycling over
    ``sizes``; written by the port's ``write_bmp``."""
    rs = np.random.RandomState(seed)
    for split, n in (("train", per_class), ("val", val)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = sizes[(c + i) % len(sizes)]
                TV.write_bmp(str(d / f"img{i}.bmp"), _image(rs, h, w, c))
    return str(root)


@pytest.fixture(params=["pillow", "numpy", "native"])
def backend(request, monkeypatch):
    """Both packages' resize through Pillow, through their host C
    libraries (Pillow hidden), or through their numpy fallback (Pillow
    hidden, both libraries off)."""
    monkeypatch.delenv("BIGDL_TORCH_NO_NATIVE", raising=False)
    if request.param != "pillow":
        monkeypatch.setitem(sys.modules, "PIL", None)
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "available", lambda: False)
        monkeypatch.setenv("BIGDL_TORCH_NO_NATIVE", "1")
    if request.param == "native":
        from bigdl_tpu_torch import native as t_native

        assert j_native.available() and t_native.available()
    return request.param


def test_bmp_codec_is_bit_equal(tmp_path):
    rs = np.random.RandomState(3)
    for h, w in ((7, 5), (16, 16), (3, 9)):
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        TV.write_bmp(str(tmp_path / "t.bmp"), img)
        JV.write_bmp(str(tmp_path / "j.bmp"), img)
        assert (tmp_path / "t.bmp").read_bytes() == \
            (tmp_path / "j.bmp").read_bytes()
        got = TV.read_bmp(str(tmp_path / "j.bmp"))
        np.testing.assert_array_equal(got, JV.read_bmp(str(tmp_path /
                                                           "t.bmp")))
        np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="not a BMP"):
        (tmp_path / "x.bmp").write_bytes(b"PK\x03\x04")
        TV.read_bmp(str(tmp_path / "x.bmp"))


@pytest.mark.parametrize("train", [True, False])
def test_decode_chain_matches_jax(tmp_path, backend, train):
    root = write_folder(tmp_path, classes=2, per_class=3)
    paths, _, _ = TI.scan_image_folder(str(tmp_path / "train"))
    mean, std = TI.ImageFolderDataSet.IMAGENET_MEAN, \
        TI.ImageFolderDataSet.IMAGENET_STD
    for size in (32, 24):
        for p in paths:
            JRandom.RNG.set_seed(7)
            want = JI._decode(p, size, train, mean, std)
            TRandom.RNG.set_seed(7)
            got = TI._decode(p, size, train, mean, std)
            assert got.shape == want.shape == (3, size, size)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL)
    del root


def test_chained_transformers_match_their_steps():
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (30, 44, 3)).astype(np.float32)
    chain = TV.AspectScale(20) >> TV.CenterCrop(16, 16) >> \
        TV.ChannelNormalize(1.0, 2.0, 3.0, 2.0, 2.0, 2.0) >> TV.MatToTensor()
    got = chain(TV.ImageFeature(img))[TV.ImageFeature.SAMPLE]
    want = JV.ImageFeature(img)
    for t in (JV.AspectScale(20), JV.CenterCrop(16, 16),
              JV.ChannelNormalize(1.0, 2.0, 3.0, 2.0, 2.0, 2.0),
              JV.MatToTensor()):
        want = t(want)
    np.testing.assert_allclose(got, want[JV.ImageFeature.SAMPLE], rtol=0,
                               atol=DECODE_TOL)
    assert got.shape == (3, 16, 16)


def test_scan_image_folder_matches_jax(tmp_path):
    write_folder(tmp_path)
    for split in ("train", "val"):
        got = TI.scan_image_folder(str(tmp_path / split))
        want = JI.scan_image_folder(str(tmp_path / split))
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TI.scan_image_folder(str(tmp_path / "empty"))


@pytest.mark.parametrize("world", [(0, 1), (0, 2), (1, 2)])
def test_image_folder_dataset_matches_jax(tmp_path, world):
    pid, nproc = world
    write_folder(tmp_path, classes=3, per_class=5, val=3)
    kw = dict(batch_size=4, image_size=16, process_id=pid,
              num_processes=nproc)
    for train in (True, False):
        jds = JI.ImageFolderDataSet(str(tmp_path), train=train, **kw)
        tds = TI.ImageFolderDataSet(str(tmp_path), train=train, **kw)
        assert tds.size() == jds.size() and \
            tds.class_num() == jds.class_num() == 3
        JRandom.RNG.set_seed(11)
        want = list(jds.data(train=train))
        TRandom.RNG.set_seed(11)
        got = list(tds.data(train=train))
        assert len(got) == len(want) > 0
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == wx.shape
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_allclose(gx, wx, rtol=0, atol=DECODE_TOL)
    with pytest.raises(FileNotFoundError, match="'val' split"):
        TI.ImageFolderDataSet(str(tmp_path / "train"), train=False)


@pytest.mark.parametrize("shuffle,pad_tail", [(True, False), (False, True),
                                              (True, True)])
def test_iter_process_batches_and_distributed_dataset(shuffle, pad_tail):
    for nproc in (1, 2, 4):
        for pid in range(nproc):
            JRandom.RNG.set_seed(5)
            want = list(j_iter(22, 8, pid, nproc, shuffle, pad_tail))
            TRandom.RNG.set_seed(5)
            got = list(t_iter(22, 8, pid, nproc, shuffle, pad_tail))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        list(t_iter(10, 6, 0, 4, False))
    x = np.arange(22 * 3, dtype=np.float32).reshape(22, 3)
    y = np.arange(22, dtype=np.float32) + 1
    for pid in (0, 1):
        JRandom.RNG.set_seed(2)
        want = list(JDist(x, y, 8, process_id=pid, num_processes=2).data())
        TRandom.RNG.set_seed(2)
        got = list(TDist(x, y, 8, process_id=pid, num_processes=2).data())
        assert len(got) == len(want) == 3
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_prefetch_keeps_order_forwards_errors_and_stops():
    feed = PrefetchIterator(iter(range(50)), depth=3)
    assert list(feed) == list(range(50))
    assert feed.items == 50 and 0 <= feed.waits <= 50

    def broken():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(PrefetchIterator(broken()))
    before = threading.active_count()
    feed = PrefetchIterator(iter(range(10 ** 6)), depth=2)
    it = iter(feed)
    assert next(it) == 0
    feed.close()
    assert not feed._thread.is_alive()
    assert threading.active_count() <= before
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = to_host_tensor(a, pin=False)
    assert isinstance(t, torch.Tensor) and not t.is_pinned()
    np.testing.assert_array_equal(t.numpy(), a)
    assert to_host_tensor(None, pin=True) is None
