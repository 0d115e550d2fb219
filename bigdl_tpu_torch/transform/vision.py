"""Vision transforms, ``ImageFrame`` and ``DistributedImageFrame``.

Counterpart of ``bigdl_tpu/transform/vision.py`` (the whole module):
``ImageFeature`` and ``FeatureTransformer`` (:28-72), ``write_bmp``/
``read_bmp``/``read_image`` (:76-148), ``_resize_bilinear`` (:150), the
transforms (:190-520: ``Resize``, ``AspectScale``, ``CenterCrop``,
``RandomCrop``, ``HFlip``, ``RandomHFlip``, ``ChannelNormalize``,
``ChannelScaledNormalizer``, ``PixelNormalizer``, ``Brightness``,
``Contrast``, ``Saturation``, ``ColorJitter``, ``Hue``, ``Expand``,
``FixedCrop``, ``RandomAspectScale``, ``ChannelOrder``,
``RandomTransformer``, ``MatToTensor``), ``ImageFrameToSample`` (:521) and the
frames (:536-688).  They run on the host in numpy, as in the JAX
package, and the random ones draw from the port's
``RandomGenerator.RNG`` in the JAX order (``ColorJitter`` a permutation
first, ``RandomAspectScale`` a ``randint``, ``RandomTransformer`` a
``uniform``), which draws the JAX package's numbers, so a seeded chain
gives the JAX package's arrays.  ``predict_image``
(``optim/evaluator.py``) writes a model's predictions into a frame.

Layout: ``ImageFeature`` holds HWC arrays; ``MatToTensor`` gives CHW
float32, the model's NCHW input.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.dataset.dataset import DataSet


class ImageFeature(dict):
    """A dict of named slots (mat, label, uri, sample) changed along the
    pipeline."""

    MAT = "mat"          # HWC float or uint8 array
    LABEL = "label"
    URI = "uri"
    SAMPLE = "sample"

    def __init__(self, image=None, label=None, uri=None):
        super().__init__()
        if image is not None:
            self[self.MAT] = np.asarray(image)
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def image(self):
        return self.get(self.MAT)


class FeatureTransformer:
    """An ``ImageFeature -> ImageFeature`` stage; ``a >> b`` chains."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        raise NotImplementedError

    def __call__(self, features):
        if isinstance(features, ImageFeature):
            return self.transform(features)
        return (self.transform(f) for f in features)

    def __rshift__(self, other: "FeatureTransformer"):
        return _ChainedFeature(self, other)


class _ChainedFeature(FeatureTransformer):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def transform(self, feature):
        return self.b.transform(self.a.transform(feature))


def write_bmp(path: str, arr: np.ndarray) -> None:
    """Write an HWC uint8 RGB array as an uncompressed 24-bit BMP with
    the standard library and numpy only."""
    arr = np.ascontiguousarray(np.asarray(arr, np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_bmp wants HWC RGB, got {arr.shape}")
    h, w = arr.shape[:2]
    pad = (-w * 3) % 4          # BMP rows are 4-byte aligned
    rows = arr[::-1, :, ::-1]   # bottom-up, BGR
    body = bytearray()
    zeros = b"\x00" * pad
    for row in rows:
        body += row.tobytes() + zeros
    header = struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54)
    header += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                          len(body), 2835, 2835, 0, 0)
    with open(path, "wb") as fh:
        fh.write(header + bytes(body))


def read_bmp(path: str) -> np.ndarray:
    """Decode an uncompressed 24- or 32-bit BMP to HWC uint8 RGB with
    the standard library and numpy only."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path!r} is not a BMP file")
    pixel_off = struct.unpack_from("<I", data, 10)[0]
    hdr_size = struct.unpack_from("<I", data, 14)[0]
    if hdr_size < 40:
        raise ValueError(f"unsupported BMP core header in {path!r}")
    w, h = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if planes != 1 or compression != 0 or bpp not in (24, 32):
        raise ValueError(
            f"unsupported BMP variant in {path!r} (bpp={bpp}, "
            f"compression={compression}): only uncompressed 24/32-bit")
    flipped = h > 0
    h = abs(h)
    nchan = bpp // 8
    stride = (w * nchan + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=h * stride,
                         offset=pixel_off).reshape(h, stride)[
        :, :w * nchan].reshape(h, w, nchan)
    if flipped:
        rows = rows[::-1]
    return np.ascontiguousarray(rows[..., 2::-1])  # BGR(A) -> RGB


def read_image(path: str) -> np.ndarray:
    """File -> HWC uint8 RGB: Pillow when it is installed (any format),
    else the numpy BMP reader (``.bmp`` only; anything else raises)."""
    try:
        from PIL import Image
    except ImportError:
        if path.lower().endswith(".bmp"):
            return read_bmp(path)
        raise ImportError(
            f"decoding {path!r} needs Pillow (only .bmp decodes without it)")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize of an HWC array: Pillow's filter when Pillow is
    installed (uint8 in, uint8 out; float per channel in mode "F"),
    else the host library's half-pixel bilinear (``native``, f32) when
    it is available, else corner-aligned bilinear in numpy (f32), in
    the JAX package's order (vision.py:150-185)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        if img.dtype != np.uint8:
            chans = [np.asarray(
                Image.fromarray(img[..., c].astype(np.float32), mode="F")
                .resize((ow, oh), Image.BILINEAR))
                for c in range(img.shape[-1])]
            return np.stack(chans, axis=-1)
        return np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
    from bigdl_tpu_torch import native

    if img.ndim == 3 and native.available():
        chw = np.ascontiguousarray(img.astype(np.float32).transpose(2, 0, 1))
        return native.resize_bilinear(chw, oh, ow).transpose(1, 2, 0)
    h, w = img.shape[:2]
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class AspectScale(FeatureTransformer):
    """Resize the short edge to ``scale``, the long one at most
    ``max_size``."""

    def __init__(self, scale: int, max_size: int = 1000):
        self.scale, self.max_size = scale, max_size

    def transform(self, feature):
        img = feature.image
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        ratio = self.scale / short
        if long * ratio > self.max_size:
            ratio = self.max_size / long
        feature[ImageFeature.MAT] = _resize_bilinear(
            img, int(round(h * ratio)), int(round(w * ratio)))
        return feature


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def transform(self, feature):
        img = feature.image
        h, w = img.shape[:2]
        y = (h - self.ch) // 2
        x = (w - self.cw) // 2
        feature[ImageFeature.MAT] = img[y:y + self.ch, x:x + self.cw]
        return feature


class RandomCrop(FeatureTransformer):
    """A crop at a corner drawn from ``RandomGenerator.RNG`` (y, then
    x)."""

    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def transform(self, feature):
        img = feature.image
        h, w = img.shape[:2]
        y = int(RandomGenerator.RNG.randint(0, max(1, h - self.ch + 1)))
        x = int(RandomGenerator.RNG.randint(0, max(1, w - self.cw + 1)))
        feature[ImageFeature.MAT] = img[y:y + self.ch, x:x + self.cw]
        return feature


class RandomHFlip(FeatureTransformer):
    """A horizontal flip with probability ``p`` (one uniform draw)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def transform(self, feature):
        if RandomGenerator.RNG.uniform(0, 1) < self.p:
            feature[ImageFeature.MAT] = feature.image[:, ::-1]
        return feature


class ChannelNormalize(FeatureTransformer):
    """Per channel ``(x - mean) / std``, in f32."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def transform(self, feature):
        img = feature.image.astype(np.float32)
        feature[ImageFeature.MAT] = (img - self.mean) / self.std
        return feature


class Resize(FeatureTransformer):
    """The reference's Resize."""

    def __init__(self, resize_h: int, resize_w: int):
        self.resize_h, self.resize_w = resize_h, resize_w

    def transform(self, feature):
        img = feature.image
        feature[ImageFeature.MAT] = _resize_bilinear(
            img, self.resize_h, self.resize_w
        )
        return feature


class HFlip(FeatureTransformer):
    """The reference's HFlip: unconditional horizontal flip."""

    def transform(self, feature):
        feature[ImageFeature.MAT] = feature.image[:, ::-1]
        return feature


class ChannelScaledNormalizer(FeatureTransformer):
    """The reference's ChannelScaledNormalizer: mean-subtract + global scale."""

    def __init__(self, mean_r, mean_g, mean_b, scale: float):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def transform(self, feature):
        img = feature.image.astype(np.float32)
        feature[ImageFeature.MAT] = (img - self.mean) * self.scale
        return feature


class PixelNormalizer(FeatureTransformer):
    """The reference's PixelNormalizer: subtract a full mean image."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform(self, feature):
        feature[ImageFeature.MAT] = feature.image.astype(np.float32) - self.means
        return feature


class Brightness(FeatureTransformer):
    """The reference's Brightness: random delta in [delta_low, delta_high]."""

    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature):
        delta = RandomGenerator.RNG.uniform(self.lo, self.hi)
        feature[ImageFeature.MAT] = feature.image.astype(np.float32) + delta
        return feature


class Contrast(FeatureTransformer):
    """The reference's Contrast."""

    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature):
        f = RandomGenerator.RNG.uniform(self.lo, self.hi)
        feature[ImageFeature.MAT] = feature.image.astype(np.float32) * f
        return feature


class Saturation(FeatureTransformer):
    """The reference's Saturation: scale distance from the grey image."""

    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature):
        f = RandomGenerator.RNG.uniform(self.lo, self.hi)
        img = feature.image.astype(np.float32)
        grey = img.mean(axis=-1, keepdims=True)
        feature[ImageFeature.MAT] = grey + (img - grey) * f
        return feature


class ColorJitter(FeatureTransformer):
    """The reference's ColorJitter: random brightness/contrast/saturation
    in random order."""

    def __init__(self, brightness=32.0, contrast=0.5, saturation=0.5):
        self.ops = [
            Brightness(-brightness, brightness),
            Contrast(1 - contrast, 1 + contrast),
            Saturation(1 - saturation, 1 + saturation),
        ]

    def transform(self, feature):
        order = RandomGenerator.RNG.randperm(len(self.ops))
        for i in order:
            feature = self.ops[i].transform(feature)
        return feature


class Hue(FeatureTransformer):
    """The reference's Hue: rotate the hue channel by a random delta in
    [delta_low, delta_high] degrees (detection-era color aug)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.lo, self.hi = delta_low, delta_high

    @staticmethod
    def _rgb_to_hsv(img):
        img = img.astype(np.float32)
        mx = img.max(-1)
        mn = img.min(-1)
        diff = mx - mn
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        h = np.zeros_like(mx)
        mask = diff > 0
        rmax = mask & (mx == r)
        gmax = mask & (mx == g) & ~rmax
        bmax = mask & ~rmax & ~gmax
        h[rmax] = (60 * (g - b)[rmax] / diff[rmax]) % 360
        h[gmax] = 60 * (b - r)[gmax] / diff[gmax] + 120
        h[bmax] = 60 * (r - g)[bmax] / diff[bmax] + 240
        s = np.where(mx > 0, diff / np.maximum(mx, 1e-12), 0.0)
        return h, s, mx

    @staticmethod
    def _hsv_to_rgb(h, s, v):
        h = (h % 360) / 60.0
        i = np.floor(h).astype(np.int32)
        f = h - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = i % 6
        r = np.choose(i, [v, q, p, p, t, v])
        g = np.choose(i, [t, v, v, q, p, p])
        b = np.choose(i, [p, p, t, v, v, q])
        return np.stack([r, g, b], axis=-1)

    def transform(self, feature):
        delta = RandomGenerator.RNG.uniform(self.lo, self.hi)
        h, s, v = self._rgb_to_hsv(feature.image)
        feature[ImageFeature.MAT] = self._hsv_to_rgb(h + delta, s, v)
        return feature


class Expand(FeatureTransformer):
    """The reference's Expand: place the image at a random offset on a
    larger mean-filled canvas (SSD-style zoom-out augmentation)."""

    def __init__(self, means_r: float = 123.0, means_g: float = 117.0,
                 means_b: float = 104.0, min_expand_ratio: float = 1.0,
                 max_expand_ratio: float = 4.0):
        self.means = np.array([means_r, means_g, means_b], np.float32)
        self.lo, self.hi = min_expand_ratio, max_expand_ratio

    def transform(self, feature):
        img = feature.image.astype(np.float32)
        h, w = img.shape[:2]
        ratio = RandomGenerator.RNG.uniform(self.lo, self.hi)
        oh, ow = int(h * ratio), int(w * ratio)
        y = int(RandomGenerator.RNG.uniform(0, max(1, oh - h)))
        x = int(RandomGenerator.RNG.uniform(0, max(1, ow - w)))
        canvas = np.tile(self.means, (oh, ow, 1)).astype(np.float32)
        canvas[y:y + h, x:x + w] = img
        feature[ImageFeature.MAT] = canvas
        return feature


class FixedCrop(FeatureTransformer):
    """The reference's FixedCrop: crop a fixed bbox (x1, y1, x2, y2);
    ``normalized`` coords are fractions of width/height."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def transform(self, feature):
        img = feature.image
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        x1, y1 = max(0, int(round(x1))), max(0, int(round(y1)))
        x2, y2 = min(w, int(round(x2))), min(h, int(round(y2)))
        feature[ImageFeature.MAT] = img[y1:y2, x1:x2]
        return feature


class RandomAspectScale(FeatureTransformer):
    """The reference's RandomAspectScale: AspectScale with the short-edge
    target drawn from ``scales``."""

    def __init__(self, scales: Sequence[int], scale_multiple_of: int = 1,
                 max_size: int = 1000):
        self.scales = list(scales)
        self.mult = scale_multiple_of
        self.max_size = max_size

    def transform(self, feature):
        pick = self.scales[
            int(RandomGenerator.RNG.randint(0, len(self.scales)))]
        img = feature.image
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        ratio = pick / short
        if long * ratio > self.max_size:
            ratio = self.max_size / long
        oh, ow = int(round(h * ratio)), int(round(w * ratio))
        if self.mult > 1:
            oh = -(-oh // self.mult) * self.mult
            ow = -(-ow // self.mult) * self.mult
        feature[ImageFeature.MAT] = _resize_bilinear(img, oh, ow)
        return feature


class ChannelOrder(FeatureTransformer):
    """The reference's ChannelOrder: swap RGB <-> BGR."""

    def transform(self, feature):
        feature[ImageFeature.MAT] = feature.image[..., ::-1]
        return feature


class RandomTransformer(FeatureTransformer):
    """The reference's RandomTransformer: apply ``inner`` with
    probability ``p``."""

    def __init__(self, inner: FeatureTransformer, p: float = 0.5):
        self.inner, self.p = inner, p

    def transform(self, feature):
        if RandomGenerator.RNG.uniform(0, 1) < self.p:
            return self.inner.transform(feature)
        return feature


class MatToTensor(FeatureTransformer):
    """HWC -> contiguous CHW float32 in the ``sample`` slot."""

    def __init__(self, to_rgb: bool = False):
        self.to_rgb = to_rgb

    def transform(self, feature):
        img = feature.image.astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        feature[ImageFeature.SAMPLE] = np.ascontiguousarray(
            np.transpose(img, (2, 0, 1)))
        return feature


class ImageFrameToSample(FeatureTransformer):
    """The reference's ImageFrameToSample: wrap tensor+label as a Sample."""

    def transform(self, feature):
        from bigdl_tpu_torch.dataset.sample import Sample

        tensor = feature.get(ImageFeature.SAMPLE)
        if tensor is None:
            tensor = np.transpose(feature.image.astype(np.float32), (2, 0, 1))
        label = feature.get(ImageFeature.LABEL, np.zeros(1, np.float32))
        label = np.atleast_1d(np.asarray(label, np.float32))
        feature[ImageFeature.SAMPLE] = Sample(tensor, label)
        return feature


class ImageFrame:
    """The reference's ImageFrame (LocalImageFrame): a list of
    ``ImageFeature``s; ``transform`` runs a transformer over each, in
    order, now (so a random transform draws once per image, at this
    call, not once per epoch)."""

    def __init__(self, features: Sequence[ImageFeature]):
        self.features = list(features)

    @staticmethod
    def read(arrays, labels=None):
        """A frame of in-memory HWC arrays, or of image paths decoded
        with Pillow (which must be installed for paths, as in the JAX
        package)."""
        feats = []
        for i, a in enumerate(arrays):
            if isinstance(a, str):
                from PIL import Image

                a = np.asarray(Image.open(a).convert("RGB"))
            feats.append(
                ImageFeature(a, None if labels is None else labels[i])
            )
        return ImageFrame(feats)

    def transform(self, transformer: FeatureTransformer):
        self.features = [transformer.transform(f) for f in self.features]
        return self

    def __len__(self):
        return len(self.features)

    def to_samples(self):
        return [f[ImageFeature.SAMPLE] for f in self.features]

    def to_dataset(self, batch_size: int = 32):
        """The frame as a ``SampleDataSet`` (after ``ImageFrameToSample``)."""
        from bigdl_tpu_torch.dataset.dataset import SampleDataSet

        self.transform(ImageFrameToSample())
        return SampleDataSet(self.to_samples(), batch_size)


class DistributedImageFrame(ImageFrame):
    """The reference's DistributedImageFrame: each process holds only
    its own shard of the images (the reference's executors cache their
    RDD partition); transforms run on the local shard, and
    ``to_dataset`` yields this process's rows of every global batch,
    which ``DistriOptimizer`` trains as a per-process dataset.

    ``read`` shards a global list of paths or arrays round-robin by
    process; ``process_id``/``num_processes`` override the process
    group's rank and size (``dataset.process_world``, where the JAX
    package reads ``jax.process_index``/``process_count``)."""

    def __init__(self, features: Sequence[ImageFeature],
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 global_size: Optional[int] = None):
        """``features`` is THIS process's local shard.  ``global_size``
        (total across processes) coordinates the per-epoch batch count
        so unequal shards never desynchronise the collective; when
        omitted it is estimated as balanced (shard * nproc)."""
        super().__init__(features)
        pid, nproc = self._world(process_id, num_processes)
        self._pid = pid
        self._nproc = nproc
        self._global_n = global_size if global_size is not None \
            else len(self.features) * nproc

    @staticmethod
    def _world(process_id, num_processes):
        if process_id is not None and num_processes is not None:
            return process_id, num_processes
        from bigdl_tpu_torch.dataset.dataset import process_world

        return process_world()

    @staticmethod
    def read(arrays, labels=None, process_id: Optional[int] = None,
             num_processes: Optional[int] = None):
        """Shard a GLOBAL list of paths/arrays: this process keeps
        every ``num_processes``-th entry starting at ``process_id``
        (deterministic, balanced like the reference's coalesce)."""
        pid, nproc = DistributedImageFrame._world(process_id, num_processes)
        feats = []
        for i in range(pid, len(arrays), nproc):
            a = arrays[i]
            if isinstance(a, str):
                from PIL import Image

                a = np.asarray(Image.open(a).convert("RGB"))
            feats.append(
                ImageFeature(a, None if labels is None else labels[i])
            )
        return DistributedImageFrame(feats, process_id=pid,
                                     num_processes=nproc,
                                     global_size=len(arrays))

    def to_dataset(self, batch_size: int = 32):
        """A per-process dataset over the local shard: this process's
        rows of every global batch.  Every process yields the same
        number of batches (from ``global_size``), so unequal shards
        cannot leave one rank waiting in a collective."""
        self.transform(ImageFrameToSample())
        samples = self.to_samples()
        feats = np.stack([np.asarray(s.features) for s in samples])
        labels = np.stack(
            [np.asarray(s.labels).reshape(-1)[0] for s in samples])
        return _LocalShardDataSet(feats, labels, batch_size,
                                  num_processes=self._nproc,
                                  global_size=self._global_n)


class _LocalShardDataSet(DataSet):
    """A dataset over a shard taken at read time: yields local batches
    of ``batch_size // num_processes`` rows, flagged ``per_process``.
    The batches an epoch come from the smallest shard
    (``global_size // num_processes``), alike on every process.  A
    ``DataSet`` here, so the trainers' ``to_dataset`` takes it (the JAX
    class is not one, and JAX's ``to_dataset`` refuses it)."""

    per_process = True

    def __init__(self, features, labels, batch_size: int = 32,
                 shuffle: bool = True, num_processes: int = 1,
                 global_size: Optional[int] = None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._n = len(self.features)
        self._nproc = max(1, num_processes)
        self._global_n = global_size if global_size is not None \
            else self._n * self._nproc

    def size(self):
        return self._global_n

    def data(self, train: bool = True):
        local_bs = max(1, self.batch_size // self._nproc)
        min_shard = self._global_n // self._nproc
        n_batches = min_shard // local_bs
        order = np.arange(self._n)
        if train and self.shuffle:
            order = RandomGenerator.RNG.randperm(self._n)
        for b in range(n_batches):
            sel = order[b * local_bs:(b + 1) * local_bs]
            yield self.features[sel], self.labels[sel]


__all__ = ["ImageFeature", "FeatureTransformer", "write_bmp", "read_bmp",
           "read_image", "Resize", "AspectScale", "CenterCrop",
           "RandomCrop", "HFlip", "RandomHFlip", "ChannelNormalize",
           "ChannelScaledNormalizer", "PixelNormalizer", "Brightness",
           "Contrast", "Saturation", "ColorJitter", "Hue", "Expand",
           "FixedCrop", "RandomAspectScale", "ChannelOrder",
           "RandomTransformer", "MatToTensor", "ImageFrameToSample",
           "ImageFrame", "DistributedImageFrame"]
