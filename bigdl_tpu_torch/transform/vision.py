"""Vision transforms: the part the image-folder decode runs.

Counterpart of the subset of ``bigdl_tpu/transform/vision.py`` that
``dataset/imagenet.py``'s ``_decode`` uses: ``ImageFeature`` and
``FeatureTransformer`` (:28-72), ``write_bmp``/``read_bmp``/
``read_image`` (:76-148), ``_resize_bilinear`` (:150), ``AspectScale``
(:204), ``CenterCrop`` (:223), ``RandomCrop`` (:238), ``RandomHFlip``
(:261), ``ChannelNormalize`` (:273) and ``MatToTensor`` (:505).  They
run on the host in numpy, as in the JAX package, and the random ones
draw from the port's ``RandomGenerator.RNG``, which draws the JAX
package's numbers, so a seeded decode gives the JAX package's arrays.
``ImageFrame`` and the other transforms are not ported yet (ROADMAP.md
queue 1).

Layout: ``ImageFeature`` holds HWC arrays; ``MatToTensor`` gives CHW
float32, the model's NCHW input.
"""

from __future__ import annotations

import struct

import numpy as np

from bigdl_tpu_torch.common import RandomGenerator


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
    else corner-aligned bilinear in numpy (f32), as the JAX package's
    last fallback computes it.  The JAX package has a C library in
    between; the port has none."""
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


__all__ = ["ImageFeature", "FeatureTransformer", "write_bmp", "read_bmp",
           "read_image", "AspectScale", "CenterCrop", "RandomCrop",
           "RandomHFlip", "ChannelNormalize", "MatToTensor"]
