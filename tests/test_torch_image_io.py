"""The port's image codec (bnv_fusion_tpu_torch/utils/image_io.py and
native/image_ops.cpp) against cv2, which the JAX package reads and writes
images with.

Tolerances (fixed before measuring):
- PNG: bit for bit, both ways, with the channels reversed for colour.
- JPEG decoding: within 2 levels on every value, mean <= 0.5; the share of
  bit-identical values is printed.
- JPEG encoding: cv2 decodes of ``write_jpeg(img, 95)`` and of cv2's own
  quality-95 file agree within a mean of 1.0 level, and their PSNR against
  the source differs by <= 0.5 dB.
- Resizing: nearest bit for bit; area bit for bit at integer ratios and
  within 1 level otherwise.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from bnv_fusion_tpu_torch.utils import image_io

JPEG_MAX_ERR = 2
JPEG_MEAN_ERR = 0.5
ENC_MEAN_DIFF = 1.0
ENC_PSNR_DB = 0.5


def natural(h, w, seed=0):
    """Smooth colour fields, a flat patch with sharp edges and sensor
    noise: content where every DCT band and the chroma planes matter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 37 + yy / 53),
                    128 + 90 * np.cos(xx / 23 - yy / 41),
                    128 + 60 * np.sin((xx + yy) / 17)], -1)
    img += rng.randn(h, w, 3) * 12
    img[h // 4:h // 2, w // 3:w // 2] = [250, 20, 40]
    return np.clip(img, 0, 255).astype(np.uint8)


def rgb_of_bgr(a):
    """cv2's channel order -> the port's (BGR -> RGB, BGRA -> RGBA)."""
    if a.ndim == 3 and a.shape[2] == 3:
        return a[..., ::-1]
    if a.ndim == 3 and a.shape[2] == 4:
        return a[..., [2, 1, 0, 3]]
    return a


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_written_by_cv2(tmp_path, dtype, channels):
    rng = np.random.RandomState(channels)
    hi = np.iinfo(dtype).max
    shape = (37, 53) + ((channels,) if channels > 1 else ())
    img = rng.randint(0, hi + 1, size=shape).astype(dtype)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    got = image_io.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(rgb_of_bgr(got), want)
    # IMREAD_COLOR semantics: 8 bits, 3 channels
    np.testing.assert_array_equal(image_io.read_png(path, unchanged=False),
                                  cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("kind", ["palette8", "palette4", "palette_trns",
                                  "grey_alpha", "grey1"])
def test_read_png_written_by_pil(tmp_path, kind):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "b.png")
    if kind.startswith("palette"):
        n = 12 if kind == "palette4" else 200
        im = Image.fromarray(rng.randint(0, n, (29, 41)).astype(np.uint8), "P")
        im.putpalette(list(rng.randint(0, 256, 3 * n)))
        extra = ({"transparency": bytes(range(0, 250, 25))}
                 if kind == "palette_trns" else {})
        im.save(path, **extra)
    elif kind == "grey_alpha":
        Image.fromarray(rng.randint(0, 256, (29, 41, 2)).astype(np.uint8),
                        "LA").save(path)
    else:
        Image.fromarray(rng.randint(0, 2, (29, 41)).astype(bool)).save(path)
    np.testing.assert_array_equal(rgb_of_bgr(image_io.read_png(path)),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(image_io.read_png(path, unchanged=False),
                                  cv2.imread(path)[..., ::-1])


def _filter_row(ftype, row, prev, bpp):
    """Forward PNG filter of one scanline (Python ints, spec 9.2)."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i] if prev is not None else 0
        c = prev[i - bpp] if (prev is not None and i >= bpp) else 0
        if ftype == 0:
            p = 0
        elif ftype == 1:
            p = a
        elif ftype == 2:
            p = b
        elif ftype == 3:
            p = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - p) & 0xFF)
    return [ftype] + out


def _hand_png(img, depth, ctype, filters, interlace=False):
    """A PNG built by hand: scanlines filtered with ``filters`` in turn
    (cv2 picks its own filters), optionally Adam7-interlaced."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = max(1, ch * depth // 8)
    passes = (image_io._ADAM7 if interlace else ((0, 0, 1, 1),))
    raw, k = [], 0
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = (sub.astype(">u2").view(np.uint8) if depth == 16 else
                sub.astype(np.uint8)).reshape(sub.shape[0], -1)
        prev = None
        for r in rows:
            r = [int(v) for v in r]
            raw += _filter_row(filters[k % len(filters)], r, prev, bpp)
            prev, k = r, k + 1

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (image_io.PNG_SIG +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       int(interlace))) +
            chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("fmt", ["rgb8", "grey16"])
def test_read_png_each_filter_type(tmp_path, ftype, fmt):
    rng = np.random.RandomState(ftype)
    if fmt == "rgb8":
        img, depth, ctype = natural(11, 17, ftype), 8, 2
    else:
        img = rng.randint(0, 65536, (11, 17)).astype(np.uint16)
        depth, ctype = 16, 0
    path = tmp_path / "f.png"
    path.write_bytes(_hand_png(img, depth, ctype, [ftype]))
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(rgb_of_bgr(want), img)
    np.testing.assert_array_equal(image_io.read_png(str(path)), img)


@pytest.mark.parametrize("fmt", ["rgb8", "grey16", "rgba8"])
def test_read_png_adam7(tmp_path, fmt):
    rng = np.random.RandomState(7)
    if fmt == "rgb8":
        img, depth, ctype = natural(13, 19, 7), 8, 2
    elif fmt == "rgba8":
        img = rng.randint(0, 256, (13, 19, 4)).astype(np.uint8)
        depth, ctype = 8, 6
    else:
        img = rng.randint(0, 65536, (13, 19)).astype(np.uint16)
        depth, ctype = 16, 0
    path = tmp_path / "i.png"
    path.write_bytes(_hand_png(img, depth, ctype, [0, 1, 2, 3, 4],
                               interlace=True))
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = image_io.read_png(str(path))
    np.testing.assert_array_equal(rgb_of_bgr(want), img)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "grey16"])
def test_write_png_read_by_cv2(tmp_path, kind):
    rng = np.random.RandomState(3)
    img = {"grey8": rng.randint(0, 256, (31, 45)).astype(np.uint8),
           "rgb8": natural(31, 45, 3),
           "grey16": rng.randint(0, 65536, (31, 45)).astype(np.uint16)}[kind]
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(rgb_of_bgr(back), img)


def test_png_rejects_bad_input(tmp_path):
    path = tmp_path / "bad.png"
    path.write_bytes(b"\x89PNG\r\n")
    with pytest.raises(ValueError):
        image_io.read_png(str(path))
    good = _hand_png(np.zeros((4, 5), np.uint8), 8, 0, [0])
    broken = bytearray(good)
    broken[-20] ^= 0xFF      # corrupt the IDAT body: bad CRC
    path.write_bytes(bytes(broken))
    with pytest.raises(ValueError):
        image_io.read_png(str(path))
    with pytest.raises(ValueError):
        image_io.write_png(str(path), np.zeros((4, 5, 3), np.uint16))


# ---------------------------------------------------------------------------
# JPEG decoding
# ---------------------------------------------------------------------------

JPEG_CASES = [
    ("q75_420", (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 75]),
    ("q95_420", (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 95]),
    ("q95_444", (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 95,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    ("q75_422", (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 75,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    ("odd_97x73_420", (73, 97), [cv2.IMWRITE_JPEG_QUALITY, 90]),
    ("odd_97x73_422", (73, 97), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    ("scannet_1296x968", (968, 1296), [cv2.IMWRITE_JPEG_QUALITY, 95]),
    ("restart", (200, 300), [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    ("grey", (73, 97), None),
]


@pytest.mark.parametrize("name,hw,params", JPEG_CASES,
                         ids=[c[0] for c in JPEG_CASES])
def test_read_jpeg_against_cv2(tmp_path, name, hw, params):
    img = natural(*hw, seed=len(name))
    path = str(tmp_path / f"{name}.jpg")
    if name == "grey":
        cv2.imwrite(path, img[..., 0])
    else:
        cv2.imwrite(path, img[..., ::-1], params)
    data = open(path, "rb").read()
    if name == "restart":
        assert data.count(b"\xff\xd0") > 0
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1].astype(np.int32)
    got = image_io.read_jpeg(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    err = np.abs(got.astype(np.int32) - want)
    print(f"{name}: bit-identical share {(err == 0).mean():.6f}, max err "
          f"{err.max()}, mean err {err.mean():.6f}")
    assert err.max() <= JPEG_MAX_ERR
    assert err.mean() <= JPEG_MEAN_ERR
    np.testing.assert_array_equal(image_io.read_image(path), got)


def test_read_jpeg_refuses_progressive(tmp_path):
    """A progressive file whose last scan is missing leaves coefficient bits
    unknown; libjpeg block-smooths it, and so does the port, bit for bit
    (tests/test_torch_image_arith.py holds every cut).  One cut inside a
    scan, with no EOI, is refused, as cv2.imdecode refuses it (a file
    read from a path is read as cv2.imread reads it, through libjpeg's fake
    EOI: tests/test_torch_image_arith.py)."""
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, natural(40, 56), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = open(path, "rb").read()
    image_io.read_jpeg(path)
    with open(path, "wb") as f:
        f.write(data[:data.rfind(b"\xff\xda")] + b"\xff\xd9")
    np.testing.assert_array_equal(image_io.read_jpeg(path),
                                  cv2.imread(path)[..., ::-1])
    cut = data[:len(data) - 100]
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=r"no EOI.*ROADMAP Queue 1 item 16"):
        image_io.decode_jpeg(cut)
    with pytest.raises(ValueError):
        image_io.decode_jpeg(b"\xff\xd8\xff\xd9")


# ---------------------------------------------------------------------------
# JPEG encoding
# ---------------------------------------------------------------------------

def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("hw", [(480, 640), (73, 97)])
def test_write_jpeg_like_cv2(tmp_path, hw):
    img = natural(*hw, seed=5)
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "cv2.jpg")
    image_io.write_jpeg(ours, img, 95)
    cv2.imwrite(theirs, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    a = cv2.imread(ours)[..., ::-1]
    b = cv2.imread(theirs)[..., ::-1]
    diff = np.abs(a.astype(np.int32) - b).mean()
    dpsnr = abs(_psnr(a, img) - _psnr(b, img))
    same = open(ours, "rb").read() == open(theirs, "rb").read()
    print(f"{hw}: mean decode difference {diff:.6f}, PSNR difference "
          f"{dpsnr:.6f} dB, files byte-identical: {same}")
    assert diff <= ENC_MEAN_DIFF
    assert dpsnr <= ENC_PSNR_DB
    # and the port reads its own file as cv2 does
    np.testing.assert_array_equal(image_io.read_jpeg(ours), a)


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("scale", [0.5, 1.0, 0.37])
def test_resize_nearest_like_cv2(dtype, scale):
    rng = np.random.RandomState(0)
    for h, w in ((480, 640), (73, 97)):
        img = (rng.rand(h, w) * 1000).astype(dtype)
        size = (int(w * scale), int(h * scale))
        np.testing.assert_array_equal(
            image_io.resize_nearest(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))
    rgb = natural(73, 97)
    np.testing.assert_array_equal(
        image_io.resize_nearest(rgb, (35, 27)),
        cv2.resize(rgb, (35, 27), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("src,dst", [((96, 120), (60, 48)),
                                     ((96, 120), (40, 32)),
                                     ((96, 120), (30, 24)),
                                     ((480, 640), (320, 240)),
                                     ((96, 120), (24, 32))])
def test_resize_area_integer_ratio_exact(src, dst):
    img = natural(*src, seed=2)
    for a in (img, img[..., 1]):
        np.testing.assert_array_equal(
            image_io.resize_area(a, dst),
            cv2.resize(a, dst, interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("src,dst", [((968, 1296), (640, 480)),
                                     ((73, 97), (40, 30))])
def test_resize_area_fractional_ratio(src, dst):
    img = natural(*src, seed=4)
    got = image_io.resize_area(img, dst).astype(np.int32)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
    err = np.abs(got - want)
    print(f"{src}->{dst}: bit-identical share {(err == 0).mean():.6f}")
    assert err.max() <= 1
