"""The rest of cv2's JPEG and PNG reads in the port, against cv2 as the
oracle, bit for bit: arithmetic-coded JPEG (SOF9, SOF10, DAC conditioning,
restart intervals), libjpeg-turbo's block smoothing of progressive files
whose scans stop early (every scan-boundary cut, partial scan scripts),
scans whose data run out (cut inside a scan; a file cut off before its
EOI, read from a path as ``cv2.imread`` reads it), garbage coefficients
(Huffman scans read as arithmetic codes), and the truecolour PNG colour
key under ``cv2.imread(path, -1)``.

Tolerances (fixed before measuring): none.  Every decode equals cv2's
(channels reversed) in shape, dtype and every value; the share of
bit-identical values is printed for the JPEG files.  The committed files
are tests/test_torch_image_modes.py's fixtures (LIBJPEG_FILES, written by
the system libjpeg); their Huffman twins and digests are held there.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from bnv_fusion_tpu_torch.utils import image_io
from tests.test_torch_image_modes import (FIXTURE_DIR, LIBJPEG_FILES, cv2_jpeg,
                                          cv2_rgb, scene)


def exact(name, got, want):
    assert want is not None, f"{name}: cv2 read nothing"
    assert got.shape == want.shape and got.dtype == want.dtype
    print(f"{name}: bit-identical share "
          f"{(got == want).mean():.6f} of {got.size}")
    np.testing.assert_array_equal(got, want)


def fixture(name):
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# arithmetic coding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LIBJPEG_FILES)
def test_libjpeg_files_against_cv2(name):
    """SOF9 and SOF10 (4:2:0, 4:2:2, 4:4:4, grey, a restart interval,
    DAC L=2 U=6 Kx=24), their Huffman twins, the partial scan scripts and
    the 240x320 frames."""
    data = fixture(name)
    if name.startswith(("sof", "frame_sof")):
        sof = b"\xff\xc9" if "sof9" in name else b"\xff\xca"
        assert sof in data and b"\xff\xcc" in data           # SOF and DAC
    exact(name, image_io.decode_jpeg(data), cv2_rgb(data))


def test_dac_conditioning_is_used():
    """The non-default DAC changes the coded bits, not the image."""
    a, b = fixture("sof9_dac.jpg"), fixture("sof9_420.jpg")
    dac = a.find(b"\xff\xcc")
    assert a[dac:dac + 4] == b"\xff\xcc\x00\x0a"               # 4 tables
    assert a[dac + 4:dac + 12] == bytes([0x00, 0x62, 0x10, 24,  # (L, U), Kx
                                         0x01, 0x62, 0x11, 24])
    assert a[a.find(b"\xff\xda"):] != b[b.find(b"\xff\xda"):]
    np.testing.assert_array_equal(image_io.decode_jpeg(a),
                                  image_io.decode_jpeg(b))


# ---------------------------------------------------------------------------
# garbage coefficients, and scans whose data run out
# ---------------------------------------------------------------------------

def relabelled(data, sof):
    """``data`` with its frame marker changed to ``sof``: Huffman-coded
    scans read as arithmetic codes, garbage that libjpeg decodes up to its
    first impossible code and cv2 returns."""
    i = max(data.find(b"\xff\xc0"), data.find(b"\xff\xc2"))
    return data[:i + 1] + bytes([sof]) + data[i + 2:]


@pytest.mark.parametrize("seed", range(6))
def test_relabelled_huffman_against_cv2(seed):
    """Garbage coefficients: the impossible-code stop (to the next restart
    marker), and the IDCT's 16-bit wrapping and saturation (libjpeg-turbo's
    SIMD islow, which cv2 runs) where the values overflow."""
    hw = [(40, 56), (73, 97), (16, 16)][seed % 3]
    img = scene(*hw, seed=seed, noise=12.0)
    for prog in (False, True):
        data = relabelled(cv2_jpeg(img, prog, restart=seed % 3),
                          0xCA if prog else 0xC9)
        exact(f"relabelled {hw} prog={prog}", image_io.decode_jpeg(data),
              cv2_rgb(data))


def cut_points(data, step):
    """Every step-th offset inside the scans' entropy-coded data."""
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        start = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        end = start
        while not (data[end] == 0xFF and data[end + 1] not in
                   (0x00, 0xFF, *range(0xD0, 0xD8))):
            end += 1
        out += range(start + 1, end, step)
        i = data.find(b"\xff\xda", end)
    return out


@pytest.mark.parametrize("name", ["base_420.jpg", "prog_420.jpg",
                                  "prog_rst.jpg", "prog_grey.jpg",
                                  "sof9_420.jpg", "sof10_422.jpg"])
def test_cut_inside_a_scan_with_eoi(name):
    """Cut inside a scan and closed with EOI, which cv2.imdecode reads:
    past the marker a Huffman scan decodes the MCU it is in from zero bits
    and leaves the rest (jdhuff.c insufficient_data; smoothing then takes
    the previous scan's bits below that row), an arithmetic scan decodes
    zeros to its end (T.81 D.2.6)."""
    data = fixture(name)
    for end in cut_points(data, 23):
        cut = data[:end] + b"\xff\xd9"
        exact(f"{name} cut at {end}", image_io.decode_jpeg(cut),
              cv2_rgb(cut))


@pytest.mark.parametrize("name", ["base_rst.jpg", "prog_422.jpg",
                                  "sof10_grey.jpg"])
def test_file_cut_without_eoi(tmp_path, name):
    """A file cut off before its EOI: cv2.imread (the JAX readers' call)
    reads it through libjpeg's fake EOI, and so do the port's path
    readers; cv2.imdecode of the bytes returns None, and decode_jpeg
    refuses them."""
    data = fixture(name)
    path = str(tmp_path / name)
    for end in list(cut_points(data, 19)) + [len(data) - 2]:
        with open(path, "wb") as f:
            f.write(data[:end])
        assert cv2_rgb(data[:end]) is None
        with pytest.raises(ValueError, match=r"no EOI.*item 16"):
            image_io.decode_jpeg(data[:end])
        exact(f"{name} cut at {end}", image_io.read_image(path),
              cv2_rgb(path))


# ---------------------------------------------------------------------------
# block smoothing
# ---------------------------------------------------------------------------

def scan_cuts(data):
    """The file cut at each inner scan boundary, EOI appended: what a
    download stopped between scans leaves."""
    starts, i = [], data.find(b"\xff\xda")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return [data[:s] + b"\xff\xd9" for s in starts[1:]]


PROGRESSIVE_FIXTURES = ["prog_420.jpg", "prog_422.jpg", "prog_444.jpg",
                        "prog_grey.jpg", "prog_rst.jpg", "frame_prog.jpg",
                        "sof10_420.jpg", "sof10_422.jpg", "sof10_444.jpg",
                        "sof10_grey.jpg", "sof10_rst.jpg", "sof10_dac.jpg",
                        "part6_sof10.jpg"]


@pytest.mark.parametrize("name", PROGRESSIVE_FIXTURES)
def test_scan_boundary_cuts_of_fixtures(name):
    data = fixture(name)
    cuts = scan_cuts(data)
    assert len(cuts) == (5 if name.startswith("part6") else
                         5 if "grey" in name else 9)
    for k, cut in enumerate(cuts):
        exact(f"{name} after scan {k + 1}", image_io.decode_jpeg(cut),
              cv2_rgb(cut))


SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "grey": None}


@pytest.mark.parametrize("hw", [(8, 64), (16, 72), (64, 8), (72, 16),
                                (17, 9), (9, 17), (24, 40), (1, 1)])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_scan_boundary_cuts_at_the_edges(sampling, hw):
    """Images 1 and 2 blocks (or MCUs) wide or high, where the 5x5 window
    clamps at every side and libjpeg's iMCU-row bookkeeping reaches MCU
    padding rows; every cut of cv2's own progressive script."""
    img = scene(*hw, seed=hw[0] + hw[1], noise=12.0)
    if sampling == "grey":
        img = img[..., 1]
    kw = {} if sampling == "grey" else dict(sampling=SAMPLINGS[sampling])
    data = cv2_jpeg(img, True, quality=80, **kw)
    for k, cut in enumerate(scan_cuts(data)):
        exact(f"{sampling} {hw} after scan {k + 1}",
              image_io.decode_jpeg(cut), cv2_rgb(cut))


def test_smoothed_frame_differs_from_its_complete_file():
    """frame_smooth.jpg keeps 4 of 10 scans: smoothing fills in what the
    missing scans would have added, so it is near the complete file."""
    part = image_io.decode_jpeg(fixture("frame_smooth.jpg"))
    full = image_io.decode_jpeg(fixture("frame_base.jpg"))
    err = np.abs(part.astype(np.int32) - full)
    print(f"frame_smooth vs the complete frame: mean err {err.mean():.3f}")
    assert 0 < err.mean() < 8


# ---------------------------------------------------------------------------
# the PNG colour key
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_with_trns(img, trns, interlace=False):
    """A PNG of grey [H, W] or RGB [H, W, 3] samples (8 or 16 bits) with a
    tRNS chunk of the given bytes, plain or Adam7, filter type 0."""
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(">u2").view(np.uint8) if depth == 16 else sub
        rows = np.ascontiguousarray(rows).reshape(sub.shape[0], -1)
        raw += np.concatenate([np.zeros((len(rows), 1), np.uint8), rows],
                              1).tobytes()
    return (image_io.PNG_SIG +
            _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                        int(interlace))) +
            _chunk(b"tRNS", trns) + _chunk(b"IDAT", zlib.compress(raw)) +
            _chunk(b"IEND", b""))


def swap16(v):
    return ((v & 0xFF) << 8) | (v >> 8)


def keyed_rgb(depth, seed=0):
    """An 11x9 RGB image and its colour key: pixels at the key, at the key
    byte-swapped (16 bits) or with a high byte the key lacks (8 bits)."""
    rng = np.random.RandomState(seed)
    if depth == 16:
        img = rng.randint(0, 65536, (9, 11, 3)).astype(np.uint16)
        key = (1000, 2000, 3000)
        img[1, 1] = img[6, 9] = key
        img[4, 5] = [swap16(k) for k in key]
        return img, struct.pack(">HHH", *key), key
    img = (rng.randint(0, 4, (9, 11, 3)) * 60).astype(np.uint8)
    key = tuple(int(v) for v in img[2, 3])
    # libpng compares an 8-bit image with the key's low bytes only
    return img, struct.pack(">HHH", key[0] + 256, key[1], key[2]), key


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_colour_key_against_cv2(depth, interlace):
    """Colour type 2 with a 6-byte tRNS under -1: [H, W, 4] with alpha 0
    exactly where all three samples equal the key (the 16-bit key compares
    as stored, not byte-swapped), full elsewhere; the colour read drops
    the alpha."""
    img, trns, key = keyed_rgb(depth)
    data = png_with_trns(img, trns, interlace)
    want = cv2_rgb(data, cv2.IMREAD_UNCHANGED)     # BGRA -> ARGB reversed
    want = np.concatenate([want[..., 1:], want[..., :1]], -1)
    got = image_io.decode_png(data, unchanged=True)
    exact(f"{depth}-bit colour key", got, want)
    top = np.iinfo(img.dtype).max
    assert got.shape == img.shape[:2] + (4,) and got.dtype == img.dtype
    np.testing.assert_array_equal(got[..., :3], img)
    np.testing.assert_array_equal(
        got[..., 3], np.where((img == np.array(key)).all(-1), 0, top))
    assert (got[..., 3] == 0).sum() == (2 if depth == 16 else
                                        int((img == key).all(-1).sum()))
    exact(f"{depth}-bit colour key, colour read",
          image_io.decode_png(data, unchanged=False), cv2_rgb(data))


@pytest.mark.parametrize("depth", [8, 16])
def test_png_grey_key_and_bad_key_against_cv2(depth):
    """Grey with a tRNS key stays grey [H, W] under -1, as in cv2; a
    truecolour tRNS of the wrong length is ignored (3 channels)."""
    dtype = np.uint16 if depth == 16 else np.uint8
    grey = (np.arange(63).reshape(7, 9) * (1000 if depth == 16 else 4)
            ).astype(dtype)
    data = png_with_trns(grey, struct.pack(">H", int(grey[2, 2])))
    exact("grey key", image_io.decode_png(data),
          cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))
    img, trns, _ = keyed_rgb(depth, seed=1)
    bad = png_with_trns(img, trns + b"\0\0")
    exact("8-byte tRNS", image_io.decode_png(bad),
          cv2_rgb(bad, cv2.IMREAD_UNCHANGED))
    assert image_io.decode_png(bad).shape == img.shape
