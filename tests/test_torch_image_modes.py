"""The port's colour read against cv2's ``imread(IMREAD_COLOR)`` and
``resize(INTER_AREA)``, as the JAX package calls them: EXIF orientation,
progressive and 4-component (CMYK, YCCK) JPEG, the area resize where an axis
grows, the JPEG files cv2 refuses (and the odd ones it reads), and the
committed fixtures under tests/data/torch_image_modes/ (which the card's
smoke run decodes too; tests/test_torch_image_arith.py holds the
arithmetic-coded and partial progressive ones to cv2 bit for bit).

Tolerances (fixed before measuring):
- JPEG decoding: tests/test_torch_image_io.py's JPEG_MAX_ERR and
  JPEG_MEAN_ERR; the share of bit-identical values is printed.
- A progressive or arithmetic-coded file and its baseline Huffman twin
  (same quality and sampling, so the same coefficients): exactly equal in
  the port.
- The files cv2 reads among the odd ones: exactly equal to cv2.
- EXIF orientation: the geometry exact; the pixels exact for PNG and at the
  JPEG tolerance for JPEG.  The unchanged read ignores the tag.
- ``resize_area`` where an axis grows: exact against cv2.  cv2 takes its
  linear resize with area coefficients there; its uint8 vertical pass has a
  vector body (VResizeLinearVec_32s8u) and a scalar tail, and both round as
  ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2 in this
  build: the widths below leave tails of every length mod 16 and 32.
- Committed fixtures: the port's decodes hash to digests.json.

Regenerate the fixtures (needs cv2, PIL, gcc and the system libjpeg, whose
writer makes the arithmetic-coded files and partial scan scripts) with
``PYTHONPATH=. python tests/test_torch_image_modes.py``; the digests are the
port's own.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import tempfile
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from bnv_fusion_tpu_torch.utils import image_io

JPEG_MAX_ERR = 2
JPEG_MEAN_ERR = 0.5
ITEM = r"ROADMAP Queue 1 item 16"
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "data",
                           "torch_image_modes")
FRAME_HW = (240, 320)        # the colour frames; the depth is 480x640
DEPTH_HW = (480, 640)


def scene(h, w, seed=0, noise=3.0):
    """Smooth colour fields, a flat patch with sharp edges and mild noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 37 + yy / 53),
                    128 + 90 * np.cos(xx / 23 - yy / 41),
                    128 + 60 * np.sin((xx + yy) / 17)], -1)
    img += rng.randn(h, w, 3) * noise
    img[h // 4:h // 2, w // 3:w // 2] = [250, 20, 40]
    return np.clip(img, 0, 255).astype(np.uint8)


def cmyk_of(rgb):
    """A CMYK image whose K is a smooth field of its own."""
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    k = np.clip(60 + 50 * np.sin(xx / 29) * np.cos(yy / 31), 0, 255)
    return np.concatenate([255 - rgb, k[..., None].astype(np.uint8)], -1)


def cv2_rgb(path_or_bytes, flags=cv2.IMREAD_COLOR):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        img = cv2.imdecode(np.frombuffer(path_or_bytes, np.uint8), flags)
    else:
        img = cv2.imread(path_or_bytes, flags)
    return None if img is None else img[..., ::-1]


def within_jpeg_tol(name, got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    err = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name}: bit-identical share {(err == 0).mean():.6f}, max err "
          f"{err.max()}, mean err {err.mean():.6f}")
    assert err.max() <= JPEG_MAX_ERR
    assert err.mean() <= JPEG_MEAN_ERR


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def orient(img, o):
    """The EXIF orientations written out by hand (TIFF 6.0's meaning)."""
    t = np.swapaxes(img, 0, 1)
    return {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
            5: t, 6: t[:, ::-1], 7: t[::-1, ::-1], 8: t[::-1]}[o]


def exif_block(o, order=b"MM"):
    e = "<" if order == b"II" else ">"
    return (order + struct.pack(e + "HIH", 42, 8, 1) +
            struct.pack(e + "HHIHH", 0x0112, 3, 1, o, 0) + b"\0\0\0\0")


def with_app1(jpeg, *bodies):
    """A JPEG with its APP1 segments replaced by ``bodies``, after SOI and
    APP0."""
    pos, segs = 2, []
    while jpeg[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        segs.append(jpeg[pos:pos + 2 + n])
        pos += 2 + n
    segs = [s for s in segs if s[1] != 0xE1]
    app1 = b"".join(b"\xff\xe1" + struct.pack(">H", len(b) + 2) + b
                    for b in bodies)
    return jpeg[:2] + segs[0] + app1 + b"".join(segs[1:]) + jpeg[pos:]


def cv2_jpeg(img, progressive=False, **kw):
    params = [cv2.IMWRITE_JPEG_QUALITY, kw.get("quality", 90)]
    if "sampling" in kw:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, kw["sampling"]]
    if kw.get("restart"):
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, kw["restart"]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    src = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def pil_bytes(img, mode, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, fmt, **kw)
    return buf.getvalue()


# The system libjpeg's writer, for the files cv2 cannot write: arithmetic
# coding with chosen DAC conditioning, and progressive files whose scan
# script stops early.  Only make_fixtures compiles it (gcc ... -ljpeg).
#   writer in.raw out.jpg W H C quality h v arith progressive restart L U K
#          nscans
LIBJPEG_WRITER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  int a[16];
  if (argc != 16) return 2;
  for (int i = 3; i < 16; i++) a[i] = atoi(argv[i]);
  size_t n = (size_t)a[3] * a[4] * a[5];
  unsigned char *px = malloc(n);
  FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
  if (!in || !out || fread(px, 1, n, in) != n) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = a[3];
  c.image_height = a[4];
  c.input_components = a[5];
  c.in_color_space = a[5] == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, a[6], TRUE);
  c.comp_info[0].h_samp_factor = a[7];
  c.comp_info[0].v_samp_factor = a[8];
  c.arith_code = a[9];
  c.optimize_coding = FALSE;
  c.restart_interval = a[11];
  for (int t = 0; t < NUM_ARITH_TBLS; t++) {
    c.arith_dc_L[t] = a[12];
    c.arith_dc_U[t] = a[13];
    c.arith_ac_K[t] = a[14];
  }
  if (a[10]) {
    jpeg_simple_progression(&c);
    if (a[15] > 0 && a[15] < c.num_scans) c.num_scans = a[15];
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * a[3] * a[5];
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  return fclose(out) != 0;
}
"""


def libjpeg_writer(work_dir):
    """Compile LIBJPEG_WRITER_C into work_dir; returns the executable."""
    src, exe = os.path.join(work_dir, "writer.c"), os.path.join(work_dir,
                                                                "writer")
    with open(src, "w") as f:
        f.write(LIBJPEG_WRITER_C)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-ljpeg"], check=True)
    return exe


def libjpeg_jpeg(writer, img, quality=85, sampling=(2, 2), arith=False,
                 progressive=False, restart=0, dac=(0, 1, 5), scans=0):
    """A JPEG written by the system libjpeg (Huffman tables not optimized,
    so a Huffman and an arithmetic file share their coefficients): RGB or
    grey ``img``, luma ``sampling`` (h, v), ``restart`` MCUs per interval,
    ``dac`` = (L, U, Kx) for every table, jpeg_simple_progression's script
    cut to its first ``scans`` scans (0 = all)."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        with open(raw, "wb") as f:
            f.write(np.ascontiguousarray(img, np.uint8).tobytes())
        hv = (1, 1) if c == 1 else sampling
        subprocess.run([writer, raw, out] + [str(int(v)) for v in (
            w, h, c, quality, hv[0], hv[1], arith, progressive, restart,
            *dac, scans)], check=True)
        with open(out, "rb") as f:
            return f.read()


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

PROG_CASES = {
    "420": dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
    "422": dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
    "444": dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    "grey": dict(),
    "restart": dict(restart=2),
    "q60_420": dict(quality=60),
    "q98_444": dict(quality=98,
                    sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
}


@pytest.mark.parametrize("hw", [(73, 97), (64, 48), (17, 9)])
@pytest.mark.parametrize("case", list(PROG_CASES))
def test_progressive_against_cv2(case, hw):
    img = scene(*hw, seed=len(case), noise=12.0)
    if case == "grey":
        img = img[..., 1]
    prog = cv2_jpeg(img, True, **PROG_CASES[case])
    base = cv2_jpeg(img, False, **PROG_CASES[case])
    assert b"\xff\xc2" in prog and b"\xff\xc2" not in base
    if case == "restart":
        assert prog.count(b"\xff\xd0") > 0
    got = image_io.decode_jpeg(prog)
    within_jpeg_tol(f"progressive {case} {hw}", got, cv2_rgb(prog))
    np.testing.assert_array_equal(got, image_io.decode_jpeg(base))


def test_progressive_written_by_pil():
    """libjpeg's own scan script through PIL (optimized Huffman tables)."""
    img = scene(57, 83, seed=3, noise=12.0)
    prog = pil_bytes(img, "RGB", "JPEG", quality=85, progressive=True,
                     optimize=True)
    base = pil_bytes(img, "RGB", "JPEG", quality=85)
    got = image_io.decode_jpeg(prog)
    within_jpeg_tol("PIL progressive", got, cv2_rgb(prog))
    np.testing.assert_array_equal(got, image_io.decode_jpeg(base))


# ---------------------------------------------------------------------------
# 4-component JPEG
# ---------------------------------------------------------------------------

def _cmyk_variant(kind):
    data = pil_bytes(cmyk_of(scene(41, 67, seed=5, noise=12.0)), "CMYK",
                     "JPEG", quality=90, progressive=kind == "progressive")
    i = data.find(b"\xff\xee\x00\x0eAdobe")
    assert i > 0 and data[i + 15] == 0       # APP14 transform 0: CMYK
    if kind == "ycck":
        data = data[:i + 15] + b"\x02" + data[i + 16:]
    elif kind == "no_adobe":
        (n,) = struct.unpack(">H", data[i + 2:i + 4])
        data = data[:i] + data[i + 2 + n:]
    return data


@pytest.mark.parametrize("kind", ["cmyk", "ycck", "no_adobe", "progressive"])
def test_four_components_against_cv2(kind):
    data = _cmyk_variant(kind)
    within_jpeg_tol(kind, image_io.decode_jpeg(data), cv2_rgb(data))


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o", range(1, 9))
@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_exif_orientation(tmp_path, fmt, o):
    img = scene(24, 40, seed=o, noise=12.0)
    ex = Image.Exif()
    ex[0x0112] = o
    path = str(tmp_path / f"o{o}.{'jpg' if fmt == 'jpeg' else 'png'}")
    Image.fromarray(img).save(path, exif=ex, quality=92)
    want = cv2_rgb(path)
    got = image_io.read_image(path)
    assert got.shape == want.shape == orient(img, o).shape
    if fmt == "png":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, orient(img, o))
        # the unchanged read (depth, confidence) ignores the tag, as -1 does
        np.testing.assert_array_equal(image_io.read_png(path),
                                      cv2_rgb(path, cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(image_io.read_png(path), img)
    else:
        within_jpeg_tol(f"orientation {o}", got, want)
        np.testing.assert_array_equal(
            got, orient(cv2_rgb(path, cv2.IMREAD_COLOR |
                                cv2.IMREAD_IGNORE_ORIENTATION), o))


def test_exif_orientation_3_fault(tmp_path):
    """The colour fault the tag caused: orientation 3 keeps the size, so
    reading the stored pixels raised nothing and fused the wrong colours."""
    img = scene(64, 96, seed=0, noise=12.0)
    ex = Image.Exif()
    ex[0x0112] = 3
    path = str(tmp_path / "o3.jpg")
    Image.fromarray(img).save(path, exif=ex, quality=95)
    want = cv2_rgb(path)
    stored = cv2_rgb(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    assert np.abs(stored.astype(np.int32) - want).mean() > 20
    within_jpeg_tol("orientation 3 via read_color",
                    image_io.read_color(path), want)
    within_jpeg_tol("orientation 3 via read_color(hw)",
                    image_io.read_color(path, (64, 96)), want)


def _exif_variants():
    """(name, APP1 bodies) whose orientation cv2's ExifReader reads as it
    reads them (a tag whose value lies out of range ends the IFD walk)."""
    def tiff(order, entries, tail=b""):
        e = "<" if order == b"II" else ">"
        out = order + struct.pack(e + "HIH", 42, 8, len(entries))
        for tag, typ, cnt, val in entries:
            out += struct.pack(e + "HHI", tag, typ, cnt) + val
        return out + b"\0\0\0\0" + tail

    def u32(order, v):
        return struct.pack("<I" if order == b"II" else ">I", v)

    def short(order, v):
        return struct.pack("<HH" if order == b"II" else ">HH", v, 0)

    o3, xh = (0x0112, 3, 1, short(b"MM", 3)), b"Exif\0\0"
    out = [
        ("no_exif_header", [b"XXXX\0\0" + exif_block(3)]),
        ("xmp_then_exif", [b"http://ns.adobe.com/xap/1.0/\0<x/>",
                           xh + exif_block(3)]),
        ("little_endian", [xh + exif_block(6, b"II")]),
        ("two_blocks_first_wins", [xh + exif_block(3), xh + exif_block(6)]),
        ("no_entry_then_block", [xh + tiff(b"MM", [(0x0100, 3, 1,
                                                    short(b"MM", 9))]),
                                 xh + exif_block(8)]),
        ("value_9", [xh + exif_block(9)]),
        ("magic_43", [xh + exif_block(3)[:2] + b"\0\x2b" +
                      exif_block(3)[4:]]),
        ("inline_model", [xh + tiff(b"MM", [(0x0110, 2, 3, b"A7\0\0"), o3])]),
        ("bad_string_offset", [xh + tiff(b"MM", [(0x0131, 2, 30,
                                                  u32(b"MM", 4000)), o3])]),
        ("bad_rational_offset", [xh + tiff(b"MM", [(0x011A, 5, 1,
                                                    u32(b"MM", 4000)), o3])]),
        ("rational_at_end", [xh + tiff(b"MM", [(0x013E, 5, 2,
                                                u32(b"MM", 38)), o3],
                                       b"\0" * 16)]),
        ("rational_past_end", [xh + tiff(b"MM", [(0x013E, 5, 2,
                                                  u32(b"MM", 39)), o3],
                                         b"\0" * 16)]),
        ("long_type_le", [xh + tiff(b"II", [(0x0112, 4, 1, u32(b"II", 3))])]),
        ("long_type_be", [xh + tiff(b"MM", [(0x0112, 4, 1, u32(b"MM", 3))])]),
        ("truncated_value", [xh + exif_block(3)[:-5]]),
        ("count_past_end", [xh + exif_block(3)[:8] + b"\0\x05" +
                            exif_block(3)[10:-4]]),
        ("empty", [b""]),
        ("header_only", [xh]),
    ]
    return out


@pytest.mark.parametrize("name,bodies", _exif_variants(),
                         ids=[v[0] for v in _exif_variants()])
def test_exif_variants_against_cv2(name, bodies):
    base = cv2_jpeg(scene(24, 40, seed=1, noise=12.0), quality=92)
    data = with_app1(base, *bodies)
    want = cv2_rgb(data)
    got = image_io.decode_jpeg(data)
    assert got.shape == want.shape
    within_jpeg_tol(name, got, want)


def _exif_chunk(body):
    return (struct.pack(">I", len(body)) + b"eXIf" + body +
            struct.pack(">I", zlib.crc32(b"eXIf" + body)))


@pytest.mark.parametrize("case", ["before_idat", "after_idat", "exif_prefix",
                                  "two_chunks"])
def test_exif_png_chunks_against_cv2(case):
    """Where the eXIf chunk sits and what it holds: libpng keeps the first
    one and refuses one that starts with "Exif\\0\\0"."""
    img = scene(20, 30, seed=2)
    png = image_io.encode_png(img)
    head, idat_on, iend = png[:33], png[33:-12], png[-12:]   # after IHDR
    o6 = _exif_chunk(exif_block(6))
    data = {"before_idat": head + o6 + idat_on + iend,
            "after_idat": head + idat_on + o6 + iend,
            "exif_prefix": head + _exif_chunk(b"Exif\0\0" + exif_block(6)) +
            idat_on + iend,
            "two_chunks": head + _exif_chunk(exif_block(3)) + idat_on + o6 +
            iend}[case]
    want = cv2_rgb(data)
    np.testing.assert_array_equal(image_io.decode_png(data, unchanged=False),
                                  want)
    assert want.shape[:2] == ((20, 30) if case in ("exif_prefix",
                                                   "two_chunks") else (30, 20))
    np.testing.assert_array_equal(image_io.decode_png(data), img)


# ---------------------------------------------------------------------------
# INTER_AREA where an axis grows
# ---------------------------------------------------------------------------

GROW_CASES = [((240, 320), (640, 480)),    # the colour frames onto the depth
              ((40, 50), (100, 80)),
              ((7, 9), (20, 13)),
              ((13, 17), (31, 29)),
              ((5, 3), (7, 11)),
              ((50, 40), (30, 90)),        # mixed: width shrinks
              ((50, 40), (90, 30)),        # mixed: height shrinks
              ((50, 40), (40, 90)),        # one axis unchanged
              ((30, 31), (47, 33)),
              ((1, 1), (3, 2))]


@pytest.mark.parametrize("src,dst", GROW_CASES,
                         ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}"
                              for s, d in GROW_CASES])
def test_resize_area_grows_like_cv2(src, dst):
    img = scene(*src, seed=4, noise=30.0)
    for a in (img, img[..., 1], np.ascontiguousarray(img[..., :2])):
        np.testing.assert_array_equal(
            image_io.resize_area(a, dst),
            cv2.resize(a, dst, interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("width", range(33, 50))
def test_resize_area_grow_vector_tails(width):
    """Destination rows of every length mod 16 and 32 (uint8 lanes of SSE
    and AVX2) and 3 channels: the vertical pass's scalar tail."""
    img = scene(9, 11, seed=width, noise=40.0)
    for a in (img, img[..., 0]):
        np.testing.assert_array_equal(
            image_io.resize_area(a, (width, 14)),
            cv2.resize(a, (width, 14), interpolation=cv2.INTER_AREA))


# ---------------------------------------------------------------------------
# the files cv2 refuses, and the odd ones it reads
# ---------------------------------------------------------------------------

DC_BITS = [0, 0, 0, 0, 16] + [0] * 11        # DC sizes 0-15, 5-bit codes
AC_EOB_BITS = [1] + [0] * 15                 # AC: end-of-block only


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n):
        for i in range(n - 1, -1, -1):
            self.acc, self.n = (self.acc << 1) | ((v >> i) & 1), self.n + 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def diff(self, d):
        """A DC (or lossless) difference with the DC_BITS table."""
        s = abs(d).bit_length()
        self.put(s, 5)
        if s:
            self.put(d if d >= 0 else d - 1 + (1 << s), s)

    def bytes(self):
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


def flat_jpeg(dc, precision=8, sof=0xC1):
    """A Huffman JPEG of flat blocks, built by hand: dc [components, block
    rows, block columns] quantized DC values, every table 1, 1x1 sampling."""
    nc, bh, bw = dc.shape
    out = b"\xff\xd8" + _segment(0xDB, bytes([0] + [1] * 64))
    out += _segment(sof, struct.pack(">BHHB", precision, bh * 8, bw * 8, nc) +
                    b"".join(bytes([c + 1, 0x11, 0]) for c in range(nc)))
    out += _segment(0xC4, bytes([0x00] + DC_BITS + list(range(16))))
    out += _segment(0xC4, bytes([0x10] + AC_EOB_BITS + [0]))
    out += _segment(0xDA, bytes([nc]) + b"".join(bytes([c + 1, 0])
                                                  for c in range(nc)) +
                    bytes([0, 63, 0]))
    bits, pred = _BitWriter(), [0] * nc
    for y in range(bh):
        for x in range(bw):
            for c in range(nc):
                bits.diff(int(dc[c, y, x]) - pred[c])
                pred[c] = int(dc[c, y, x])
                bits.put(0, 1)                   # end of block
    return out + bits.bytes() + b"\xff\xd9"


def lossless_jpeg(grey):
    """An 8-bit lossless JPEG (SOF3, predictor 1, no point transform)."""
    h, w = grey.shape
    out = b"\xff\xd8" + _segment(0xC3, struct.pack(">BHHB", 8, h, w, 1) +
                                 bytes([1, 0x11, 0]))
    out += _segment(0xC4, bytes([0x00] + DC_BITS + list(range(16))))
    out += _segment(0xDA, bytes([1, 1, 0, 1, 0, 0]))
    x, bits = grey.astype(np.int64), _BitWriter()
    for r in range(h):
        for c in range(w):
            pred = (128 if r == c == 0 else x[r, c - 1] if c else x[r - 1, c])
            bits.diff(int(x[r, c] - pred))
    return out + bits.bytes() + b"\xff\xd9"


def _refused_fixture(mode):
    rng = np.random.RandomState(0)
    img = scene(40, 56, seed=3, noise=12.0)
    base, prog = cv2_jpeg(img), cv2_jpeg(img, True)
    sof = base.find(b"\xff\xc0")
    if mode == "arithmetic_sequential":      # the scan read as arithmetic
        return base[:sof + 1] + b"\xc9" + base[sof + 2:]
    if mode == "arithmetic_progressive":
        i = prog.find(b"\xff\xc2")
        return prog[:i + 1] + b"\xca" + prog[i + 2:]
    if mode.startswith("hierarchical"):
        return base[:sof + 1] + bytes([0xC0 + int(mode[-1])]) + base[sof + 2:]
    if mode == "lossless":
        return lossless_jpeg(rng.randint(0, 256, (24, 32)).astype(np.uint8))
    if mode == "12_bit":
        return flat_jpeg(rng.randint(-1600, 1600, (3, 3, 4)), precision=12)
    if mode == "2_components":
        return flat_jpeg(rng.randint(-100, 100, (2, 3, 4)))
    if mode == "dnl_height":
        body = base[:sof + 5] + b"\0\0" + base[sof + 7:-2]
        return body + b"\xff\xdc\x00\x04" + struct.pack(">H", 40) + b"\xff\xd9"
    if mode == "arithmetic_restart":         # and restart markers
        rst = cv2_jpeg(img, restart=2)
        i = rst.find(b"\xff\xc0")
        return rst[:i + 1] + b"\xc9" + rst[i + 2:]
    if mode.startswith("sof"):               # arithmetic lossless (SOF11),
        return base[:sof + 1] + bytes([int(mode[3:], 16)]) + base[sof + 2:]
    if mode == "progressive_cut":            # its last scan dropped
        return prog[:prog.rfind(b"\xff\xda")] + b"\xff\xd9"
    if mode.endswith("mid_scan"):            # cut inside its last scan
        if mode.startswith("arithmetic"):
            with open(os.path.join(FIXTURE_DIR, "sof10_420.jpg"), "rb") as f:
                prog = f.read()
        last = prog.rfind(b"\xff\xda")
        return prog[:(last + len(prog)) // 2]
    raise KeyError(mode)


# what cv2 (imdecode, IMREAD_COLOR) does with each file: True = returns an
# image, which the port returns bit for bit; False = returns None (the
# port's ValueError is the JAX package's outcome: the readers fail on None).
# cv2.imread of the file on disk differs for the two cut mid-scan only:
# libjpeg's file source ends them with a fake EOI, as the port's path
# readers do (tests/test_torch_image_arith.py).
CV2_READS = {
    "arithmetic_sequential": True,      # Huffman data read as arithmetic
                                        # codes: garbage up to the first
                                        # impossible code, then zero blocks
    "arithmetic_progressive": True,     # ... the coefficients it reached
    "arithmetic_restart": True,         # ... until each restart marker
    "hierarchical_5": False,
    "hierarchical_6": False,
    "hierarchical_7": False,
    "lossless": False,
    "12_bit": False,
    "2_components": False,
    "dnl_height": False,
    "progressive_cut": True,            # block-smoothed
    "sofcb": False,                     # lossless, arithmetic coding
    "sofcd": False,                     # hierarchical, arithmetic coding
    "sofce": False,
    "sofcf": False,
    "progressive_mid_scan": False,      # no EOI: libjpeg's input ends
    "arithmetic_mid_scan": False,
}


@pytest.mark.parametrize("mode", list(CV2_READS))
def test_refused_modes(mode):
    """The files cv2 returns None for are refused, naming the ROADMAP item;
    the ones it reads (the first three relabelled to arithmetic coding,
    a progressive file missing its last scan) are read as it reads them."""
    data = _refused_fixture(mode)
    want = cv2_rgb(data)
    assert (want is not None) == CV2_READS[mode]
    if want is not None:
        np.testing.assert_array_equal(image_io.decode_jpeg(data), want)
        return
    with pytest.raises(ValueError, match=ITEM):
        image_io.decode_jpeg(data)


def test_hand_built_files_are_valid():
    """The builders' files are real: the 8-bit flat file decodes to its
    DC levels in cv2 and the port, the lossless one exactly in PIL."""
    rng = np.random.RandomState(1)
    dc = rng.randint(-100, 100, (1, 3, 4))
    flat = flat_jpeg(dc)
    level = np.clip((dc[0] + 4) // 8 + 128, 0, 255)   # a DC-only IDCT
    want = np.repeat(np.repeat(level, 8, 0), 8, 1).astype(np.uint8)
    np.testing.assert_array_equal(cv2_rgb(flat)[..., 0], want)
    np.testing.assert_array_equal(image_io.decode_jpeg(flat)[..., 0], want)
    grey = rng.randint(0, 256, (24, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(lossless_jpeg(grey)))), grey)


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

# the system libjpeg's arithmetic-coded files at 53x37: luma sampling (h,
# v) (None: grey), restart interval in MCUs, DAC (L, U, Kx) of every table
ARITH_CASES = {"420": ((2, 2), 0, (0, 1, 5)), "422": ((2, 1), 0, (0, 1, 5)),
               "444": ((1, 1), 0, (0, 1, 5)), "grey": (None, 0, (0, 1, 5)),
               "rst": ((2, 2), 2, (0, 1, 5)), "dac": ((2, 2), 0, (2, 6, 24))}
# its progressive files with jpeg_simple_progression's script cut short:
# name -> (arithmetic coding, scans kept)
PARTIAL_SCRIPTS = {"part2_sof2.jpg": (False, 2), "part6_sof10.jpg": (True, 6)}
FRAME_SMOOTH_SCANS = 4       # frame_smooth.jpg: DC, Y AC 1-5, Cr and Cb AC

TWINS = {f"prog_{k}.jpg": f"base_{k}.jpg"
         for k in ("420", "422", "444", "grey", "rst")}
TWINS["frame_prog.jpg"] = "frame_base.jpg"
for _k in ARITH_CASES:       # SOF9 and SOF10 against their Huffman twin
    TWINS[f"sof9_{_k}.jpg"] = TWINS[f"sof10_{_k}.jpg"] = f"huff_{_k}.jpg"
TWINS["frame_sof9.jpg"] = TWINS["frame_sof10.jpg"] = "frame_base.jpg"
FRAMES = ("frame_prog.jpg", "frame_o6.jpg", "frame_cmyk.jpg",
          "frame_base.jpg", "frame_sof9.jpg", "frame_sof10.jpg",
          "frame_smooth.jpg")
# the files only the system libjpeg writes: arithmetic coding and partial
# scan scripts (bit-identical to cv2 in tests/test_torch_image_arith.py)
LIBJPEG_FILES = sorted([f"{kind}_{k}.jpg" for kind in ("sof9", "sof10", "huff")
                        for k in ARITH_CASES] + list(PARTIAL_SCRIPTS) +
                       ["frame_sof9.jpg", "frame_sof10.jpg",
                        "frame_smooth.jpg"])


def make_fixtures(out_dir=FIXTURE_DIR):
    """Write the fixture files with cv2 and PIL, and digests.json with the
    SHA-256 of the port's decode of each (read_image: EXIF orientation
    applied), of each colour frame area-resized onto the 480x640 depth, and
    each file's EXIF orientation."""
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    small = scene(73, 97, seed=1, noise=6.0)
    for k, kw in (("420", dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
                  ("422", dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
                  ("444", dict(sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
                  ("grey", dict()), ("rst", dict(restart=3))):
        img = small[..., 1] if k == "grey" else small
        files[f"prog_{k}.jpg"] = cv2_jpeg(img, True, quality=85, **kw)
        files[f"base_{k}.jpg"] = cv2_jpeg(img, False, quality=85, **kw)
    cmyk = pil_bytes(cmyk_of(small), "CMYK", "JPEG", quality=85)
    i = cmyk.find(b"\xff\xee\x00\x0eAdobe")
    files["cmyk.jpg"] = cmyk
    files["ycck.jpg"] = cmyk[:i + 15] + b"\x02" + cmyk[i + 16:]
    ex_img = scene(48, 64, seed=2, noise=6.0)
    for o in range(2, 9):
        files[f"exif_o{o}.jpg"] = with_app1(cv2_jpeg(ex_img, quality=85),
                                            b"Exif\0\0" + exif_block(o))
    ex = Image.Exif()
    ex[0x0112] = 6
    files["exif_o6.png"] = pil_bytes(ex_img, "RGB", "PNG", exif=ex)
    frame = scene(*FRAME_HW, seed=0)
    files["frame_prog.jpg"] = cv2_jpeg(frame, True, quality=85)
    files["frame_base.jpg"] = cv2_jpeg(frame, False, quality=85)
    files["frame_o6.jpg"] = with_app1(
        cv2_jpeg(np.ascontiguousarray(orient(frame, 8)), quality=85),
        b"Exif\0\0" + exif_block(6))          # stored 320x240
    files["frame_cmyk.jpg"] = pil_bytes(cmyk_of(frame), "CMYK", "JPEG",
                                        quality=85)
    with tempfile.TemporaryDirectory() as work:
        writer = libjpeg_writer(work)
        arith_img = scene(37, 53, seed=7, noise=6.0)
        for k, (hv, rst, dac) in ARITH_CASES.items():
            img = arith_img[..., 1] if hv is None else arith_img
            kw = dict(sampling=hv or (1, 1), restart=rst, dac=dac)
            files[f"sof9_{k}.jpg"] = libjpeg_jpeg(writer, img, arith=True, **kw)
            files[f"sof10_{k}.jpg"] = libjpeg_jpeg(writer, img, arith=True,
                                                   progressive=True, **kw)
            files[f"huff_{k}.jpg"] = libjpeg_jpeg(writer, img, **kw)
        for name, (arith, scans) in PARTIAL_SCRIPTS.items():
            files[name] = libjpeg_jpeg(writer, arith_img, arith=arith,
                                       progressive=True, scans=scans)
        files["frame_sof9.jpg"] = libjpeg_jpeg(writer, frame, arith=True)
        files["frame_sof10.jpg"] = libjpeg_jpeg(writer, frame, arith=True,
                                                progressive=True)
        files["frame_smooth.jpg"] = libjpeg_jpeg(
            writer, frame, progressive=True, scans=FRAME_SMOOTH_SCANS)
    assert sorted(files) == FIXTURES
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(port_digests(out_dir, sorted(files)), f, indent=1,
                  sort_keys=True)
        f.write("\n")


def port_digests(out_dir, names):
    decode, shape, orientation, area = {}, {}, {}, {}
    for name in names:
        path = os.path.join(out_dir, name)
        img = image_io.read_image(path)
        decode[name], shape[name] = digest(img), list(img.shape)
        if name.endswith(".jpg"):
            with open(path, "rb") as f:
                orientation[name] = image_io.jpeg_orientation(f.read())
        if name in FRAMES:
            area[name] = digest(image_io.read_color(path, DEPTH_HW))
    return {"read_image": decode, "shape": shape, "twins": TWINS,
            "jpeg_orientation": orientation,
            f"read_color_{DEPTH_HW[0]}x{DEPTH_HW[1]}": area}


FIXTURES = sorted(set(TWINS) | set(TWINS.values()) | set(LIBJPEG_FILES) |
                  {"cmyk.jpg", "ycck.jpg", "exif_o6.png", "frame_o6.jpg",
                   "frame_cmyk.jpg"} |
                  {f"exif_o{o}.jpg" for o in range(2, 9)})


def test_fixture_set_is_small():
    assert sorted(os.listdir(FIXTURE_DIR)) == sorted(FIXTURES +
                                                     ["digests.json"])
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
               for n in os.listdir(FIXTURE_DIR)) <= 256 * 1024


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixture(name):
    with open(os.path.join(FIXTURE_DIR, "digests.json")) as f:
        want = json.load(f)
    assert port_digests(FIXTURE_DIR, [name]) == {
        "read_image": {name: want["read_image"][name]},
        "shape": {name: want["shape"][name]},
        "twins": want["twins"],
        "jpeg_orientation": ({name: want["jpeg_orientation"][name]}
                             if name.endswith(".jpg") else {}),
        "read_color_480x640": ({name: want["read_color_480x640"][name]}
                               if name in FRAMES else {})}
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_image(path)
    if name.endswith(".png"):
        np.testing.assert_array_equal(got, cv2_rgb(path))
    else:
        within_jpeg_tol(name, got, cv2_rgb(path))
    if name in TWINS:
        np.testing.assert_array_equal(
            got, image_io.read_image(os.path.join(FIXTURE_DIR, TWINS[name])))
    if name in FRAMES:
        assert got.shape == FRAME_HW + (3,)
        want_area = cv2.resize(cv2_rgb(path), DEPTH_HW[::-1],
                               interpolation=cv2.INTER_AREA)
        within_jpeg_tol(f"{name} on the depth", image_io.read_color(
            path, DEPTH_HW), want_area)


# ---------------------------------------------------------------------------
# through the readers: the JAX package (cv2) against the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A canonical capture whose colour files are the 240x320 frames and a
    PNG stored 320x240 with EXIF orientation 6, over 480x640 depth."""
    root = tmp_path_factory.mktemp("modes") / "scene"
    for sub in ("image", "depth", "pose"):
        (root / sub).mkdir(parents=True)
    (root / "pose" / "dimensions.txt").write_text("2.0 2.0 2.0")
    ex = Image.Exif()
    ex[0x0112] = 6
    png = pil_bytes(np.ascontiguousarray(orient(scene(*FRAME_HW, seed=9),
                                                8)), "RGB", "PNG",
                    exif=ex)
    colours = [open(os.path.join(FIXTURE_DIR, n), "rb").read()
               for n in FRAMES] + [png]
    depth = np.full(DEPTH_HW, 1500, np.uint16)
    for i, data in enumerate(colours):
        (root / "image" / f"{i}.jpg").write_bytes(data)
        image_io.write_png(str(root / "depth" / f"{i}.png"), depth)
        np.savetxt(str(root / "pose" / f"T_wc_{i}.txt"),
                   np.eye(4).reshape(1, -1))
        np.savetxt(str(root / "pose" / f"intr_mat_{i}.txt"),
                   np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]
                            ).reshape(1, -1))
    return root


def test_canonical_reader_colour_jax_vs_port(capture):
    from bnv_fusion_tpu.config import load_config as jload_config
    from bnv_fusion_tpu.datasets import get_dataset as jget_dataset
    from bnv_fusion_tpu_torch.config import load_config as tload_config
    from bnv_fusion_tpu_torch.datasets import get_dataset as tget_dataset

    over = ["dataset=fusion_inference_dataset",
            f"data_dir={capture.parent}", "dataset.scan_id=scene",
            "dataset.load_color=true"]
    t = tget_dataset(tload_config(over), "val")
    j = jget_dataset(jload_config(over), "val")
    assert len(t) == len(j) == len(FRAMES) + 1
    for i in range(len(FRAMES) + 1):
        a, b = t[i]["rgb"], j[i]["rgb"]
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape == DEPTH_HW + (3,)
        if i == len(FRAMES):                # the PNG: exact
            np.testing.assert_array_equal(a, b)
        else:
            within_jpeg_tol(f"reader frame {i}", a.astype(np.uint8),
                            b.astype(np.uint8))


def test_frame_rgb_jax_vs_port(capture):
    from bnv_fusion_tpu.pipeline import NeuralMap as JaxMap
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    for i in range(len(FRAMES) + 1):
        frame = {"img_path": str(capture / "image" / f"{i}.jpg"),
                 "depth": np.zeros(DEPTH_HW, np.float32)}
        a, b = NeuralMap._frame_rgb(frame), JaxMap._frame_rgb(None, frame)
        assert a.dtype == np.uint8 and b.dtype == np.float32
        assert a.shape == b.shape == DEPTH_HW + (3,)
        if i == len(FRAMES):
            np.testing.assert_array_equal(a, b)
        else:
            within_jpeg_tol(f"_frame_rgb {i}", a, b.astype(np.uint8))


if __name__ == "__main__":
    make_fixtures()
