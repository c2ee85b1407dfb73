"""Image files without cv2: PNG and JPEG codecs and cv2's two resizes.

The JAX package reads and writes every image through cv2 (depth and
confidence PNGs in bnv_fusion_tpu/datasets/canonical.py:25-41 and
arkit.py:57-61, colour JPEGs and their ``INTER_AREA`` resize in
canonical.py:106-111 and pipeline.py:872-888, ``INTER_NEAREST``
downsampling in canonical.py:34-38, the converter's writers in
scripts/generate_fusion_data.py:52-76).  This module gives the port the
same results with numpy, zlib and ``native/image_ops.cpp`` (PNG row
filters, JPEG entropy coding, libjpeg's integer DCTs, chroma resampling and
colour tables, cv2's area resize), built at first use.

Colour arrays are RGB, not cv2's BGR: the JAX readers flip BGR at once
(canonical.py:107, pipeline.py:880).  Colour reads (``read_image``,
``read_color``, ``decode_jpeg``, ``decode_png(unchanged=False)``) apply the
file's EXIF orientation as ``cv2.IMREAD_COLOR`` does; the unchanged PNG read
(depth, confidence) ignores it, as ``cv2.imread(path, -1)`` does.

JPEG files are read as cv2 reads them: baseline, extended sequential and
progressive, Huffman or arithmetic coded (SOF0-2, SOF9-10), with 1, 3 or 4
components, progressive files whose scans stop early block-smoothed as
libjpeg-turbo does, and a scan whose data run out decoded as far as they
go.  The files cv2 returns None for raise ``ValueError`` naming
``UNSUPPORTED_JPEG_ITEM``: lossless and hierarchical coding, 12-bit
samples, 2 components, a DNL-defined height, and bytes cut off before
their EOI marker (``decode_jpeg``, as ``cv2.imdecode``; a file read from
a path is read as ``cv2.imread`` reads it, through a fake EOI).

    img = read_png(path)            # as cv2.imread(path, -1), RGB order
    rgb = read_image(path)          # as cv2.imread(path), RGB, uint8,
                                    # EXIF orientation applied
    write_png(path, depth_mm)       # 8-bit grey/RGB, 16-bit grey
    write_jpeg(path, rgb, 95)       # baseline 4:2:0, cv2.imwrite's default
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from bnv_fusion_tpu_torch.native import load_library

PNG_SIG = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
# ROADMAP item that lists the JPEG files the decoder refuses, as cv2 does
UNSUPPORTED_JPEG_ITEM = "ROADMAP Queue 1 item 16"
ORIENTATION_TAG = 0x0112
# libjpeg's fake EOIs past the end of a file: enough to fill the longest
# marker segment a file can be cut inside
_FAKE_EOIS = b"\xff\xd9" * 32768

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _lib() -> ctypes.CDLL:
    lib = load_library("image_ops")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.image_ops_error.restype = ctypes.c_char_p
    lib.image_ops_png_unfilter.restype = ctypes.c_int
    lib.image_ops_png_unfilter.argtypes = [u8p, u8p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int]
    lib.image_ops_jpeg_header.restype = ctypes.c_int
    lib.image_ops_jpeg_header.argtypes = [u8p, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_int32)]
    lib.image_ops_jpeg_decode.restype = ctypes.c_int
    lib.image_ops_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                          ctypes.c_int64, ctypes.c_int64]
    lib.image_ops_jpeg_encode.restype = ctypes.c_int64
    lib.image_ops_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
    lib.image_ops_fetch_encoded.argtypes = [u8p]
    resize_args = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p,
                   ctypes.c_int64, ctypes.c_int64]
    for fn in (lib.image_ops_resize_area, lib.image_ops_resize_linear_area):
        fn.restype = None
        fn.argtypes = resize_args
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# EXIF orientation (cv2: imgcodecs/src/exif.cpp, loadsave.cpp)
# ---------------------------------------------------------------------------

class _ExifEnd(Exception):
    """A read past the end of the EXIF block (cv2's ExifParsingError)."""


# IFD0 tags whose values cv2's ExifReader::parseExifEntry reads from an
# offset, and so can end the parse: the strings (getString, out of line when
# longer than 4 bytes) and the rationals with how many each reads
_EXIF_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
                   0x0214: 6}


def _orientation_entry(tiff: bytes):
    """The first Orientation entry's value in IFD0 of a TIFF-structured
    EXIF block, or None, as cv2's ExifReader::parseExif reads it: the byte
    order from ``II``/``MM`` (big-endian unless the first two bytes read
    ``II``), the entries in order until one reads past the end, the value's
    first 16 bits whatever its type."""
    n = len(tiff)
    little = n > 0 and tiff[0] == ord("I") and (n == 1 or tiff[1] == tiff[0])

    def u16(o: int) -> int:
        if o + 1 >= n:
            raise _ExifEnd
        return int.from_bytes(tiff[o:o + 2], "little" if little else "big")

    def u32(o: int) -> int:
        if o + 3 >= n:
            raise _ExifEnd
        return int.from_bytes(tiff[o:o + 4], "little" if little else "big")

    try:
        if u16(2) != 0x2A:
            return None
        off = u32(4)
        for i in range(u16(off)):
            e = off + 2 + 12 * i
            tag = u16(e)
            if tag == ORIENTATION_TAG:
                return u16(e + 8)
            if tag in _EXIF_STRINGS:
                cnt = u32(e + 4)
                if cnt > 4:
                    at = u32(e + 8)
                    if at > n or at + cnt > n:
                        return None
            elif tag in _EXIF_RATIONALS:
                at = u32(e + 8)
                for k in range(2 * _EXIF_RATIONALS[tag]):
                    u32(at + 4 * k)
    except _ExifEnd:
        pass
    return None


def exif_orientation(*blocks: bytes) -> int:
    """The EXIF orientation (1-8) of TIFF-structured blocks (a PNG eXIf
    chunk, a JPEG's APP1 segments after their "Exif\\0\\0"): the first
    Orientation entry among them, as cv2 keeps the first in one tag map.
    None, malformed or out of range means 1, the image as stored."""
    for block in blocks:
        v = _orientation_entry(block)
        if v is not None:
            return v if 1 <= v <= 8 else 1
    return 1


def jpeg_orientation(data: bytes) -> int:
    """The EXIF orientation of a JPEG, from its "Exif\\0\\0" APP1 segments
    before the first scan."""
    blocks, pos, n = [], 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:           # bytes between markers: skipped,
            pos += 1                    # as libjpeg's next_marker does
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xDA, 0xD9):
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if m == 0xE1 and body[:6] == b"Exif\0\0":
            blocks.append(body[6:])
        pos += 2 + length
    return exif_orientation(*blocks)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation (imgcodecs/src/loadsave.cpp): 2 flips
    left-right, 3 rotates 180 degrees, 4 flips top-bottom, 5 transposes,
    6 rotates 90 degrees clockwise, 7 transverses, 8 rotates 90 degrees
    counter-clockwise; 1 (or anything else) leaves the image as stored."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunks(data: bytes):
    if data[:8] != PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG (no IEND)")


def _unfilter(raw: memoryview, rows: int, rowbytes: int, bpp: int
              ) -> np.ndarray:
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((rows, rowbytes), np.uint8)
    lib = _lib()
    if lib.image_ops_png_unfilter(_ptr(np.ascontiguousarray(src)), _ptr(out),
                                  rows, rowbytes, bpp) != 0:
        raise ValueError(lib.image_ops_error().decode())
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered scanlines [h, rowbytes] -> samples [h, width, channels]."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
        bits = bits.reshape(h, width * channels, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(-1).astype(np.uint8)
    return s[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes, unchanged: bool = True) -> np.ndarray:
    """PNG bytes -> array, channels in RGB(A) order.

    ``unchanged=True`` is ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: grey
    [H, W] at 8 or 16 bits (1, 2 and 4 bits scale to 8), colour [H, W, 3]
    or, with an alpha channel, palette transparency or a truecolour
    ``tRNS`` colour key (alpha 0 on the key, full elsewhere), [H, W, 4].
    ``unchanged=False`` is ``cv2.imread(path)``: uint8 [H, W, 3], 16 bits
    reduced to their high byte, grey replicated, alpha dropped, the
    orientation of an ``eXIf`` chunk applied."""
    chunks = list(_png_chunks(data))
    img = _decode_png(chunks, unchanged)
    if unchanged:
        return img
    # libpng keeps the first eXIf chunk
    exif = [body for kind, body in chunks if kind == b"eXIf"][:1]
    return apply_orientation(img, exif_orientation(*exif))


def _decode_png(chunks, unchanged: bool) -> np.ndarray:
    ihdr, plte, trns, idat = None, None, None, []
    for kind, body in chunks:
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _PNG_CHANNELS or comp != 0 or filt != 0 or \
            interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"unsupported PNG header {ihdr}")
    ch = _PNG_CHANNELS[ctype]
    if depth not in ((1, 2, 4, 8, 16) if ctype == 0 else
                     (1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"bad PNG bit depth {depth} for colour type {ctype}")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    bpp = max(1, ch * depth // 8)
    img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        n = ph * (rowbytes + 1)
        if pos + n > len(raw):
            raise ValueError("truncated PNG image data")
        rows = _unfilter(raw[pos:pos + n], ph, rowbytes, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n

    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        if int(idx.max()) >= len(plte):
            raise ValueError("PNG palette index out of range")
        rgb = plte[idx]
        if trns is not None and len(trns) and unchanged:
            alpha = np.full(len(plte), 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)[:len(plte)]
            alpha[:len(t)] = t
            return np.concatenate([rgb, alpha[idx][..., None]], -1)
        return rgb
    if depth < 8 and ctype == 0:
        img = (img.astype(np.uint16) * (255 // ((1 << depth) - 1))
               ).astype(np.uint8)
    if ctype == 2 and unchanged and trns is not None and len(trns) == 6:
        # libpng's png_do_expand: the colour key becomes an alpha channel,
        # 0 where all three samples equal it, full elsewhere; at 8 bits
        # only the key's low bytes count (a tRNS of another length is
        # ignored, with a warning)
        key = np.array(struct.unpack(">HHH", trns))
        if depth == 8:
            key &= 0xFF
        alpha = np.where((img == key).all(-1), 0, np.iinfo(img.dtype).max)
        return np.concatenate([img, alpha[..., None].astype(img.dtype)], -1)
    if not unchanged:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        if ch in (1, 2):
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    if ch == 1:
        return img[..., 0]
    if ch == 2:  # grey + alpha -> grey, grey, grey, alpha
        return np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]],
                              -1)
    return img


def read_png(path: str, unchanged: bool = True) -> np.ndarray:
    """``cv2.imread(path, -1)`` (or ``cv2.imread(path)`` with
    ``unchanged=False``) for a PNG file, channels in RGB(A) order; only the
    colour read applies an EXIF orientation."""
    return decode_png(_read_bytes(path), unchanged)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 grey [H, W] / RGB [H, W, 3], or uint16 grey [H, W] -> PNG
    bytes (no row filter, zlib level 6)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2 and img.dtype == np.uint16:
        depth, ctype, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.ndim == 2 and img.dtype == np.uint8:
        depth, ctype, rows = 8, 0, img
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        depth, ctype, rows = 8, 2, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_png wants uint8 [H, W] or [H, W, 3], or "
                         f"uint16 [H, W]; got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIG +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       0)) +
            chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _jpeg_error(lib, code: int) -> ValueError:
    msg = lib.image_ops_error().decode()
    if code == -2:
        msg += f" ({UNSUPPORTED_JPEG_ITEM})"
    return ValueError(msg)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB, grey replicated, its EXIF
    orientation applied: ``cv2.imdecode(data, IMREAD_COLOR)`` with the
    channels reversed (``read_jpeg`` reads a file as ``cv2.imread`` does,
    which differs only for a file cut off before its EOI).  Reads baseline, extended sequential and progressive files,
    Huffman or arithmetic coded, with 1, 3 (YCbCr or RGB) or 4 (CMYK or
    YCCK) components, any integer chroma sampling and restart markers; a
    progressive file whose scans leave low-frequency bits unknown is
    block-smoothed as libjpeg-turbo smooths it.  Where cv2 returns None
    (lossless, hierarchical and 12-bit files, 2 components, a DNL-defined
    height, bytes cut off before their EOI) it raises ``ValueError`` naming
    ``UNSUPPORTED_JPEG_ITEM``."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int32 * 3)()
    rc = lib.image_ops_jpeg_header(_ptr(buf), len(buf), info)
    if rc != 0:
        raise _jpeg_error(lib, rc)
    w, h = int(info[0]), int(info[1])
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.image_ops_jpeg_decode(_ptr(buf), len(buf), _ptr(out), w, h)
    if rc != 0:
        raise _jpeg_error(lib, rc)
    return apply_orientation(out, jpeg_orientation(data))


def _read_jpeg_file(data: bytes) -> np.ndarray:
    """A JPEG file's bytes as ``cv2.imread`` decodes them: past the end of a
    file libjpeg's file source (jdatasrc.c fill_input_buffer) hands out a
    fake EOI marker on every read, so a file cut off before its EOI decodes
    as far as its data go, as a scan cut short decodes."""
    return decode_jpeg(data + _FAKE_EOIS)


def read_jpeg(path: str) -> np.ndarray:
    return _read_jpeg_file(_read_bytes(path))


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB [H, W, 3] (or grey [H, W], replicated) -> baseline JFIF,
    4:2:0, the Annex K tables at ``quality`` and the standard Huffman
    tables: what ``cv2.imwrite`` writes by default."""
    img = np.asarray(rgb)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg wants uint8 [H, W, 3]; got "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    lib = _lib()
    n = lib.image_ops_jpeg_encode(_ptr(img), img.shape[1], img.shape[0],
                                  int(quality))
    if n < 0:
        raise ValueError(lib.image_ops_error().decode())
    out = np.empty(n, np.uint8)
    lib.image_ops_fetch_encoded(_ptr(out))
    return out.tobytes()


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))


# ---------------------------------------------------------------------------
# any format
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """``cv2.imread(path)`` (IMREAD_COLOR) for a PNG or JPEG file, told
    apart by content: uint8 [H, W, 3] RGB, EXIF orientation applied.  A
    file of another kind raises ``ValueError``."""
    data = _read_bytes(path)
    if data[:8] == PNG_SIG:
        return decode_png(data, unchanged=False)
    if data[:2] == JPEG_SOI:
        return _read_jpeg_file(data)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def read_color(path: str, hw=None) -> np.ndarray:
    """A colour frame as uint8 RGB [H, W, 3], oriented by its EXIF tag,
    then area-resized to ``hw`` (height, width) where its size differs:
    what the JAX package's readers get from cv2.imread + cv2.resize(
    INTER_AREA), channels reversed."""
    img = read_image(path)
    if hw is not None and img.shape[:2] != tuple(hw):
        img = resize_area(img, (int(hw[1]), int(hw[0])))
    return img


# ---------------------------------------------------------------------------
# resizing (cv2.resize's rules)
# ---------------------------------------------------------------------------

def resize_nearest(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index floor(dx * src/dst) clamped to the last pixel, any dtype and
    channel count."""
    img = np.asarray(img)
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {dsize}")
    # cv2 computes the inverse scale as 1 / (dst / src) in double
    fx, fy = 1.0 / (w / sw), 1.0 / (h / sh)
    xs = np.minimum(np.floor(np.arange(w) * fx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * fy).astype(np.int64), sh - 1)
    return img[ys[:, None], xs[None, :]]


def resize_area(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` for uint8
    images.  Shrunk on both axes: integer ratios take cv2's fast path (the
    box mean: (sum + 2) >> 2 for 2x2, else the float mean rounded half to
    even), other ratios its per-axis overlap weights, accumulated in float32
    in cv2's order, then rounded and saturated.  Grown on either axis: cv2's
    linear resize with area coefficients in 11-bit fixed point (both in
    native/image_ops.cpp)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area wants uint8, got {img.dtype}")
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        return img.copy()
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_area to {w}x{h}")
    src = np.ascontiguousarray(img)
    cn = 1 if img.ndim == 2 else int(np.prod(img.shape[2:]))
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    if w > sw or h > sh:
        _lib().image_ops_resize_linear_area(_ptr(src), sh, sw, cn, _ptr(out),
                                            h, w)
        return out
    scale_x, scale_y = 1.0 / (w / sw), 1.0 / (h / sh)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    if abs(scale_x - ix) < np.finfo(np.float64).eps and \
            abs(scale_y - iy) < np.finfo(np.float64).eps:
        total = np.zeros((h, w) + img.shape[2:], np.int32)
        for dy in range(iy):
            for dx in range(ix):
                total += img[dy:h * iy:iy, dx:w * ix:ix]
        if ix == 2 and iy == 2 and img.ndim in (2, 3) and \
                (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
            return ((total + 2) >> 2).astype(np.uint8)
        mean = total.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    _lib().image_ops_resize_area(_ptr(src), sh, sw, cn, _ptr(out), h, w)
    return out
