"""Image files on the host (numpy): a small OpenEXR scanline reader and
writer, the reader of every other image format through PIL, and a PNG
writer (the port's copy of ``nmf_tpu/data/exr.py``, plus ``write_png``).

EXR, from the OpenEXR 2.0 spec, the slice of the format that the ``gt_bg``
panoramas, HDR frames and envmap dumps need:

- single-part scanline images with UINT, HALF or FLOAT channels;
- NONE, ZIPS (one line a chunk) and ZIP (16 lines) compression: zlib and
  the EXR byte-reorder / delta predictor (ImfZip.cpp semantics);
- writes FLOAT (or HALF) channels, ZIPS by default.

Any other compression (RLE, PIZ, PXR24, B44, DWA), and a tiled,
multi-part or deep file, goes to the native OpenEXR bridge
(``exr_native.py``, the port's copy of ``nmf_tpu/native/exrio.cpp``), as
nmf_tpu's reader routes it; where the bridge cannot be built or cannot
read the file, ``read_exr`` raises ``ValueError`` naming the compression
or the layout.

Other formats are read with PIL, to the arrays that nmf_tpu's imageio read
gives: 8-bit L / RGB / RGBA as uint8 / 255, 16-bit grey as uint16 / 65535.
A mode that PIL would narrow (16-bit RGB(A) or grey-alpha PNGs) or that
imageio would hand over in another layout (palette, 1-bit, LA, CMYK)
raises ``ValueError`` instead of being read differently.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_PIX_DTYPES = {_PIX_UINT: np.dtype("<u4"), _PIX_HALF: np.dtype("<f2"),
               _PIX_FLOAT: np.dtype("<f4")}
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3
_COMP_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
               5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}
_LINES_PER_CHUNK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}
# version-field flags of the layouts this reader does not decode
_TILED, _DEEP, _MULTIPART = 0x200, 0x800, 0x1000


def _predictor_encode(raw: bytes) -> bytes:
    """EXR zip pre-filter: de-interleave into two halves, then byte delta."""
    b = np.frombuffer(raw, np.uint8)
    half = (len(b) + 1) // 2
    reordered = np.empty_like(b)
    reordered[:half] = b[0::2]
    reordered[half:] = b[1::2]
    s = reordered.astype(np.int16)
    d = s.copy()
    d[1:] = (s[1:] - s[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _predictor_decode(data: bytes) -> bytes:
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    d[1:] -= 128
    s = np.mod(np.cumsum(d), 256).astype(np.uint8)
    half = (len(s) + 1) // 2
    out = np.empty_like(s)
    out[0::2] = s[:half]
    out[1::2] = s[half:]
    return out.tobytes()


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def write_exr(path, img, compression: str = "zips", pixel_type: str = "float"):
    """img: (H, W) or (H, W, C) float array, C in {1, 3, 4}. Channels are
    written as Y / BGR / ABGR (alphabetical, per spec), as ``pixel_type``
    ``float`` (32 bits) or ``half`` (16 bits, rounded to nearest);
    ``compression`` is ``zips``, ``zip`` or ``none``."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[C]
    # channel name -> source plane (RGB order in the input array)
    src = {1: {"Y": 0}, 3: {"R": 0, "G": 1, "B": 2},
           4: {"R": 0, "G": 1, "B": 2, "A": 3}}[C]
    comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}[
        compression]
    pix = {"float": _PIX_FLOAT, "half": _PIX_HALF}[pixel_type]
    lpc = _LINES_PER_CHUNK[comp]

    chl = b""
    for n in names:
        chl += (n.encode() + b"\0" + struct.pack("<i", pix)
                + struct.pack("<i", 0) + struct.pack("<ii", 1, 1))
    chl += b"\0"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = (
        _attr("channels", "chlist", chl)
        + _attr("compression", "compression", bytes([comp]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\0")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0")

    planes = img.astype(_PIX_DTYPES[pix])
    n_chunks = (H + lpc - 1) // lpc
    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lpc
        raw = b"".join(planes[y, :, src[n]].tobytes()
                       for y in range(y0, min(y0 + lpc, H)) for n in names)
        if comp == _COMP_NONE:
            data = raw
        else:
            packed = zlib.compress(_predictor_encode(raw))
            data = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0, len(data)) + data)

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    offset = len(preamble) + 8 * n_chunks
    offsets = []
    for c in chunks:
        offsets.append(offset)
        offset += len(c)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(preamble)
        for o in offsets:
            f.write(struct.pack("<Q", o))
        for c in chunks:
            f.write(c)


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c in (b"\0", b""):
                break
            name += c
        if not name:
            return attrs
        typ = b""
        while True:
            c = f.read(1)
            if c == b"\0":
                break
            typ += c
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))


def _parse_channels(data: bytes):
    chans, i = [], 0
    while data[i] != 0:
        j = data.index(0, i)
        name = data[i:j].decode()
        pix = struct.unpack("<i", data[j + 1:j + 5])[0]
        chans.append((name, pix))
        i = j + 1 + 16
    return chans  # already alphabetical in well-formed files


class UnsupportedExr(ValueError):
    """A file the numpy reader does not decode (its compression or
    layout)."""


def read_exr(path):
    """Returns (H, W, C) float32. 3/4-channel files come back RGB(A); other
    channel sets in the file's (alphabetical) order. A file the numpy
    reader does not decode comes from the native bridge as (H, W, 4) RGBA,
    as nmf_tpu's; without the bridge it raises ``UnsupportedExr``."""
    try:
        return _read_exr_numpy(path)
    except UnsupportedExr as e:
        from .exr_native import exr_read_native, unavailable_reason

        im = exr_read_native(path)
        if im is None:
            why = unavailable_reason()
            raise UnsupportedExr(
                f"{e}; the native OpenEXR bridge "
                + (f"is unavailable: {why}" if why else
                   "could not read it")) from None
        return im


def _read_exr_numpy(path):
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        for flag, what in ((_TILED, "tiled"), (_DEEP, "deep"),
                           (_MULTIPART, "multi-part")):
            if version & flag:
                raise UnsupportedExr(f"{path}: {what} EXR files are not "
                                     "supported by the numpy reader "
                                     "(single-part scanline only)")
        attrs = _read_attrs(f)
        chans = _parse_channels(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        if comp not in _LINES_PER_CHUNK:
            raise UnsupportedExr(
                f"{path}: {_COMP_NAMES.get(comp, comp)} compression is not "
                "supported by the numpy reader (only NONE, ZIPS and ZIP)")
        xm, ym, xM, yM = struct.unpack("<iiii", attrs["dataWindow"][1])
        W, H = xM - xm + 1, yM - ym + 1
        lpc = _LINES_PER_CHUNK[comp]
        n_chunks = (H + lpc - 1) // lpc
        f.read(8 * n_chunks)  # offset table (chunks follow in order)

        out = {n: np.empty((H, W), np.float32) for n, _ in chans}
        bytes_per_line = sum(_PIX_DTYPES[p].itemsize for _, p in chans) * W
        for _ in range(n_chunks):
            y, size = struct.unpack("<ii", f.read(8))
            y -= ym
            data = f.read(size)
            n_lines = min(lpc, H - y)
            if comp != _COMP_NONE and size != bytes_per_line * n_lines:
                data = _predictor_decode(zlib.decompress(data))
            pos = 0
            for dy in range(n_lines):
                for n, p in chans:
                    dt = _PIX_DTYPES[p]
                    out[n][y + dy] = np.frombuffer(data, dt, W, pos)
                    pos += dt.itemsize * W
    names = [n for n, _ in chans]
    if set(names) >= {"R", "G", "B"}:
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([out[n] for n in order], axis=-1)


# PNG colour types (IHDR) by name
_PNG_GREY, _PNG_RGB, _PNG_RGBA = 0, 2, 6


def _png_header(path):
    """(bit depth, colour type) of a PNG file, else None."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        return None
    return head[24], head[25]


def _read_pil(path):
    """An 8-bit L / RGB / RGBA or 16-bit grey image as imageio reads it:
    (H, W) or (H, W, C) uint8 / uint16. Raises for every other mode."""
    from PIL import Image

    png = _png_header(path)
    if png is not None and png[0] == 16 and png[1] != _PNG_GREY:
        raise ValueError(f"{path}: a 16-bit PNG of colour type {png[1]}: "
                         "PIL would narrow it to 8 bits")
    with Image.open(path) as im:
        if im.mode in ("L", "RGB", "RGBA", "I;16"):
            return np.asarray(im)
        raise ValueError(f"{path}: image mode {im.mode!r} is not supported "
                         "(8-bit L, RGB, RGBA or 16-bit grey)")


def imread_any(path):
    """Read .exr via this module, everything else via PIL (float32, 8- and
    16-bit images scaled to [0, 1])."""
    path = Path(path)
    if path.suffix.lower() == ".exr":
        return read_exr(path)
    img = _read_pil(path)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32) / 65535.0


def write_png(path, img):
    """Write an (H, W), (H, W, 3) or (H, W, 4) image as an 8-bit RGB or
    RGBA PNG (a grey image is stacked to RGB). Floats are read as [0, 1]
    and truncated to 8 bits, as nmf_tpu's image dumps do; uint8 is written
    as it is. zlib alone."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.dtype == np.uint8:
        u8 = arr
    else:
        u8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    H, W, C = u8.shape
    if C not in (3, 4):
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {C}")
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(H))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    colour = _PNG_RGB if C == 3 else _PNG_RGBA
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png)
