"""Pure-python GeoTIFF codec: windowed reads, streamed writes, BigTIFF.

Replaces the reference's GDAL dependency for DEM tiles (SURVEY.md §2.1
Array2D row: GDAL *windowed* load feeds the tiled programs; §7 hard-part
7: "ship npy/ASCII IO and a minimal GeoTIFF codec").  Supports:

* reading: classic TIFF **and BigTIFF**, little/big endian, strip- or
  tile-organized, uncompressed (1), DEFLATE (8 / legacy 32946), LZW (5)
  or PackBits (32773), with horizontal (2) or floating-point (3)
  predictors, any standard integer/float width, multi-band chunky
  rasters (``band=`` selects one), GeoTIFF ModelPixelScale +
  ModelTiepoint → geotransform, GDAL_NODATA;
* **windowed reading** without loading the file: :class:`GeoTIFFWindow`
  parses only the IFD and decodes just the strips/tiles overlapping a
  requested window — this is what lets ``out_of_core_*`` stream a
  compressed GeoTIFF larger than RAM through the chip;
* writing: little-endian, single band, strip-organized, uncompressed,
  ``compress="deflate"`` or ``compress="lzw"``, optional horizontal (2)
  / floating-point (3) predictors, classic or BigTIFF
  (``bigtiff="auto"`` trips past the 4 GB classic offset cap), with
  geotransform + nodata + PROCESSING_HISTORY;
* **streamed writing**: :class:`GeoTIFFStripWriter` takes row bands as
  they are produced (the out-of-core drivers' tile rows), holding only
  one strip in RAM — the IFD is pre-sized and the strip offset/count
  arrays are patched at :meth:`~GeoTIFFStripWriter.close`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from richdem_tpu_torch.grid import rdarray, DEFAULT_GEOTRANSFORM

__all__ = ["load_geotiff", "save_geotiff", "GeoTIFFWindow",
           "GeoTIFFStripWriter"]

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_SAMPLE_FORMAT = 339
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735
_GEO_ASCII_PARAMS = 34737
_GDAL_NODATA = 42113

_TYPE_FMT = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
             8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}

_DEFLATE = (8, 32946)
_LZW = 5
_PACKBITS = 32773


def _lzw_decode(data):
    """TIFF-flavor LZW (MSB-first codes, early change)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    prev = None
    bitbuf = 0
    bitcnt = 0
    width = 9
    pos = 0
    n = len(data)
    while True:
        while bitcnt < width and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < width:
            break
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == 256:                      # clear
            table = table[:258]
            width = 9
            prev = None
            continue
        if code == 257:                      # EOI
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:                                # KwKwK case
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # early change (TIFF 6.0 §13 / libtiff): widen as soon as the
        # table holds 2^w - 1 entries — one code EARLIER than plain LZW,
        # because the writer (whose table is one entry ahead) switched
        # after assigning code 2^w - 1.  Verified against libtiff/PIL
        # streams: the 9→10 switch lands after decoded code #254.
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _lzw_encode(data):
    """TIFF-flavor LZW encoder (MSB-first codes, early change), the
    inverse of :func:`_lzw_decode` — TIFF 6.0 spec §13.  Pure python:
    fine for the ≤4 MB strips the writer emits, but DEFLATE is the
    faster choice for bulk output."""
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    width = 9

    def emit(code):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    emit(256)                                # leading clear
    omega = b""
    for byte in bytes(data):
        k = bytes([byte])
        if omega + k in table:
            omega += k
            continue
        emit(table[omega])
        table[omega + k] = next_code
        next_code += 1
        # early change: widen after ASSIGNING code 2^w - 1, so the
        # decoder (whose table lags one entry) widens in lockstep after
        # APPENDING entry 2^w - 2; clear at 4094 exactly like libtiff so
        # standard readers never see a table-overflow code
        if next_code == 4094:
            emit(256)                        # table full: clear + reset
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
            width = 9
        elif next_code == (1 << width) and width < 12:
            width += 1
        omega = k
    if omega:
        emit(table[omega])
    emit(257)                                # EOI
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _packbits_decode(data):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i:i + b + 1]
            i += b + 1
        elif b > 128:
            out += data[i:i + 1] * (257 - b)
            i += 1
    return bytes(out)


def _read_entries(f, endian, offset, big=False):
    """Parse one IFD (classic or BigTIFF) into {tag: python value}."""
    f.seek(offset)
    if big:
        (count,) = struct.unpack(endian + "Q", f.read(8))
        esz, inline, cnt_fmt, off_fmt = 20, 8, "Q", "Q"
    else:
        (count,) = struct.unpack(endian + "H", f.read(2))
        esz, inline, cnt_fmt, off_fmt = 12, 4, "I", "I"
    body = f.read(count * esz + (8 if big else 4))
    entries = {}
    deferred = []
    for i in range(count):
        tag, typ = struct.unpack_from(endian + "HH", body, i * esz)
        (n,) = struct.unpack_from(endian + cnt_fmt, body, i * esz + 4)
        if typ not in _TYPE_FMT:
            continue
        size = _TYPE_SIZE[typ] * n
        val_at = i * esz + 4 + struct.calcsize(cnt_fmt)
        if size <= inline:
            raw = body[val_at:val_at + size]
            entries[tag] = (typ, n, raw)
        else:
            (val_off,) = struct.unpack_from(endian + off_fmt, body, val_at)
            deferred.append((tag, typ, n, val_off, size))
    for tag, typ, n, val_off, size in deferred:
        f.seek(val_off)
        entries[tag] = (typ, n, f.read(size))
    (next_ifd,) = struct.unpack_from(endian + off_fmt, body, count * esz)

    out = {}
    for tag, (typ, n, raw) in entries.items():
        if typ == 2:  # ascii
            out[tag] = raw.split(b"\0")[0].decode("ascii", "replace")
        elif typ in (5, 10):  # rationals
            vals = struct.unpack(endian + "II" * n, raw)
            out[tag] = [vals[2 * i] / max(vals[2 * i + 1], 1)
                        for i in range(n)]
        else:
            out[tag] = list(struct.unpack(endian + _TYPE_FMT[typ] * n,
                                          raw))
    return out, next_ifd


def _undo_predictor(block, predictor, dtype, spp):
    """Reverse TIFF predictors on a decoded (rows, cols·spp) block."""
    if predictor == 2:          # horizontal differencing
        if spp > 1:
            h, wc = block.shape
            block = block.reshape(h, wc // spp, spp)
            np.cumsum(block, axis=1, dtype=block.dtype, out=block)
            return block.reshape(h, wc)
        np.cumsum(block, axis=1, dtype=block.dtype, out=block)
        return block
    if predictor == 3:          # floating-point (byte-plane + diff)
        h, wc = block.shape
        nb = dtype.itemsize
        raw = block.view(np.uint8).reshape(h, wc * nb)
        np.cumsum(raw, axis=1, dtype=np.uint8, out=raw)
        # bytes are stored plane-major, big-endian within the pixel
        planes = raw.reshape(h, nb, wc)
        shuffled = np.moveaxis(planes, 1, 2).copy()  # (h, wc, nb)
        be = np.dtype(dtype.str.replace("<", ">").replace("=", ">"))
        return (shuffled.reshape(h, wc * nb).view(be)
                .astype(dtype).reshape(h, wc))
    return block


def _apply_predictor(strip, predictor):
    """Forward TIFF predictor on a single-band (rows, cols) strip —
    the exact inverse of :func:`_undo_predictor` at spp=1.  Returns the
    raw bytes to compress."""
    if predictor == 2:          # horizontal differencing (integers)
        d = strip.copy()
        d[:, 1:] -= strip[:, :-1]            # wraps mod 2^bits
        return d.tobytes()
    if predictor == 3:          # floating-point (byte-plane + diff)
        h, wc = strip.shape
        nb = strip.dtype.itemsize
        be = np.dtype(strip.dtype.str.replace("<", ">")
                      .replace("=", ">"))
        pix = strip.astype(be).view(np.uint8).reshape(h, wc, nb)
        raw = np.moveaxis(pix, 2, 1).reshape(h, wc * nb).copy()
        raw[:, 1:] -= raw[:, :-1].copy()     # uint8 wraparound diff
        return raw.tobytes()
    return strip.tobytes()


class GeoTIFFWindow:
    """Windowed GeoTIFF reader: parses only the IFD, decodes only the
    strips/tiles overlapping a requested window — O(window) memory.

    Usable anywhere a memmap goes: ``shape``/``dtype`` attributes and
    2-D slicing (``r[r0:r1, c0:c1]`` → numpy array)."""

    def __init__(self, path, band=0):
        self._f = open(path, "rb")
        head = self._f.read(8)
        if head[:2] == b"II":
            self._e = "<"
        elif head[:2] == b"MM":
            self._e = ">"
        else:
            raise ValueError("not a TIFF file")
        (magic,) = struct.unpack(self._e + "H", head[2:4])
        if magic == 42:
            (ifd_off,) = struct.unpack(self._e + "I", head[4:8])
            big = False
        elif magic == 43:  # BigTIFF
            offsize, _zero = struct.unpack(self._e + "HH", head[4:8])
            if offsize != 8:
                raise ValueError(f"BigTIFF offset size {offsize}")
            (ifd_off,) = struct.unpack(self._e + "Q", self._f.read(8))
            big = True
        else:
            raise ValueError(f"unsupported TIFF magic {magic}")
        tags, _ = _read_entries(self._f, self._e, ifd_off, big=big)
        self._tags = tags
        self.bigtiff = big

        self.width = tags[_IMAGE_WIDTH][0]
        self.height = tags[_IMAGE_LENGTH][0]
        self.shape = (self.height, self.width)
        self._comp = tags.get(_COMPRESSION, [1])[0]
        if self._comp not in (1, _LZW, _PACKBITS) + _DEFLATE:
            raise ValueError(
                f"unsupported TIFF compression {self._comp}; this codec "
                "reads uncompressed, DEFLATE, LZW or PackBits GeoTIFFs")
        self._pred = tags.get(_PREDICTOR, [1])[0]
        self._spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
        if self._spp > 1 and tags.get(_PLANAR_CONFIG, [1])[0] != 1:
            raise ValueError("planar multi-band TIFFs not supported")
        if not 0 <= band < self._spp:
            raise ValueError(f"band {band} out of range ({self._spp})")
        self.band = band
        self.n_bands = self._spp
        bits = tags.get(_BITS_PER_SAMPLE, [8])[0]
        fmt = tags.get(_SAMPLE_FORMAT, [1])[0]
        kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
        if kind is None:
            raise ValueError(f"unsupported SampleFormat {fmt}")
        self.dtype = np.dtype(f"{kind}{bits // 8}")
        self._file_dtype = np.dtype(f"{self._e}{kind}{bits // 8}")

        if _TILE_OFFSETS in tags:
            self._tiled = True
            self._tw = tags[_TILE_WIDTH][0]
            self._th = tags[_TILE_LENGTH][0]
            self._offsets = tags[_TILE_OFFSETS]
            self._counts = tags.get(_TILE_BYTE_COUNTS)
        else:
            self._tiled = False
            self._rps = tags.get(_ROWS_PER_STRIP, [self.height])[0]
            self._offsets = tags[_STRIP_OFFSETS]
            self._counts = tags[_STRIP_BYTE_COUNTS]

        self.geotransform = DEFAULT_GEOTRANSFORM
        if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
            sx, sy = tags[_MODEL_PIXEL_SCALE][:2]
            tp = tags[_MODEL_TIEPOINT]
            i, j = tp[0], tp[1]
            x, y = tp[3], tp[4]
            self.geotransform = (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
        self.no_data = None
        if _GDAL_NODATA in tags:
            try:
                self.no_data = float(tags[_GDAL_NODATA].strip())
            except (ValueError, AttributeError):
                pass
        self.projection = tags.get(_GEO_ASCII_PARAMS, "")
        self.metadata = {}
        if _IMAGE_DESCRIPTION in tags:
            self.metadata["PROCESSING_HISTORY"] = tags[_IMAGE_DESCRIPTION]

    # -- block decode -----------------------------------------------------

    def _decode(self, idx, rows, cols):
        """Decode block ``idx`` → (rows, cols) array of self.dtype
        (band-selected)."""
        self._f.seek(self._offsets[idx])
        raw = self._f.read(self._counts[idx] if self._counts
                           else rows * cols * self._spp
                           * self.dtype.itemsize)
        if self._comp in _DEFLATE:
            raw = zlib.decompress(raw)
        elif self._comp == _LZW:
            raw = _lzw_decode(raw)
        elif self._comp == _PACKBITS:
            raw = _packbits_decode(raw)
        n = rows * cols * self._spp
        flat = np.frombuffer(raw, dtype=self._file_dtype, count=n)
        if self._pred == 3:
            # predictor 3 differences the RAW byte stream (plane-major,
            # MSB-first regardless of the file's byte order) — undo it
            # on file-order bytes BEFORE element conversion; an MM file
            # on an LE host would otherwise byteswap the differenced
            # planes first and decode to garbage
            block = _undo_predictor(
                flat.reshape(rows, cols * self._spp).copy(), 3,
                self.dtype, self._spp)
        else:
            block = flat.reshape(rows, cols * self._spp).astype(
                self.dtype.newbyteorder("="), copy=True)
            if self._pred == 2:
                block = _undo_predictor(block, 2, self.dtype,
                                        self._spp)
        if self._spp > 1:
            block = block.reshape(rows, cols, self._spp)[:, :, self.band]
        return block

    def read(self, r0, r1, c0, c1):
        """Window [r0:r1, c0:c1] as a numpy array (native byte order)."""
        r0, r1 = max(0, r0), min(self.height, r1)
        c0, c1 = max(0, c0), min(self.width, c1)
        out = np.empty((r1 - r0, c1 - c0), self.dtype)
        if self._tiled:
            ta = (self.width + self._tw - 1) // self._tw
            ty0, ty1 = r0 // self._th, (r1 - 1) // self._th
            tx0, tx1 = c0 // self._tw, (c1 - 1) // self._tw
            for ty in range(ty0, ty1 + 1):
                for tx in range(tx0, tx1 + 1):
                    blk = self._decode(ty * ta + tx, self._th, self._tw)
                    y0, x0 = ty * self._th, tx * self._tw
                    ry0, ry1 = max(r0, y0), min(r1, y0 + self._th)
                    cx0, cx1 = max(c0, x0), min(c1, x0 + self._tw)
                    out[ry0 - r0:ry1 - r0, cx0 - c0:cx1 - c0] = \
                        blk[ry0 - y0:ry1 - y0, cx0 - x0:cx1 - x0]
        else:
            s0, s1 = r0 // self._rps, (r1 - 1) // self._rps
            for s in range(s0, s1 + 1):
                y0 = s * self._rps
                rows = min(self._rps, self.height - y0)
                blk = self._decode(s, rows, self.width)
                ry0, ry1 = max(r0, y0), min(r1, y0 + rows)
                out[ry0 - r0:ry1 - r0, :] = blk[ry0 - y0:ry1 - y0, c0:c1]
        return out

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key, slice(None))
        rs, cs = key
        if isinstance(rs, int):
            rs = slice(rs, rs + 1)
        if isinstance(cs, int):
            cs = slice(cs, cs + 1)
        r0, r1, _ = rs.indices(self.height)
        c0, c1, _ = cs.indices(self.width)
        return self.read(r0, r1, c0, c1)

    def __array__(self, dtype=None):
        a = self.read(0, self.height, 0, self.width)
        return a if dtype is None else a.astype(dtype)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_geotiff(path, band=0) -> rdarray:
    r = GeoTIFFWindow(path, band=band)
    try:
        arr = r.read(0, r.height, 0, r.width)
        return rdarray(arr, no_data=r.no_data,
                       geotransform=r.geotransform,
                       projection=r.projection, metadata=dict(r.metadata))
    finally:
        r.close()


def _np_sample_format(dtype):
    return {"u": 1, "i": 2, "f": 3}[dtype.kind]


class GeoTIFFStripWriter:
    """Streamed single-band GeoTIFF writer: append row bands as they are
    produced, O(strip) memory, classic or BigTIFF.

    The header + IFD are written up front with PRE-SIZED strip
    offset/count arrays (their lengths are known from the shape even
    though compressed sizes are not); strip data is appended behind
    them, and :meth:`close` seeks back to patch the two arrays — the
    streamed analog of the reference's ``saveGDAL`` (SURVEY.md §2.1
    Array2D save row; VERDICT r2 missing #3).

    ``bigtiff``: True, False, or ``"auto"`` = BigTIFF when the
    *uncompressed* payload could cross the classic 4 GB offset cap.
    """

    def __init__(self, path, shape, dtype, compress=None,
                 rows_per_strip=None, geotransform=None, no_data=None,
                 projection="", description="richdem_tpu",
                 bigtiff="auto", predictor=None):
        if compress not in (None, "deflate", "lzw"):
            raise ValueError(f"unsupported compression {compress!r}")
        self.height, self.width = int(shape[0]), int(shape[1])
        self.dtype = np.dtype(dtype).newbyteorder("<")
        if self.dtype.kind not in "uif":
            raise ValueError(f"cannot write dtype {dtype} to GeoTIFF")
        if predictor not in (None, 2, 3):
            raise ValueError(f"unsupported predictor {predictor!r}")
        if predictor and not compress:
            raise ValueError("predictor requires compression")
        if predictor == 2 and self.dtype.kind == "f":
            raise ValueError("predictor 2 is for integer samples; use 3")
        if predictor == 3 and self.dtype.kind != "f":
            raise ValueError("predictor 3 is for float samples; use 2")
        self._compress = compress
        self._predictor = predictor
        if rows_per_strip is None:
            rows_per_strip = max(1, min(
                self.height,
                (4 << 20) // max(self.width * self.dtype.itemsize, 1)))
        self._rps = int(rows_per_strip)
        self._nstrips = -(-self.height // self._rps)
        raw_bytes = self.height * self.width * self.dtype.itemsize
        if bigtiff == "auto":
            bigtiff = raw_bytes > (1 << 32) - (1 << 25)
        self.bigtiff = bool(bigtiff)
        gt = geotransform or DEFAULT_GEOTRANSFORM

        big = self.bigtiff
        off_typ, off_fmt = (16, "Q") if big else (4, "I")
        entries = []  # (tag, type, count, payload bytes)

        def tag_short(tag, val):
            entries.append((tag, 3, 1, struct.pack("<H", val)))

        def tag_long(tag, val):
            entries.append((tag, 4, 1, struct.pack("<I", val)))

        def tag_doubles(tag, vals):
            entries.append((tag, 12, len(vals),
                            struct.pack("<" + "d" * len(vals), *vals)))

        def tag_ascii(tag, s):
            entries.append((tag, 2, len(s), bytes(s)))

        tag_long(_IMAGE_WIDTH, self.width)
        tag_long(_IMAGE_LENGTH, self.height)
        tag_short(_BITS_PER_SAMPLE, self.dtype.itemsize * 8)
        tag_short(_COMPRESSION,
                  {None: 1, "deflate": 8, "lzw": _LZW}[compress])
        tag_short(_PHOTOMETRIC, 1)  # BlackIsZero
        if predictor:
            tag_short(_PREDICTOR, predictor)
        tag_ascii(_IMAGE_DESCRIPTION,
                  (description or "richdem_tpu").encode("ascii",
                                                        "replace") + b"\0")
        entries.append((_STRIP_OFFSETS, off_typ, self._nstrips,
                        b"\0" * (struct.calcsize(off_fmt)
                                 * self._nstrips)))
        tag_short(_SAMPLES_PER_PIXEL, 1)
        tag_long(_ROWS_PER_STRIP, self._rps)
        entries.append((_STRIP_BYTE_COUNTS, off_typ, self._nstrips,
                        b"\0" * (struct.calcsize(off_fmt)
                                 * self._nstrips)))
        tag_short(_PLANAR_CONFIG, 1)
        tag_short(_SAMPLE_FORMAT, _np_sample_format(self.dtype))
        tag_doubles(_MODEL_PIXEL_SCALE, [abs(gt[1]), abs(gt[5]), 0.0])
        tag_doubles(_MODEL_TIEPOINT, [0.0, 0.0, 0.0, gt[0], gt[3], 0.0])
        # Minimal GeoKey directory: version only (projection strings are
        # kept in GeoAsciiParams verbatim).
        entries.append((_GEO_KEY_DIRECTORY, 3, 4,
                        struct.pack("<4H", 1, 1, 0, 0)))
        if projection:
            tag_ascii(_GEO_ASCII_PARAMS,
                      projection.encode("ascii", "replace") + b"\0")
        if no_data is not None:
            tag_ascii(_GDAL_NODATA, f"{float(no_data):g}".encode() + b"\0")
        entries.sort(key=lambda e: e[0])

        n = len(entries)
        inline = 8 if big else 4
        esz = 20 if big else 12
        head_len = 16 if big else 8
        ifd_size = ((8 if big else 2) + n * esz + (8 if big else 4))
        extra_off = head_len + ifd_size
        extra = bytearray()
        packed = []
        self._patch_pos = {}  # tag -> absolute file offset of its array
        for tag, typ, count, payload in entries:
            if big:
                head = struct.pack("<HHQ", tag, typ, count)
            else:
                head = struct.pack("<HHI", tag, typ, count)
            if len(payload) <= inline:
                if tag in (_STRIP_OFFSETS, _STRIP_BYTE_COUNTS):
                    # inline arrays live inside the IFD entry itself
                    self._patch_pos[tag] = (head_len + (8 if big else 2)
                                            + len(packed) * esz
                                            + len(head))
                packed.append(head + payload
                              + b"\0" * (inline - len(payload)))
            else:
                pos = extra_off + len(extra)
                if tag in (_STRIP_OFFSETS, _STRIP_BYTE_COUNTS):
                    self._patch_pos[tag] = pos
                packed.append(head + struct.pack("<" + off_fmt, pos))
                extra += payload
                if len(extra) % 2:
                    extra += b"\0"

        self._f = open(path, "wb")
        if big:
            self._f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0,
                                              head_len))
            self._f.write(struct.pack("<Q", n))
        else:
            self._f.write(b"II" + struct.pack("<HI", 42, head_len))
            self._f.write(struct.pack("<H", n))
        self._f.writelines(packed)
        self._f.write(struct.pack("<" + off_fmt, 0))  # no next IFD
        self._f.write(bytes(extra))
        self._off_fmt = off_fmt
        self._offsets = []
        self._counts = []
        self._buf = []            # pending bands, concatenated per strip
        self._buf_rows = 0
        self._rows_written = 0
        self.path = path

    def write_rows(self, rows):
        """Append a band of rows (any height; buffered to strips)."""
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != self.width:
            raise ValueError(f"band shape {rows.shape} != (*, "
                             f"{self.width})")
        rows = rows.astype(self.dtype, copy=False)
        # buffer bands in a list so row-at-a-time streaming costs
        # O(rows appended), not a full-strip copy per call; one
        # concatenate per emitted strip
        self._buf.append(rows)
        self._buf_rows += rows.shape[0]
        while self._buf_rows >= self._rps:
            pending = (self._buf[0] if len(self._buf) == 1
                       else np.concatenate(self._buf))
            self._emit(pending[:self._rps])
            rest = pending[self._rps:]
            self._buf = [rest] if rest.shape[0] else []
            self._buf_rows = rest.shape[0]

    def _emit(self, strip):
        strip = np.ascontiguousarray(strip)
        raw = (_apply_predictor(strip, self._predictor)
               if self._predictor else strip.tobytes())
        if self._compress == "deflate":
            raw = zlib.compress(raw, 6)
        elif self._compress == "lzw":
            raw = _lzw_encode(raw)
        self._offsets.append(self._f.tell())
        self._counts.append(len(raw))
        self._f.write(raw)
        self._rows_written += strip.shape[0]

    def close(self):
        if self._buf_rows:
            self._emit(self._buf[0] if len(self._buf) == 1
                       else np.concatenate(self._buf))
            self._buf = []
            self._buf_rows = 0
        if self._rows_written != self.height:
            raise ValueError(
                f"GeoTIFFStripWriter closed after {self._rows_written} of "
                f"{self.height} rows")
        assert len(self._offsets) == self._nstrips
        for tag, vals in ((_STRIP_OFFSETS, self._offsets),
                          (_STRIP_BYTE_COUNTS, self._counts)):
            self._f.seek(self._patch_pos[tag])
            self._f.write(struct.pack(
                "<" + self._off_fmt * len(vals), *vals))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def save_geotiff(path, rd, compress=None, rows_per_strip=None,
                 bigtiff="auto", predictor=None):
    """Write a single-band GeoTIFF; ``compress`` is ``"deflate"``
    (Compression=8, zlib — the fast bulk choice) or ``"lzw"``
    (Compression=5); ``predictor`` 2 (integer horizontal diff) or 3
    (float byte-plane diff) shrinks smooth DEM rasters substantially;
    BigTIFF automatic past the classic 4 GB cap (rides
    :class:`GeoTIFFStripWriter`)."""
    if not isinstance(rd, rdarray):
        rd = rdarray(rd)
    arr = rd.np()
    if rows_per_strip is None and compress is None:
        rows_per_strip = arr.shape[0]
    w = GeoTIFFStripWriter(
        path, arr.shape, arr.dtype, compress=compress,
        rows_per_strip=rows_per_strip, geotransform=rd.geotransform,
        no_data=rd.no_data, projection=rd.projection or "",
        description=(rd.metadata.get("PROCESSING_HISTORY", "")
                     or "richdem_tpu"), bigtiff=bigtiff,
        predictor=predictor)
    step = max(1, w._rps)
    for y0 in range(0, arr.shape[0], step):
        w.write_rows(arr[y0:y0 + step])
    w.close()
    return path
