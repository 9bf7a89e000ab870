"""Minimal, dependency-free TIFF codec with streaming multipage read/write
(the port's own copy of the JAX package's ``data/tiff.py``, without its
native C++ fast path).

The reference uses ``tifffile`` for all image I/O (e.g. bio_image_unet/unet/data.py,
unet/predict.py:64, siam_unet/predict.py:79-123).  This module provides the same
capabilities the reference actually exercises, implemented directly on the TIFF 6.0
container format:

- grayscale / multi-sample (HWC) pages,
- uint8/16/32, int8/16/32, float16/32/64 sample formats (the reference writes
  float16 results via ``save_as_tif``, utils/utils.py:8-22),
- multipage stacks,
- **BigTIFF** (64-bit offsets, magic 43) read AND write — ``imwrite``
  auto-promotes when the payload approaches the classic 4 GiB limit,
  matching tifffile's transparent handling of large microscopy movies
  (validated with a real >4 GiB round trip),
- raw or zlib/deflate compressed strips,
- **streaming** page-at-a-time reading (``TiffReader``) and appending
  (``TiffWriter``) with bounded memory, matching the reference's streaming movie
  predictor (siam_unet/predict.py:102-123: ``TiffFile`` page iteration +
  ``TiffWriter(..., contiguous=True)``).

For exotic files (LZW, tiled, predictors) :func:`imread` falls back to
imageio/PIL when available.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional, Tuple, Union

import numpy as np

# --- TIFF tag ids -----------------------------------------------------------
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_SAMPLE_FORMAT = 339

TYPE_SHORT = 3  # uint16
TYPE_LONG = 4  # uint32
TYPE_LONG8 = 16  # uint64 (BigTIFF)

COMPRESSION_NONE = 1
COMPRESSION_DEFLATE_OLD = 32946
COMPRESSION_DEFLATE = 8

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_IEEEFP = 3

_DTYPE_TO_FORMAT = {
    np.dtype(np.uint8): (8, SAMPLEFORMAT_UINT),
    np.dtype(np.uint16): (16, SAMPLEFORMAT_UINT),
    np.dtype(np.uint32): (32, SAMPLEFORMAT_UINT),
    np.dtype(np.int8): (8, SAMPLEFORMAT_INT),
    np.dtype(np.int16): (16, SAMPLEFORMAT_INT),
    np.dtype(np.int32): (32, SAMPLEFORMAT_INT),
    np.dtype(np.float16): (16, SAMPLEFORMAT_IEEEFP),
    np.dtype(np.float32): (32, SAMPLEFORMAT_IEEEFP),
    np.dtype(np.float64): (64, SAMPLEFORMAT_IEEEFP),
}

_FORMAT_TO_DTYPE = {
    (8, SAMPLEFORMAT_UINT): np.uint8,
    (16, SAMPLEFORMAT_UINT): np.uint16,
    (32, SAMPLEFORMAT_UINT): np.uint32,
    (8, SAMPLEFORMAT_INT): np.int8,
    (16, SAMPLEFORMAT_INT): np.int16,
    (32, SAMPLEFORMAT_INT): np.int32,
    (16, SAMPLEFORMAT_IEEEFP): np.float16,
    (32, SAMPLEFORMAT_IEEEFP): np.float32,
    (64, SAMPLEFORMAT_IEEEFP): np.float64,
}


class TiffFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class TiffWriter:
    """Streaming multipage TIFF writer (little-endian, one strip per page).

    Pages are appended one at a time with bounded memory: each ``write`` call
    emits the page's pixel data and IFD and back-patches the previous IFD's
    next-pointer — the file is valid after every call.  This reproduces the
    reference's streaming movie output (siam_unet/predict.py:102,123).
    """

    def __init__(self, path: Union[str, os.PathLike, BinaryIO],
                 compress: Optional[int] = None, bigtiff: bool = False):
        if hasattr(path, "write"):
            self._fh: BinaryIO = path  # type: ignore[assignment]
            self._owns = False
        else:
            self._fh = open(path, "wb")
            self._owns = True
        self._compress = compress  # None or zlib level 1..9 / True
        self._big = bool(bigtiff)
        if self._big:  # BigTIFF: 64-bit offsets, no 4 GiB limit
            self._prev_ifd_link = 8
            self._fh.write(b"II+\x00" + struct.pack("<HHQ", 8, 0, 0))
        else:
            self._prev_ifd_link = 4  # header next-IFD offset position
            self._fh.write(b"II*\x00" + struct.pack("<I", 0))
        self._closed = False

    # -- context manager --
    def __enter__(self) -> "TiffWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write(self, page: np.ndarray) -> None:
        """Append one page.  ``page`` is (H, W) or (H, W, C); a (N, H, W[, C])
        stack writes N pages."""
        page = np.asarray(page)
        if page.ndim == 4 or (page.ndim == 3 and page.shape[-1] > 8):
            for frame in page:
                self._write_one(frame)
        else:
            self._write_one(page)

    def _write_one(self, page: np.ndarray) -> None:
        if self._closed:
            raise ValueError("TiffWriter is closed")
        if page.ndim == 2:
            h, w, c = page.shape[0], page.shape[1], 1
        elif page.ndim == 3:
            h, w, c = page.shape
        else:
            raise TiffFormatError(f"page must be 2-D or 3-D, got shape {page.shape}")
        dt = page.dtype
        if dt == np.dtype(bool):
            page = page.astype(np.uint8) * 255
            dt = page.dtype
        if dt not in _DTYPE_TO_FORMAT:
            raise TiffFormatError(f"unsupported dtype {dt}")
        bps, fmt = _DTYPE_TO_FORMAT[dt]

        raw = np.ascontiguousarray(page).tobytes()
        if self._compress:
            level = 6 if self._compress is True else int(self._compress)
            data = zlib.compress(raw, level)
            comp = COMPRESSION_DEFLATE
        else:
            data = raw
            comp = COMPRESSION_NONE

        fh = self._fh
        fh.seek(0, io.SEEK_END)
        data_offset = fh.tell()
        if data_offset % 2:  # keep word alignment
            fh.write(b"\x00")
            data_offset += 1
        if not self._big and data_offset + len(data) > 0xFFFFFFFF:
            # classic TIFF offsets are 32-bit; fail loudly instead of
            # writing wrapped offsets (struct.pack would raise later with a
            # far less actionable message)
            raise TiffFormatError(
                "file would exceed the classic-TIFF 4 GiB limit — pass "
                "bigtiff=True (imwrite auto-promotes), split the stack "
                "across files, or reduce precision")
        fh.write(data)

        # Build the IFD. Entries must be ascending by tag.
        entries: List[Tuple[int, int, int, bytes]] = []
        pack_of = {TYPE_SHORT: "H", TYPE_LONG: "I", TYPE_LONG8: "Q"}

        def entry(tag: int, typ: int, values) -> None:
            if isinstance(values, int):
                values = [values]
            count = len(values)
            payload = struct.pack("<" + pack_of[typ] * count, *values)
            entries.append((tag, typ, count, payload))

        off_type = TYPE_LONG8 if self._big else TYPE_LONG
        entry(TAG_IMAGE_WIDTH, TYPE_LONG, w)
        entry(TAG_IMAGE_LENGTH, TYPE_LONG, h)
        entry(TAG_BITS_PER_SAMPLE, TYPE_SHORT, [bps] * c)
        entry(TAG_COMPRESSION, TYPE_SHORT, comp)
        entry(TAG_PHOTOMETRIC, TYPE_SHORT, 1)  # BlackIsZero
        entry(TAG_STRIP_OFFSETS, off_type, data_offset)
        entry(TAG_SAMPLES_PER_PIXEL, TYPE_SHORT, c)
        entry(TAG_ROWS_PER_STRIP, TYPE_LONG, h)
        entry(TAG_STRIP_BYTE_COUNTS, off_type, len(data))
        if c > 1:
            entry(TAG_PLANAR_CONFIG, TYPE_SHORT, 1)  # chunky
        entry(TAG_SAMPLE_FORMAT, TYPE_SHORT, [fmt] * c)

        fh.seek(0, io.SEEK_END)
        ifd_offset = fh.tell()
        if ifd_offset % 2:
            fh.write(b"\x00")
            ifd_offset += 1

        n = len(entries)
        # per-flavor IFD geometry: (count bytes, entry bytes, inline bytes)
        cnt_size, entry_size, inline = (8, 20, 8) if self._big else (2, 12, 4)
        head_fmt = "<HHQ" if self._big else "<HHI"
        link_fmt = "<Q" if self._big else "<I"
        # Out-of-line values go right after the IFD.
        value_area = ifd_offset + cnt_size + entry_size * n + inline
        out = struct.pack("<Q" if self._big else "<H", n)
        deferred = b""
        for tag, typ, count, payload in entries:
            if len(payload) <= inline:
                out += struct.pack(head_fmt, tag, typ, count) + payload.ljust(
                    inline, b"\x00")
            else:
                if len(deferred) % 2:
                    deferred += b"\x00"
                out += struct.pack(head_fmt, tag, typ, count) + struct.pack(
                    link_fmt, value_area + len(deferred))
                deferred += payload
        out += struct.pack(link_fmt, 0)  # next IFD (patched by the next write)
        if not self._big and value_area + len(deferred) > 0xFFFFFFFF:
            # the IFD region itself can cross the 32-bit boundary even when
            # the pixel data fit — same actionable error as the data guard
            raise TiffFormatError(
                "file would exceed the classic-TIFF 4 GiB limit — pass "
                "bigtiff=True (imwrite auto-promotes), split the stack "
                "across files, or reduce precision")
        fh.write(out + deferred)

        # Link from the previous IFD (or header) to this one.
        fh.seek(self._prev_ifd_link)
        fh.write(struct.pack(link_fmt, ifd_offset))
        self._prev_ifd_link = ifd_offset + cnt_size + entry_size * n
        fh.flush()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._owns:
                self._fh.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class TiffReader:
    """Streaming multipage TIFF reader.

    Parses IFDs lazily; ``read_page(i)`` decodes one page so arbitrarily long
    movies can be consumed frame-by-frame (reference: siam_unet/predict.py:79-81
    uses ``TiffFile(...).pages``).
    """

    def __init__(self, path: Union[str, os.PathLike, BinaryIO]):
        if hasattr(path, "read"):
            self._fh: BinaryIO = path  # type: ignore[assignment]
            self._owns = False
        else:
            self._fh = open(path, "rb")
            self._owns = True
        header = self._fh.read(8)
        if len(header) < 8 or header[:2] not in (b"II", b"MM"):
            raise TiffFormatError("not a TIFF file")
        self._bo = "<" if header[:2] == b"II" else ">"
        magic = struct.unpack(self._bo + "H", header[2:4])[0]
        if magic == 42:  # classic TIFF: 32-bit offsets
            self._big = False
            first = struct.unpack(self._bo + "I", header[4:8])[0]
        elif magic == 43:  # BigTIFF: 64-bit offsets (tifffile's >4 GiB files)
            self._big = True
            offsize, zero = struct.unpack(self._bo + "HH", header[4:8])
            if offsize != 8 or zero != 0:
                raise TiffFormatError(f"bad BigTIFF header ({offsize}, {zero})")
            (first,) = struct.unpack(self._bo + "Q", self._fh.read(8))
        else:
            raise TiffFormatError(f"bad TIFF magic {magic}")
        pos = self._fh.tell()
        self._fh.seek(0, 2)
        self._size = self._fh.tell()
        self._fh.seek(pos)
        self._ifd_offsets: List[int] = []
        self._next_ifd = first
        self._scan_all_ifds()

    def _seek_checked(self, pos: int, what: str) -> None:
        """Seek bounded by the file size: a corrupt 64-bit offset/count must
        raise the codec's own error, not the OS-level \"cannot fit 'int'
        into an offset-sized integer\" ValueError."""
        if not 0 <= pos <= self._size:
            raise TiffFormatError(
                f"{what} offset {pos} outside file (size {self._size})")
        self._fh.seek(pos)

    # (count size, entry size, next-pointer format) per container flavor
    @property
    def _ifd_layout(self):
        return (8, 20, "Q") if self._big else (2, 12, "I")

    def _scan_all_ifds(self) -> None:
        seen = set()
        offset = self._next_ifd
        cnt_size, entry_size, next_fmt = self._ifd_layout
        cnt_fmt = "Q" if self._big else "H"
        while offset and offset not in seen:
            seen.add(offset)
            self._ifd_offsets.append(offset)
            self._seek_checked(offset, "IFD")
            raw = self._fh.read(cnt_size)
            if len(raw) < cnt_size:
                raise TiffFormatError("truncated IFD (entry count past EOF)")
            (n,) = struct.unpack(self._bo + cnt_fmt, raw)
            self._seek_checked(offset + cnt_size + entry_size * n,
                               "IFD next-pointer")
            nxt_size = struct.calcsize(next_fmt)
            raw = self._fh.read(nxt_size)
            if len(raw) < nxt_size:
                raise TiffFormatError("truncated IFD (next pointer past EOF)")
            (offset,) = struct.unpack(self._bo + next_fmt, raw)

    def __enter__(self) -> "TiffReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self._ifd_offsets)

    @property
    def n_pages(self) -> int:
        return len(self._ifd_offsets)

    def _read_tags(self, ifd_offset: int) -> dict:
        fh = self._fh
        self._seek_checked(ifd_offset, "IFD")
        cnt_size, entry_size, off_fmt = self._ifd_layout
        cnt_raw = fh.read(cnt_size)
        if len(cnt_raw) < cnt_size:
            raise TiffFormatError("truncated IFD (entry count past EOF)")
        (n,) = struct.unpack(self._bo + ("Q" if self._big else "H"), cnt_raw)
        raw = fh.read(entry_size * n)
        if len(raw) < entry_size * n:
            raise TiffFormatError("truncated IFD (entries past EOF)")
        tags = {}
        type_size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                     10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
        type_fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
                    12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
        inline = 8 if self._big else 4
        count_fmt = "Q" if self._big else "I"
        for i in range(n):
            base = i * entry_size
            tag, typ = struct.unpack(self._bo + "HH", raw[base : base + 4])
            (count,) = struct.unpack(
                self._bo + count_fmt, raw[base + 4 : base + 4 + (8 if self._big else 4)])
            size = type_size.get(typ, 1) * count
            value_pos = base + 4 + (8 if self._big else 4)
            if size <= inline:
                payload = raw[value_pos : value_pos + size]
            else:
                (value_offset,) = struct.unpack(
                    self._bo + off_fmt, raw[value_pos : value_pos + inline])
                self._seek_checked(value_offset, f"tag {tag} value")
                payload = fh.read(min(size, self._size - value_offset))
            if typ in type_fmt:
                if len(payload) != size:
                    # out-of-bounds value area — also bounds `count` by the
                    # file size BEFORE the "fmt * count" string below, so a
                    # corrupt 2^32 count cannot allocate a gigabyte format
                    # string
                    raise TiffFormatError(
                        f"tag {tag} value truncated ({len(payload)}/{size} "
                        "bytes)")
                values = struct.unpack(self._bo + type_fmt[typ] * count, payload)
                tags[tag] = values
        return tags

    def page_shape(self, index: int = 0) -> Tuple[int, ...]:
        tags = self._read_tags(self._ifd_offsets[index])
        for required in (TAG_IMAGE_LENGTH, TAG_IMAGE_WIDTH):
            if required not in tags:
                raise TiffFormatError(f"missing required tag {required}")
        h = tags[TAG_IMAGE_LENGTH][0]
        w = tags[TAG_IMAGE_WIDTH][0]
        c = tags.get(TAG_SAMPLES_PER_PIXEL, (1,))[0]
        return (h, w) if c == 1 else (h, w, c)

    def page_dtype(self, index: int = 0) -> np.dtype:
        tags = self._read_tags(self._ifd_offsets[index])
        bps = tags.get(TAG_BITS_PER_SAMPLE, (1,))[0]
        fmt = tags.get(TAG_SAMPLE_FORMAT, (SAMPLEFORMAT_UINT,))[0]
        key = (bps, fmt)
        if key not in _FORMAT_TO_DTYPE:
            raise TiffFormatError(f"unsupported sample format bits={bps} fmt={fmt}")
        return np.dtype(_FORMAT_TO_DTYPE[key])

    def read_page(self, index: int) -> np.ndarray:
        tags = self._read_tags(self._ifd_offsets[index])
        for required in (TAG_IMAGE_LENGTH, TAG_IMAGE_WIDTH):
            if required not in tags:
                raise TiffFormatError(f"missing required tag {required}")
        h = tags[TAG_IMAGE_LENGTH][0]
        w = tags[TAG_IMAGE_WIDTH][0]
        c = tags.get(TAG_SAMPLES_PER_PIXEL, (1,))[0]
        comp = tags.get(TAG_COMPRESSION, (COMPRESSION_NONE,))[0]
        predictor = tags.get(TAG_PREDICTOR, (1,))[0]
        planar = tags.get(TAG_PLANAR_CONFIG, (1,))[0]
        if planar != 1:
            raise TiffFormatError("planar configuration 2 not supported")
        if predictor != 1:
            raise TiffFormatError(f"predictor {predictor} not supported")
        dtype = self.page_dtype(index)

        if TAG_STRIP_OFFSETS not in tags or TAG_STRIP_BYTE_COUNTS not in tags:
            # TileOffsets (324) instead of strips = a tiled TIFF — raise the
            # codec's own error so imread's imageio/PIL fallback triggers
            raise TiffFormatError(
                "no strip offsets (tiled or malformed TIFF) — not supported "
                "by the built-in codec")
        offsets = tags[TAG_STRIP_OFFSETS]
        counts = tags[TAG_STRIP_BYTE_COUNTS]
        need = h * w * c * dtype.itemsize
        if need > (1 << 40):
            # >1 TiB for a single 2-D page = corrupt dimension tags; refuse
            # before any allocation keyed on them
            raise TiffFormatError(
                f"implausible page size {h}x{w}x{c} ({need} bytes)")
        chunks = []
        got = 0
        for off, cnt in zip(offsets, counts):
            self._seek_checked(off, "strip")
            buf = self._fh.read(min(cnt, self._size - off))
            if comp in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_OLD):
                try:
                    # cap inflation at the bytes the page can actually use:
                    # a corrupt/malicious deflate stream must not expand past
                    # the declared page size (decompression-bomb guard)
                    d = zlib.decompressobj()
                    buf = d.decompress(buf, max(need - got, 1))
                except zlib.error as e:
                    raise TiffFormatError(
                        f"corrupt deflate strip: {e}") from None
            elif comp != COMPRESSION_NONE:
                raise TiffFormatError(f"compression {comp} not supported")
            got += len(buf)
            chunks.append(buf)
            if got >= need:
                break
        data = b"".join(chunks)
        if len(data) < need:
            raise TiffFormatError(
                f"truncated page data ({len(data)}/{need} bytes)")
        arr = np.frombuffer(data, dtype=dtype.newbyteorder(self._bo))[: h * w * c]
        arr = arr.astype(dtype)  # native byte order
        return arr.reshape((h, w) if c == 1 else (h, w, c))

    def iter_pages(self) -> Iterator[np.ndarray]:
        for i in range(len(self._ifd_offsets)):
            yield self.read_page(i)

    def asarray(self) -> np.ndarray:
        pages = [self.read_page(i) for i in range(len(self._ifd_offsets))]
        if len(pages) == 1:
            return pages[0]
        return np.stack(pages)

    def close(self) -> None:
        if self._owns:
            self._fh.close()


# ---------------------------------------------------------------------------
# Convenience API (tifffile-compatible surface used by the reference)
# ---------------------------------------------------------------------------


def imwrite(path, data: np.ndarray, compress: Optional[int] = None,
            bigtiff: Optional[bool] = None) -> None:
    """Write an array as TIFF.  (H,W), (H,W,C) write one page; (N,H,W[,C])
    writes a multipage stack.

    ``bigtiff=None`` auto-promotes to BigTIFF (64-bit offsets) when the
    uncompressed payload approaches the classic 4 GiB limit — matching
    tifffile's transparent handling of large microscopy movies.

    The port's codec is this pure-numpy writer; the JAX package's native
    multithreaded encoder is not bound yet."""
    data = np.asarray(data)
    if bigtiff is None:
        # headroom for per-page IFDs/alignment (~200 bytes each — a
        # 262k-page movie carries ~50 MB of IFDs) plus slack; compression
        # only shrinks strips
        n_pages = data.shape[0] if data.ndim >= 3 else 1
        bigtiff = data.nbytes + 256 * n_pages > 0xFFFFFFFF - (1 << 20)
    with TiffWriter(path, compress=compress, bigtiff=bigtiff) as tw:
        if data.ndim <= 2 or (data.ndim == 3 and data.shape[-1] <= 8):
            tw.write(data)
        else:
            for frame in data:
                tw.write(frame)


def imread(path) -> np.ndarray:
    """Read a TIFF as an array ((H,W[,C]) single page, (N,H,W[,C]) stack).

    The pure-Python reader first, then imageio/PIL for container features
    it does not parse."""
    try:
        with TiffReader(path) as tr:
            return tr.asarray()
    except (TiffFormatError, struct.error):
        # struct.error = truncated/garbled container — let PIL/imageio try
        pass
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(path))
    except Exception:
        pass
    try:
        from PIL import Image

        im = Image.open(path)
        frames = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            frames.append(np.array(im))
        return frames[0] if len(frames) == 1 else np.stack(frames)
    except Exception as pil_err:
        # every decoder in the chain refused — surface ONE codec error
        # (PIL raises SyntaxError/OSError/etc. on garbage; those types must
        # not leak to callers as if they were programming errors)
        raise TiffFormatError(
            f"could not decode {path!r} as TIFF with the built-in, "
            f"imageio, or PIL decoders (last error: {pil_err})") from pil_err
