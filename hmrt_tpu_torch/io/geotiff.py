"""Single-band (Geo)TIFF DEM reader (SURVEY.md C4).

A copy of `hmrt_tpu/io/geotiff.py` (standard library and numpy only).

Modern elevation data ships as GeoTIFF (USGS 3DEP, SRTM, Copernicus
DEM): single-band grids of f32/i16/u16 samples, strip- or tile-
organized, uncompressed or deflate/LZW-compressed, often with the
horizontal-differencing predictor. This reader covers exactly that
profile with the stdlib only — no GDAL/rasterio dependency:

  * classic TIFF (II/MM byte order) and BigTIFF (version 43);
  * one sample per pixel, bit depth 8/16/32, unsigned / signed / float
    (SampleFormat 1/2/3);
  * strips (StripOffsets/StripByteCounts) or tiles (TileWidth/...);
  * Compression 1 (none), 8/32946 (deflate), 5 (LZW), 32773 (PackBits);
  * Predictor 1 (none), 2 (horizontal differencing) or 3 (floating-point
    horizontal differencing — GDAL's recommended setting for f32+deflate
    DEMs); any other predictor raises instead of decoding garbage.

Geo* tags (ModelPixelScale etc.) are ignored — the renderer works in
grid units; callers rescale via load_heightmap's z_scale.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# TIFF tag ids
_W, _H = 256, 257
_BITS, _COMP, _SFMT, _PRED, _SPP = 258, 259, 339, 317, 277
_SOFF, _SCNT, _ROWS = 273, 279, 278
_TW, _TH, _TOFF, _TCNT = 322, 323, 324, 325

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-flavor LZW (MSB-first codes, early change)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    code_len, prev = 9, None
    acc = nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= code_len:
            nbits -= code_len
            code = (acc >> nbits) & ((1 << code_len) - 1)
            if code == 256:                      # clear
                table = table[:258]
                code_len, prev = 9, None
                continue
            if code == 257:                      # EOI
                return bytes(out)
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
            # TIFF early change: grow one code early
            if len(table) >= (1 << code_len) - 1 and code_len < 12:
                code_len += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _decompress(data: bytes, comp: int) -> bytes:
    if comp == 1:
        return data
    if comp in (8, 32946):
        return zlib.decompress(data)
    if comp == 5:
        return _lzw_decode(data)
    if comp == 32773:
        return _packbits_decode(data)
    raise ValueError(f"unsupported TIFF compression {comp}")


def _read_ifd(data, bo, big, off):
    """Parse one IFD -> {tag: [values]}."""
    tags = {}
    if big:
        (n,) = struct.unpack_from(bo + "Q", data, off)
        pos, esz, cfmt, clen = off + 8, 20, "Q", 8
    else:
        (n,) = struct.unpack_from(bo + "H", data, off)
        pos, esz, cfmt, clen = off + 2, 12, "I", 4
    for _ in range(n):
        tag, typ = struct.unpack_from(bo + "HH", data, pos)
        (cnt,) = struct.unpack_from(bo + cfmt, data, pos + 4)
        voff = pos + 4 + clen
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            pos += esz
            continue
        nbytes = _TYPE_SIZE[typ] * cnt
        if nbytes > (8 if big else 4):
            (dataoff,) = struct.unpack_from(bo + cfmt, data, voff)
            if dataoff + nbytes > len(data):
                raise ValueError(
                    f"truncated TIFF: tag {tag} data at {dataoff}+{nbytes} "
                    f"exceeds file size {len(data)}")
            raw = data[dataoff:dataoff + nbytes]
        else:
            raw = data[voff:voff + nbytes]
        tags[tag] = list(struct.unpack(bo + fmt * cnt, raw[:nbytes]))
        pos += esz
    return tags


def _unpredict(raw: bytes, pred: int, nrows: int, w: int,
               dt: np.dtype) -> np.ndarray:
    """Undo the TIFF predictor on one strip/tile's decompressed bytes and
    return the (nrows, w) sample array. Predictors per TIFF 6.0 + TechNote:
    1 = none, 2 = horizontal differencing of samples, 3 = floating-point
    horizontal differencing (rows stored as big-endian byte PLANES, MSB
    plane first, then byte-wise differenced)."""
    need = nrows * w * dt.itemsize
    if len(raw) < need:
        raise ValueError(f"truncated TIFF strip/tile: {len(raw)} bytes "
                         f"decoded, {need} expected")
    if pred == 1:
        return np.frombuffer(raw, dt, count=nrows * w).reshape(nrows, w)
    if pred == 2:
        arr = np.frombuffer(raw, dt, count=nrows * w).reshape(nrows, w)
        u = np.dtype(f"{dt.byteorder}u{dt.itemsize}")
        return np.cumsum(arr.view(u), axis=1,
                         dtype=np.uint64).astype(u).view(dt)
    if pred == 3:
        if dt.kind != "f":
            raise ValueError("TIFF predictor 3 on non-float samples")
        bps = dt.itemsize
        b = np.frombuffer(raw, np.uint8, count=need).reshape(nrows, bps * w)
        b = np.cumsum(b, axis=1, dtype=np.uint32).astype(np.uint8)
        msb_planes = b.reshape(nrows, bps, w).transpose(0, 2, 1)
        return np.ascontiguousarray(msb_planes).view(
            np.dtype(f">f{bps}"))[:, :, 0]
    raise ValueError(f"unsupported TIFF predictor {pred}")


def read_tiff_gray(path: str) -> np.ndarray:
    """Read a single-band TIFF/BigTIFF DEM -> (H, W) numpy array
    (native sample dtype: u8/u16/i16/i32/f32...)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    # untrusted-input gate: a file cut inside the header or IFD entry
    # table otherwise surfaces as opaque struct.error messages
    try:
        (ver,) = struct.unpack_from(bo + "H", data, 2)
        if ver == 42:
            big = False
            (ifd_off,) = struct.unpack_from(bo + "I", data, 4)
        elif ver == 43:
            big = True
            (ifd_off,) = struct.unpack_from(bo + "Q", data, 8)
        else:
            raise ValueError(f"{path}: bad TIFF version {ver}")
        t = _read_ifd(data, bo, big, ifd_off)
    except struct.error as e:
        raise ValueError(f"{path}: truncated TIFF (header/IFD: {e})") \
            from None

    w, h = t[_W][0], t[_H][0]
    spp = t.get(_SPP, [1])[0]
    if spp != 1:
        raise ValueError(f"{path}: want 1 sample/pixel (DEM), got {spp}")
    bits = t.get(_BITS, [1])[0]
    sfmt = t.get(_SFMT, [1])[0]
    comp = t.get(_COMP, [1])[0]
    pred = t.get(_PRED, [1])[0]
    kind = {1: "u", 2: "i", 3: "f"}.get(sfmt)
    if kind is None or bits not in (8, 16, 32) or (kind == "f" and bits != 32):
        raise ValueError(f"{path}: unsupported sample format "
                         f"{sfmt}/{bits}-bit")
    dt = np.dtype(f"{bo}{kind}{bits // 8}")

    img = np.zeros((h, w), dt)
    if _TOFF in t:                       # tiled organization
        tw, th = t[_TW][0], t[_TH][0]
        offs, cnts = t[_TOFF], t[_TCNT]
        per_row = (w + tw - 1) // tw
        for i, (o, c) in enumerate(zip(offs, cnts)):
            if o + c > len(data):
                raise ValueError(f"{path}: truncated TIFF (tile {i} at "
                                 f"{o}+{c} exceeds file size {len(data)})")
            raw = _decompress(data[o:o + c], comp)
            tilearr = _unpredict(raw, pred, th, tw, dt)
            ty, tx = (i // per_row) * th, (i % per_row) * tw
            ys, xs = min(th, h - ty), min(tw, w - tx)
            img[ty:ty + ys, tx:tx + xs] = tilearr[:ys, :xs]
    else:                                # strips
        rows = t.get(_ROWS, [h])[0]
        offs, cnts = t[_SOFF], t[_SCNT]
        y = 0
        for o, c in zip(offs, cnts):
            nrows = min(rows, h - y)
            if o + c > len(data):
                raise ValueError(f"{path}: truncated TIFF (strip at "
                                 f"{o}+{c} exceeds file size {len(data)})")
            raw = _decompress(data[o:o + c], comp)
            img[y:y + nrows] = _unpredict(raw, pred, nrows, w, dt)
            y += nrows
    return img.astype(img.dtype.newbyteorder("="))
