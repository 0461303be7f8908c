"""16-bit grayscale and 8-bit RGB PNG codec for recorded sequences
(counterpart of utils/pngio.py, copied: struct, zlib and numpy only).

Recorded sequences store depth as 16-bit PNGs. This is a pure-Python zlib
codec, so reading them needs neither OpenCV nor imageio.

Supports the subset the datasets use: 8/16-bit grayscale, all five PNG
scanline filters, no interlacing. Writes filter-0 16-bit grayscale.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload)) + tag + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png16(path: str, img: np.ndarray) -> None:
    """uint16 [H,W] -> 16-bit grayscale PNG (big-endian samples)."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"need uint16 [H,W], got {img.dtype} {img.shape}")
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)  # 16-bit gray
    raw = img.astype(">u2").tobytes()
    stride = 2 * w
    scanlines = b"".join(
        b"\x00" + raw[y * stride:(y + 1) * stride] for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(_chunk(b"IEND", b""))


def write_png_rgb(path: str, img: np.ndarray) -> None:
    """uint8 [H,W,3] -> 8-bit RGB PNG (for overlay visualizations)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"need uint8 [H,W,3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = img.tobytes()
    stride = 3 * w
    scanlines = b"".join(
        b"\x00" + raw[y * stride:(y + 1) * stride] for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = data[pos]
        pos += 1
        line = np.frombuffer(data[pos:pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def _read_chunks(path: str) -> tuple[tuple, bytes]:
    """-> (IHDR fields, decompressed scanline stream)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    ihdr = None
    idat = []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: missing IHDR")
    if ihdr[6] != 0:
        raise ValueError(f"{path}: interlaced PNG unsupported")
    return ihdr, zlib.decompress(b"".join(idat))


# channels per pixel by PNG color type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png_gray(path: str) -> np.ndarray:
    """PNG -> uint8 or uint16 [H,W] (grayscale only, no interlace)."""
    (w, h, depth, color, comp, filt, interlace), raw = _read_chunks(path)
    if color != 0:
        raise ValueError(f"{path}: color type {color} unsupported (gray only)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} unsupported")
    bpp = depth // 8
    bytes_img = _unfilter(raw, h, w, bpp)
    if depth == 8:
        return bytes_img.reshape(h, w)
    return bytes_img.reshape(h, w * 2).view(">u2").astype(np.uint16).reshape(h, w)


def read_png_rgb(path: str) -> np.ndarray:
    """PNG -> uint8 [H,W,3]. Accepts 8-bit RGB / RGBA (alpha dropped) /
    grayscale (replicated) — the color-stream formats an RGB-D recording
    plausibly uses (SURVEY.md §3 "Dataset I/O": the released sequences
    are RGB-D; VERDICT r1 item 7)."""
    (w, h, depth, color, comp, filt, interlace), raw = _read_chunks(path)
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit color unsupported (8 only)")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: color type {color} unsupported")
    ch = _CHANNELS[color]
    img = _unfilter(raw, h, w, ch).reshape(h, w, ch)
    if color == 0:
        return np.repeat(img, 3, axis=-1)
    if color == 4:  # gray+alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
