"""WAV (RIFF/WAVE) reading and writing (port of ``llzlab_tpu/io/wav.py``;
numpy and ``struct`` only, the same code).

Host-side only: device code never touches files.  Supported: PCM
16/24/32-bit int, IEEE float32/float64, any channel count; unknown chunks
are skipped on read and never written.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["WavInfo", "read_wav", "write_wav", "wav_info"]

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits: int
    fmt: int  # 1 = PCM int, 3 = IEEE float
    frames: int


def _parse_chunks(buf: bytes):
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def wav_info(path: str) -> WavInfo:
    with open(path, "rb") as f:
        buf = f.read()
    return _info_from_buffer(buf)[0]


def _info_from_buffer(buf: bytes):
    fmt = None
    data_off = data_size = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            tag, ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", buf, off)
            if tag == _FMT_EXTENSIBLE and size >= 40:
                (sub,) = struct.unpack_from("<H", buf, off + 24)
                tag = sub
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            data_off, data_size = off, size
    if fmt is None or data_off is None:
        raise ValueError("missing fmt or data chunk")
    tag, ch, rate, bits = fmt
    if tag not in (_FMT_PCM, _FMT_FLOAT):
        raise ValueError(f"unsupported WAVE format tag {tag}")
    bytes_per = bits // 8
    frames = data_size // (ch * bytes_per)
    return WavInfo(rate, ch, bits, tag, frames), data_off, data_size


def read_wav(path: str, *, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Read a WAV file → ``(data (channels, frames) dtype, sample_rate)``.

    Integer PCM is scaled to [-1, 1); float data passes through.
    """
    with open(path, "rb") as f:
        buf = f.read()
    info, off, size = _info_from_buffer(buf)
    raw = buf[off : off + size]
    if info.fmt == _FMT_FLOAT:
        np_dt = np.float32 if info.bits == 32 else np.float64
        x = np.frombuffer(raw, dtype="<" + np.dtype(np_dt).str[1:]).astype(
            np.float64
        )
    elif info.bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif info.bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif info.bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float64)
        x /= float(1 << 23)
    else:
        raise ValueError(f"unsupported bit depth {info.bits}")
    n = info.frames * info.channels
    x = x[:n].reshape(info.frames, info.channels).T  # (C, T)
    return np.ascontiguousarray(x.astype(dtype)), info.sample_rate


def write_wav(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    *,
    bits: int = 32,
    fmt: str = "float",
) -> None:
    """Write ``(channels, frames)`` or ``(frames,)`` audio to a WAV file.

    ``fmt``: "float" (IEEE f32, default — bit-transparent for pipeline
    output) or "pcm" (16/24/32-bit int with clipping).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    ch, frames = data.shape
    inter = np.ascontiguousarray(data.T)  # (frames, channels)
    if fmt == "float":
        bits = 32
        payload = inter.astype("<f4").tobytes()
        tag = _FMT_FLOAT
    elif fmt == "pcm":
        tag = _FMT_PCM
        clipped = np.clip(inter, -1.0, 1.0 - 1e-9)
        if bits == 16:
            payload = (clipped * 32768.0).astype("<i2").tobytes()
        elif bits == 32:
            payload = (clipped * 2147483648.0).astype("<i4").tobytes()
        elif bits == 24:
            ints = (clipped * float(1 << 23)).astype(np.int32)
            b = np.empty((ints.size, 3), np.uint8)
            flat = ints.reshape(-1)
            b[:, 0] = flat & 0xFF
            b[:, 1] = (flat >> 8) & 0xFF
            b[:, 2] = (flat >> 16) & 0xFF
            payload = b.tobytes()
        else:
            raise ValueError(f"unsupported pcm bit depth {bits}")
    else:
        raise ValueError(f"unknown fmt {fmt!r}")
    byte_rate = sample_rate * ch * bits // 8
    block_align = ch * bits // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", tag, ch, sample_rate, byte_rate, block_align, bits
    )
    data_size = len(payload)
    riff_size = 4 + (8 + len(fmt_chunk)) + (8 + data_size + (data_size & 1))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
        f.write(b"data" + struct.pack("<I", data_size) + payload)
        if data_size & 1:
            f.write(b"\x00")
