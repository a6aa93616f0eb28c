"""Minimal dependency-free RIFF/WAVE codec (the pure-Python path of
lass_tpu/audio/io.py): PCM 8/16/24/32-bit and IEEE float32/64, mono or
multi-channel, returning float32 in [-1, 1] shaped (channels, samples);
FLAC through ``lass_torch.audio.flac`` (the JAX package's native C++
decoder is not ported: both formats decode in Python here).
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str, mono: bool = False) -> Tuple[np.ndarray, int]:
    """Returns (data (channels, samples) float32 in [-1, 1], sample_rate)."""
    data, sr = _read_wav_py(path)
    if mono and data.shape[0] > 1:
        data = data.mean(axis=0, keepdims=True)
    return data, sr


def read_wav_bytes(payload: bytes, mono: bool = False
                   ) -> Tuple[np.ndarray, int]:
    """In-memory decode (the tar-shard pipeline, data/shards.py): read_wav's
    contract from a bytes payload."""
    import io as _io

    data, sr = _read_wav_fileobj(_io.BytesIO(payload), "<bytes>")
    if mono and data.shape[0] > 1:
        data = data.mean(axis=0, keepdims=True)
    return data, sr


def read_audio(path: str, mono: bool = False) -> Tuple[np.ndarray, int]:
    """Format-sniffing loader: WAV or FLAC by magic bytes, read_wav's
    contract."""
    with open(path, "rb") as f:
        payload = f.read()
    try:
        return read_audio_bytes(payload, mono)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc


def read_audio_bytes(payload: bytes, mono: bool = False
                     ) -> Tuple[np.ndarray, int]:
    """In-memory format-sniffing decode (the tar shards: the reference's
    wds.torch_audio decodes FLAC members of LAION-audio shards)."""
    if payload[:4] == b"fLaC":
        from lass_torch.audio.flac import decode_flac_bytes

        return decode_flac_bytes(payload, mono)
    if payload[:4] == b"RIFF":
        return read_wav_bytes(payload, mono)
    raise ValueError("unrecognized audio container (expected RIFF/WAVE "
                     "or fLaC magic)")


def _read_wav_py(path: str) -> Tuple[np.ndarray, int]:
    """Pure-python reference decoder."""
    with open(path, "rb") as f:
        return _read_wav_fileobj(f, path)


def _read_wav_fileobj(f, path: str) -> Tuple[np.ndarray, int]:
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = None
    data = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", header)
        if chunk_id == b"fmt ":
            fmt = f.read(chunk_size)
        elif chunk_id == b"data":
            data = f.read(chunk_size)
        else:
            f.seek(chunk_size + (chunk_size & 1), 1)
            continue
        if chunk_size & 1:
            f.seek(1, 1)
        if fmt is not None and data is not None:
            break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (audio_format, channels, sample_rate, _byte_rate, _block_align,
     bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == _EXTENSIBLE and len(fmt) >= 26:
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == _PCM:
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, "u1").reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = (ints << 8) >> 8  # sign-extend
            x = ints.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, "<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format {audio_format}")

    frames = len(x) // channels
    return (x[: frames * channels].reshape(frames, channels).T.copy(),
            sample_rate)


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """data: (channels, samples) or (samples,) float in [-1, 1]."""
    if data.ndim == 1:
        data = data[None, :]
    channels, _frames = data.shape
    interleaved = data.T.reshape(-1)
    if bits == 16:
        payload = np.round(np.clip(interleaved, -1.0, 1.0)
                           * 32767.0).astype("<i2").tobytes()
        audio_format, block = _PCM, channels * 2
    elif bits == 32:
        payload = interleaved.astype("<f4").tobytes()
        audio_format, block = _IEEE_FLOAT, channels * 4
    else:
        raise ValueError(f"unsupported write depth {bits}")
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", audio_format, channels, sample_rate,
                            sample_rate * block, block, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
