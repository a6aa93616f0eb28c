"""Audio codec (counterpart of lass_tpu/audio/io.py): WAV (PCM 8/16/24/32-bit
and IEEE float32/64, mono or multi-channel) and FLAC, decoded to float32 in
[-1, 1] shaped (channels, samples), and a WAV writer.

``read_wav``, ``read_wav_bytes``, ``read_audio`` and ``read_audio_bytes``
decode through the native decoders (``lass_torch.native``, built with g++
at first use); a failed build raises, with no fallback. The numpy
decoders, ``read_wav_bytes_plain`` here and
``lass_torch.audio.flac.decode_flac_bytes``, are the plain versions the
tests hold the native ones to, bit for bit.
"""
from __future__ import annotations

import io as _io
import struct
from typing import Tuple

import numpy as np

from lass_torch import native

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str, mono: bool = False) -> Tuple[np.ndarray, int]:
    """Returns (data (channels, samples) float32 in [-1, 1], sample_rate);
    one channel, the channels' mean, with ``mono``."""
    with open(path, "rb") as f:
        payload = f.read()
    try:
        return native.decode_wav(payload, mono)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc


def read_wav_bytes(payload: bytes, mono: bool = False
                   ) -> Tuple[np.ndarray, int]:
    """In-memory decode (the tar-shard pipeline, data/shards.py): read_wav's
    contract from a bytes payload."""
    return native.decode_wav(payload, mono)


def read_wav_bytes_plain(payload: bytes, mono: bool = False
                         ) -> Tuple[np.ndarray, int]:
    """``read_wav_bytes`` in numpy (the plain version)."""
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
        return native.decode_flac(payload, mono)
    if payload[:4] == b"RIFF":
        return native.decode_wav(payload, mono)
    raise ValueError("unrecognized audio container (expected RIFF/WAVE "
                     "or fLaC magic)")


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
