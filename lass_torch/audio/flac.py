"""Dependency-free FLAC codec (counterpart of lass_tpu/audio/flac.py, a
copy of its pure-numpy code; decode: full spec subset; encode: minimal).

The reference's webdataset pipeline decodes FLAC tar members via
``wds.torch_audio`` (models/CLAP/training/data.py), and LAION-audio-style
shards hold FLAC. The port reads FLAC through its native decoder
(``lass_torch.native``); ``decode_flac_bytes`` here is its plain version,
which the tests hold it to. The small encoder authors test vectors and
synthetic shards (FLAC is lossless: round trips are bit-exact).

Decoder coverage: fixed + LPC subframes (all orders), constant/verbatim,
rice residuals (4- and 5-bit parameters, escape partitions), wasted
bits, left/right/mid-side stereo decorrelation, 8/16/24-bit samples,
variable block sizes. Not implemented: 32-bit samples (rare) and MD5
verification (skipped, like most streaming decoders).

Encoder: 16-bit, fixed 4096-sample blocks, per-block best fixed
predictor (order 0-2) with single-partition rice residuals.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}

_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}

_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _BitReader:
    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit cursor

    def read(self, nbits: int) -> int:
        """Big-endian unsigned field."""
        end = self.pos + nbits
        first, last = self.pos >> 3, (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        chunk >>= (last << 3) - end
        self.pos = end
        return chunk & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        return v - (1 << nbits) if v >> (nbits - 1) else v

    def unary(self) -> int:
        """Count 0 bits until the terminating 1 bit."""
        data, pos = self.data, self.pos
        count = 0
        # fast-forward over whole zero bytes
        byte = data[pos >> 3] & (0xFF >> (pos & 7))
        while byte == 0:
            count += 8 - (pos & 7)
            pos += 8 - (pos & 7)
            byte = data[pos >> 3]
        top = byte.bit_length()  # position of highest set bit (1..8)
        count += 8 - (pos & 7) - top
        self.pos = pos + (8 - (pos & 7) - top) + 1
        return count

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's UTF-8-style frame/sample number (extended to 36 bits)."""
    first = br.read(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(nbytes - 1):
        value = (value << 6) | (br.read(8) & 0x3F)
    return value


def _decode_residual(br: _BitReader, block_size: int, order: int
                     ) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    nparts = 1 << part_order
    residual: List[int] = []
    for part in range(nparts):
        count = (block_size >> part_order) - (order if part == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                residual.extend([0] * count)
            else:
                residual.extend(br.read_signed(raw_bits)
                                for _ in range(count))
        else:
            read, unary = br.read, br.unary
            for _ in range(count):
                q = unary()
                v = (q << param) | read(param) if param else q
                residual.append((v >> 1) ^ -(v & 1))
    return residual


def _decode_subframe(br: _BitReader, block_size: int, bps: int
                     ) -> np.ndarray:
    if br.read(1):
        raise ValueError("subframe padding bit set")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):  # wasted-bits flag: unary count-1
        wasted = br.unary() + 1
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        out = np.full(block_size, br.read_signed(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.fromiter((br.read_signed(bps) for _ in range(block_size)),
                          np.int64, block_size)
    elif 8 <= sf_type <= 12:  # FIXED, order = type & 7
        order = sf_type & 7
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        coeffs = _FIXED_COEFFS[order]
        samples = warm + res
        for i in range(order, block_size):
            samples[i] += sum(c * samples[i - 1 - j]
                              for j, c in enumerate(coeffs))
        out = np.asarray(samples, np.int64)
    elif sf_type >= 32:  # LPC, order = (type & 31) + 1
        order = (sf_type & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        samples = warm + res
        for i in range(order, block_size):
            acc = 0
            for j, c in enumerate(coeffs):
                acc += c * samples[i - 1 - j]
            samples[i] += acc >> shift
        out = np.asarray(samples, np.int64)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    return out << wasted if wasted else out


def decode_flac_bytes(payload: bytes, mono: bool = False
                      ) -> Tuple[np.ndarray, int]:
    """FLAC stream -> ((channels, samples) float32 in [-1, 1], rate).

    Same contract as audio.io.read_wav_bytes. Frame CRCs are not
    verified (bitstream errors surface as struct/Value errors instead).
    """
    if payload[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    sample_rate = channels = bps = None
    total = 0
    while True:  # metadata blocks
        header = payload[pos:pos + 4]
        last, btype = header[0] >> 7, header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        if btype == 0:  # STREAMINFO
            br = _BitReader(payload, pos + 4)
            br.read(16 + 16 + 24 + 24)  # block/frame size ranges
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")

    out = [[] for _ in range(channels)]
    n = len(payload)
    decoded = 0
    br = _BitReader(payload, pos)
    while br.byte_pos() < n - 2 and not (total and decoded >= total):
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"bad frame sync at byte {br.byte_pos()}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        size_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(size_code, bps)
        br.read(8)  # header CRC-8 (unverified)

        if chan_code < 8:
            nch = chan_code + 1
            subs = [_decode_subframe(br, block_size, frame_bps)
                    for _ in range(nch)]
        elif chan_code == 8:  # left/side
            left = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            subs = [left, left - side]
        elif chan_code == 9:  # right/side
            side = _decode_subframe(br, block_size, frame_bps + 1)
            right = _decode_subframe(br, block_size, frame_bps)
            subs = [right + side, right]
        elif chan_code == 10:  # mid/side: mid = (L+R)>>1, side = L-R
            mid = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            left = (((mid << 1) | (side & 1)) + side) >> 1
            subs = [left, left - side]
        else:
            raise ValueError(f"reserved channel assignment {chan_code}")
        if len(subs) != channels:
            raise ValueError("frame channel count != STREAMINFO")
        for c, s in enumerate(subs):
            out[c].append(s)
        decoded += block_size
        br.align()
        br.read(16)  # frame CRC-16 (unverified)

    data = np.stack([np.concatenate(ch) for ch in out])
    if total:
        data = data[:, :total]
    scale = float(1 << (bps - 1))
    audio = (data.astype(np.float32) / scale)
    if mono and audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    return audio, sample_rate


# ---------------------------------------------------------------------------
# Minimal encoder (16-bit, fixed predictors 0-2, one rice partition)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1)
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _best_rice_param(res: np.ndarray) -> int:
    zig = (np.abs(2 * res.astype(np.int64)) - (res < 0)).astype(np.uint64)
    mean = float(zig.mean()) if len(zig) else 0.0
    param = 0
    while (1 << (param + 1)) < mean + 1 and param < 14:
        param += 1
    return param


def _write_rice(bw: _BitWriter, res: np.ndarray, param: int) -> None:
    for r in res:
        v = 2 * int(r) if r >= 0 else -2 * int(r) - 1  # zigzag
        q, rem = v >> param, v & ((1 << param) - 1)
        bw.write(1, q + 1)  # q zeros then a 1
        if param:
            bw.write(rem, param)


def _utf8_number(num: int) -> bytes:
    """FLAC's UTF-8-style frame-number coding (inverse of
    _read_utf8_number)."""
    if num < 0x80:
        return bytes([num])
    nbytes = 2
    while num >= (1 << (5 * nbytes + 1)):
        nbytes += 1
    head = ((0xFF << (8 - nbytes)) & 0xFF) | (num >> (6 * (nbytes - 1)))
    tail = [0x80 | ((num >> (6 * i)) & 0x3F)
            for i in range(nbytes - 2, -1, -1)]
    return bytes([head] + tail)


def encode_flac(data: np.ndarray, sample_rate: int,
                block_size: int = 4096) -> bytes:
    """(channels, samples) float in [-1, 1] (or int16) -> FLAC stream.

    16-bit, independent channels, per-block best fixed predictor order
    0-2 with one rice partition. Lossless for int16 input by
    construction (pinned in tests/test_audio.py)."""
    if data.ndim == 1:
        data = data[None, :]
    if data.dtype == np.int16:
        pcm = data.astype(np.int64)
    else:
        pcm = np.round(np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int64)
    channels, nsamples = pcm.shape

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(15, 5)  # bps - 1
    si.write(nsamples, 36)
    body = si.bytes() + b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for frame_idx, start in enumerate(range(0, nsamples, block_size)):
        blk = pcm[:, start:start + block_size]
        bs = blk.shape[1]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocksize strategy
        bw.write(7, 4)  # block size: 16-bit field below
        bw.write(0, 4)  # sample rate: from STREAMINFO
        bw.write(channels - 1, 4)
        bw.write(4, 3)  # 16 bps
        bw.write(0, 1)
        for b in _utf8_number(frame_idx):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        bw.align()
        header = bw.bytes()
        header += bytes([_crc8(header)])

        body_bw = _BitWriter()
        for c in range(channels):
            x = blk[c]
            # pick the cheapest fixed order by residual magnitude
            best = None
            for order in range(0, min(3, bs)):
                res = x[order:].astype(np.int64)
                for j, coef in enumerate(_FIXED_COEFFS[order]):
                    res = res - coef * x[order - 1 - j:bs - 1 - j]
                cost = float(np.abs(res).sum())
                if best is None or cost < best[2]:
                    best = (order, res, cost)
            order, res, _ = best
            body_bw.write(0, 1)
            body_bw.write(8 | order, 6)  # FIXED subframe
            body_bw.write(0, 1)  # no wasted bits
            for w in x[:order]:
                body_bw.write(int(w), 16)
            body_bw.write(0, 2)  # rice 4-bit params
            body_bw.write(0, 4)  # partition order 0
            param = _best_rice_param(res)
            body_bw.write(param, 4)
            _write_rice(body_bw, res, param)
        body_bw.align()
        frame = header + body_bw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
    return bytes(out)


def write_flac(path: str, data: np.ndarray, sample_rate: int) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(data, sample_rate))
