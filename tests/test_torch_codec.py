"""lass_torch's native audio decoders (lass_torch/native/lassio.cpp, built
here with g++) against lass_tpu's readers and the port's numpy decoders,
bit for bit: WAV in PCM 8/16/24/32-bit and IEEE float32/64 (one in the
WAVE_FORMAT_EXTENSIBLE layout, one with an odd-sized chunk before its
data), mono and stereo with the mono mixdown; FLAC from the port's encoder
(stereo and mono) and the hand-authored streams of
tests/test_torch_shards.py (LPC, escapes, wasted bits, the stereo
decorrelation modes, 8- and 24-bit). Malformed payloads raise ValueError
where lass_tpu's do; a build that fails raises with the compiler's output
and nothing falls back. Also ``lass_torch.utils.misc`` against lass_tpu's.
"""
import struct

import numpy as np
import pytest

from lass_tpu.audio import flac as jax_flac
from lass_tpu.audio import io as jax_io
from lass_tpu.utils import misc as jax_misc
from lass_torch import native
from lass_torch.audio import flac, io
from lass_torch.utils import misc
from test_torch_shards import flac_streams


def wav_bytes(samples: np.ndarray, fmt: int, bits: int, rate: int = 22050,
              extensible: bool = False, junk: bytes = b"") -> bytes:
    """A RIFF/WAVE payload of interleaved (frames, channels) ``samples``
    already in the stored integer or float type."""
    channels = samples.shape[1]
    if bits == 24:
        ints = samples.astype("<i4").reshape(-1)
        data = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in ints)
    else:
        data = samples.tobytes()
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt,
                            channels, rate, rate * block, block, bits)
    if extensible:
        fmt_chunk += struct.pack("<HHIH", 22, bits, 0, fmt) + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    if junk:
        chunks += b"LIST" + struct.pack("<I", len(junk)) + junk \
            + b"\x00" * (len(junk) & 1)
    chunks += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def wav_cases():
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (1001, 2))
    return {
        "pcm8": wav_bytes(np.round(x * 127 + 128).astype("u1"), 1, 8),
        "pcm16": wav_bytes(np.round(x * 32767).astype("<i2"), 1, 16),
        "pcm24": wav_bytes(np.round(x * 8388607).astype("<i4"), 1, 24),
        "pcm32": wav_bytes(np.round(x * 2147483000).astype("<i4"), 1, 32),
        "float32": wav_bytes(x.astype("<f4"), 3, 32),
        "float64": wav_bytes(x.astype("<f8"), 3, 64),
        "pcm16_mono": wav_bytes(np.round(x[:, :1] * 32767).astype("<i2"),
                                1, 16),
        "pcm24_extensible": wav_bytes(np.round(x * 8388607).astype("<i4"), 1,
                                      24, extensible=True),
        "float32_junk": wav_bytes(x.astype("<f4"), 3, 32, junk=b"odd"),
    }


@pytest.mark.parametrize("name", sorted(wav_cases()))
@pytest.mark.parametrize("mono", [False, True])
def test_native_wav_equals_jax_and_numpy(name, mono, tmp_path):
    payload = wav_cases()[name]
    got, sr = io.read_wav_bytes(payload, mono)
    plain, sr_plain = io.read_wav_bytes_plain(payload, mono)
    ref, sr_ref = jax_io.read_wav_bytes(payload, mono)
    assert sr == sr_plain == sr_ref == 22050
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    path = tmp_path / "a.wav"
    path.write_bytes(payload)
    for read in (io.read_wav, io.read_audio):
        again, _ = read(str(path), mono)
        np.testing.assert_array_equal(again, ref)
    again, _ = jax_io.read_wav(str(path), mono)
    np.testing.assert_array_equal(got, again)


@pytest.mark.parametrize("mono", [False, True])
def test_native_flac_equals_jax_and_numpy(mono, tmp_path):
    x = ((np.random.RandomState(8).rand(2, 20000) * 2 - 1) * 0.6).astype(
        np.float32)
    streams = [flac.encode_flac(x, 48000), flac.encode_flac(x[:1], 16000),
               *flac_streams()]
    for i, blob in enumerate(streams):
        got, sr = io.read_audio_bytes(blob, mono)
        plain, sr_plain = flac.decode_flac_bytes(blob, mono)
        ref, sr_ref = jax_io.read_audio_bytes(blob, mono)
        assert sr == sr_plain == sr_ref, i
        np.testing.assert_array_equal(got, plain, err_msg=f"stream {i}")
        np.testing.assert_array_equal(got, ref, err_msg=f"stream {i}")
        np.testing.assert_array_equal(
            got, jax_flac.decode_flac_bytes(blob, mono)[0])
    path = tmp_path / "a.flac"
    flac.write_flac(str(path), x, 48000)
    got, _ = io.read_audio(str(path), mono)
    np.testing.assert_array_equal(got, jax_io.read_audio(str(path), mono)[0])


def malformed():
    good_wav = wav_cases()["pcm16"]
    good_flac = flac.encode_flac(np.zeros((1, 5000), np.float32), 16000)
    return {
        "not riff": b"RIFX" + good_wav[4:],
        "no data chunk": good_wav[:36],
        "pcm12": good_wav[:34] + struct.pack("<H", 12) + good_wav[36:],
        "format 2": good_wav[:20] + struct.pack("<H", 2) + good_wav[22:],
        "unknown container": b"OggS" + good_wav[4:],
        "flac without marker": b"fLaX" + good_flac[4:],
        "flac bad frame sync": good_flac[:42] + b"\x00\x00" + good_flac[44:],
    }


@pytest.mark.parametrize("name", sorted(malformed()))
def test_malformed_payloads_raise_value_error_as_jax(name):
    payload = malformed()[name]
    with pytest.raises(ValueError):
        jax_io.read_audio_bytes(payload)
    with pytest.raises(ValueError):
        io.read_audio_bytes(payload)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    broken = tmp_path / "lassio.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)lassio.cpp.*error"):
        io.read_audio_bytes(wav_cases()["pcm16"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_named_by_its_source(tmp_path, monkeypatch):
    io.read_wav_bytes(wav_cases()["pcm16"])  # built (or found) here
    path = native.library_path()
    assert path.endswith(".so") and native.BUILD_DIR in path
    edited = tmp_path / "lassio.cpp"
    edited.write_text(open(native.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(edited))
    assert native.library_path() != path


def test_misc_equals_jax(rng):
    x = rng.uniform(-1.2, 1.2, 1000).astype(np.float32)
    np.testing.assert_array_equal(misc.float32_to_int16(x),
                                  jax_misc.float32_to_int16(x))
    q = misc.float32_to_int16(x)
    np.testing.assert_array_equal(misc.int16_to_float32(q),
                                  jax_misc.int16_to_float32(q))
    np.testing.assert_array_equal(misc.ids_to_hots([0, 3, 3, 7], 9),
                                  jax_misc.ids_to_hots([0, 3, 3, 7], 9))
    for v in (0.0, 1e-12, 0.5, 3.0):
        assert misc.magnitude_to_db(v) == jax_misc.magnitude_to_db(v)
    for d in (-120.0, -6.0, 0.0, 12.5):
        assert misc.db_to_magnitude(d) == jax_misc.db_to_magnitude(d)
