// lassio: the port's native WAV and FLAC decoders (a copy of the JAX
// package's native/lassio.cpp, with a plain C interface bound by ctypes in
// lass_torch/native/__init__.py in place of the CPython module).
//
//   lassio_decode(payload, n, flac, mono, shape, err) -> handle or NULL
//   lassio_take(handle, dst)
//
// lassio_decode parses and decodes a WAV (flac = 0) or FLAC (flac = 1)
// payload; on success shape = {output channels, frames, sample rate} and
// the caller passes a float32 buffer of channels x frames to lassio_take,
// which writes the (channels, frames) samples in [-1, 1] (mono: the
// channels' mean) and frees the handle. On failure it returns NULL with
// *err a static message. A WAV handle points into the payload, which must
// stay alive until lassio_take.
//
// WAV: PCM 8/16/24/32-bit and IEEE float32/64, WAVE_FORMAT_EXTENSIBLE.
// FLAC, the subset of the port's numpy decoder (lass_torch/audio/flac.py):
// fixed + LPC subframes (all orders), constant/verbatim, rice residuals
// (4/5-bit params, escape partitions), wasted bits, left/right/mid-side
// stereo decorrelation, 8-24-bit samples, variable block sizes. Frame CRCs
// are not verified.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
};

bool parse_wav(const uint8_t* buf, size_t n, WavInfo* out, const char** err) {
  if (n < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0) {
    *err = "not a RIFF/WAVE file";
    return false;
  }
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= n) {
    const uint8_t* id = buf + pos;
    uint32_t size;
    std::memcpy(&size, buf + pos + 4, 4);
    pos += 8;
    if (pos + size > n) size = static_cast<uint32_t>(n - pos);
    if (std::memcmp(id, "fmt ", 4) == 0 && size >= 16) {
      std::memcpy(&out->format, buf + pos, 2);
      std::memcpy(&out->channels, buf + pos + 2, 2);
      std::memcpy(&out->sample_rate, buf + pos + 4, 4);
      std::memcpy(&out->bits, buf + pos + 14, 2);
      if (out->format == 0xFFFE && size >= 26) {
        std::memcpy(&out->format, buf + pos + 24, 2);
      }
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      out->data = buf + pos;
      out->data_size = size;
    }
    pos += size + (size & 1);
    if (have_fmt && out->data != nullptr) break;
  }
  if (!have_fmt || out->data == nullptr) {
    *err = "missing fmt/data chunk";
    return false;
  }
  if (out->channels == 0) {
    *err = "zero channels";
    return false;
  }
  return true;
}

// Convert one interleaved frame stream to float32 planar (C, N) or mono.
template <typename Fetch>
void convert(const WavInfo& w, size_t frames, bool mono, float* dst,
             Fetch fetch) {
  const size_t c = w.channels;
  if (mono && c > 1) {
    const float inv = 1.0f / static_cast<float>(c);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (size_t ch = 0; ch < c; ++ch) acc += fetch(i * c + ch);
      dst[i] = acc * inv;
    }
  } else {
    for (size_t ch = 0; ch < c; ++ch) {
      float* row = dst + ch * frames;
      for (size_t i = 0; i < frames; ++i) row[i] = fetch(i * c + ch);
    }
  }
}


bool wav_supported(const WavInfo& w) {
  if (w.format == 1)
    return w.bits == 8 || w.bits == 16 || w.bits == 24 || w.bits == 32;
  return w.format == 3 && (w.bits == 32 || w.bits == 64);
}

void wav_take(const WavInfo& w, bool mono, size_t frames, float* dst) {
  const uint8_t* d = w.data;
  if (w.format == 1 && w.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(d);
    convert(w, frames, mono, dst,
            [s](size_t i) { return static_cast<float>(s[i]) / 32768.0f; });
  } else if (w.format == 1 && w.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(d);
    convert(w, frames, mono, dst, [s](size_t i) {
      return static_cast<float>(s[i]) / 2147483648.0f;
    });
  } else if (w.format == 1 && w.bits == 24) {
    convert(w, frames, mono, dst, [d](size_t i) {
      const uint8_t* p = d + 3 * i;
      int32_t v = (p[0] | (p[1] << 8) | (p[2] << 16)) << 8;
      return static_cast<float>(v >> 8) / 8388608.0f;
    });
  } else if (w.format == 1 && w.bits == 8) {
    convert(w, frames, mono, dst, [d](size_t i) {
      return (static_cast<float>(d[i]) - 128.0f) / 128.0f;
    });
  } else if (w.format == 3 && w.bits == 32) {
    const float* s = reinterpret_cast<const float*>(d);
    convert(w, frames, mono, dst, [s](size_t i) { return s[i]; });
  } else {  // IEEE float64
    const double* s = reinterpret_cast<const double*>(d);
    convert(w, frames, mono, dst,
            [s](size_t i) { return static_cast<float>(s[i]); });
  }
}

// ---------------------------------------------------------------------------
// FLAC
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* d;
  size_t nbits;      // total bits
  size_t pos = 0;    // bit cursor
  bool ok = true;

  BitReader(const uint8_t* data, size_t nbytes, size_t byte_pos = 0)
      : d(data), nbits(nbytes * 8), pos(byte_pos * 8) {}

  uint64_t read(unsigned bits) {
    if (bits == 0) return 0;
    size_t end = pos + bits;
    if (end > nbits) {
      ok = false;
      pos = nbits;
      return 0;
    }
    size_t first = pos >> 3, last = (end + 7) >> 3;
    uint64_t chunk = 0;
    for (size_t i = first; i < last; ++i) chunk = (chunk << 8) | d[i];
    chunk >>= (last << 3) - end;
    pos = end;
    return chunk & ((bits >= 64) ? ~0ULL : ((1ULL << bits) - 1));
  }

  int64_t read_signed(unsigned bits) {
    uint64_t v = read(bits);
    if (bits && (v >> (bits - 1))) return static_cast<int64_t>(v) -
                                          (1LL << bits);
    return static_cast<int64_t>(v);
  }

  uint32_t unary() {
    uint32_t count = 0;
    while (true) {
      if (pos >= nbits) {
        ok = false;
        return 0;
      }
      size_t byte = pos >> 3;
      unsigned off = pos & 7;
      uint8_t b = d[byte] & (0xFF >> off);
      if (b == 0) {
        count += 8 - off;
        pos += 8 - off;
        continue;
      }
      unsigned msb = __builtin_clz(static_cast<unsigned>(b)) - 24;  // 0..7
      count += msb - off;
      pos += (msb - off) + 1;
      return count;
    }
  }

  void align() { pos = (pos + 7) & ~static_cast<size_t>(7); }
  size_t byte_pos() const { return pos >> 3; }
};

uint64_t read_utf8_number(BitReader* br) {
  uint64_t first = br->read(8);
  if (first < 0x80) return first;
  int nbytes = 0;
  uint64_t mask = 0x80;
  while (first & mask) {
    ++nbytes;
    mask >>= 1;
  }
  uint64_t value = first & (mask - 1);
  for (int i = 0; i < nbytes - 1; ++i)
    value = (value << 6) | (br->read(8) & 0x3F);
  return value;
}

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};
const int kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, 0,    0,
                             256, 512,  1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

bool decode_residual(BitReader* br, int block_size, int order,
                     int64_t* out, const char** err) {
  unsigned method = br->read(2);
  if (method > 1) {
    *err = "reserved residual method";
    return false;
  }
  unsigned param_bits = method == 0 ? 4 : 5;
  unsigned escape = (1u << param_bits) - 1;
  unsigned part_order = br->read(4);
  int nparts = 1 << part_order;
  int idx = 0;
  for (int part = 0; part < nparts; ++part) {
    int count = (block_size >> part_order) - (part == 0 ? order : 0);
    if (count < 0) {
      *err = "bad rice partition";
      return false;
    }
    unsigned param = br->read(param_bits);
    if (param == escape) {
      unsigned raw_bits = br->read(5);
      if (raw_bits == 0) {
        for (int i = 0; i < count; ++i) out[idx++] = 0;
      } else {
        for (int i = 0; i < count; ++i) out[idx++] = br->read_signed(raw_bits);
      }
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br->unary();
        uint64_t v = param ? ((q << param) | br->read(param)) : q;
        out[idx++] = static_cast<int64_t>(v >> 1) ^
                     -static_cast<int64_t>(v & 1);
      }
    }
    if (!br->ok) {
      *err = "truncated residual";
      return false;
    }
  }
  return true;
}

bool decode_subframe(BitReader* br, int block_size, int bps,
                     std::vector<int64_t>* out, const char** err) {
  out->resize(block_size);
  int64_t* s = out->data();
  if (br->read(1)) {
    *err = "subframe padding bit set";
    return false;
  }
  unsigned sf_type = br->read(6);
  int wasted = 0;
  if (br->read(1)) {
    wasted = static_cast<int>(br->unary()) + 1;
    bps -= wasted;
  }
  if (bps <= 0) {
    *err = "invalid effective bps";
    return false;
  }

  if (sf_type == 0) {  // CONSTANT
    int64_t v = br->read_signed(bps);
    for (int i = 0; i < block_size; ++i) s[i] = v;
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) s[i] = br->read_signed(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED
    int order = sf_type & 7;
    for (int i = 0; i < order; ++i) s[i] = br->read_signed(bps);
    if (!decode_residual(br, block_size, order, s + order, err)) return false;
    const int* c = kFixedCoeffs[order];
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += c[j] * s[i - 1 - j];
      s[i] += acc;
    }
  } else if (sf_type >= 32) {  // LPC
    int order = (sf_type & 31) + 1;
    for (int i = 0; i < order; ++i) s[i] = br->read_signed(bps);
    int precision = static_cast<int>(br->read(4)) + 1;
    if (precision == 16) {
      *err = "invalid LPC precision";
      return false;
    }
    int shift = static_cast<int>(br->read_signed(5));
    int64_t coeffs[32];
    for (int i = 0; i < order; ++i) coeffs[i] = br->read_signed(precision);
    if (!decode_residual(br, block_size, order, s + order, err)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coeffs[j] * s[i - 1 - j];
      s[i] += acc >> shift;
    }
  } else {
    *err = "reserved subframe type";
    return false;
  }
  if (!br->ok) {
    *err = "truncated subframe";
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i) s[i] <<= wasted;
  return true;
}


struct Flac {
  int sample_rate = -1, channels = 0, bps = 0;
  std::vector<std::vector<int64_t>> chans;
  size_t frames = 0;
};

// The stream's samples per channel; false with *err on a malformed one.
bool decode_flac(const uint8_t* buf, size_t n, Flac* f, const char** err) {
  if (n < 8 || std::memcmp(buf, "fLaC", 4) != 0) {
    *err = "not a FLAC stream (missing fLaC marker)";
    return false;
  }
  uint64_t total = 0;
  size_t pos = 4;
  while (pos + 4 <= n) {  // metadata blocks
    bool last = buf[pos] >> 7;
    int btype = buf[pos] & 0x7F;
    uint32_t length = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) |
                      buf[pos + 3];
    if (btype == 0 && pos + 4 + 34 <= n) {  // STREAMINFO
      BitReader br(buf, n, pos + 4);
      br.read(16 + 16 + 24 + 24);
      f->sample_rate = static_cast<int>(br.read(20));
      f->channels = static_cast<int>(br.read(3)) + 1;
      f->bps = static_cast<int>(br.read(5)) + 1;
      total = br.read(36);
    }
    pos += 4 + length;
    if (last) break;
  }
  if (f->sample_rate < 0) {
    *err = "missing STREAMINFO";
    return false;
  }
  if (f->bps > 24) {
    *err = "32-bit FLAC not supported";
    return false;
  }
  const int channels = f->channels;
  auto& chans = f->chans;
  chans.resize(channels);
  if (total)
    for (auto& c : chans) c.reserve(total);
  uint64_t decoded = 0;
  BitReader br(buf, n, pos);
  std::vector<int64_t> sub[2];
  std::vector<std::vector<int64_t>> subs(channels);
  while (br.byte_pos() < n - 2 && !(total && decoded >= total)) {
    if (br.read(14) != 0x3FFE) {
      *err = "bad frame sync";
      return false;
    }
    br.read(2);  // reserved + blocking strategy
    unsigned bs_code = br.read(4);
    unsigned sr_code = br.read(4);
    unsigned chan_code = br.read(4);
    unsigned size_code = br.read(3);
    br.read(1);
    read_utf8_number(&br);
    int block_size;
    if (bs_code == 6)
      block_size = static_cast<int>(br.read(8)) + 1;
    else if (bs_code == 7)
      block_size = static_cast<int>(br.read(16)) + 1;
    else
      block_size = kBlockSizes[bs_code];
    if (block_size <= 0) {
      *err = "reserved block size";
      return false;
    }
    if (sr_code == 12)
      br.read(8);
    else if (sr_code == 13 || sr_code == 14)
      br.read(16);
    int frame_bps = kSampleSizes[size_code] ? kSampleSizes[size_code] : f->bps;
    br.read(8);  // header CRC-8 (unverified)

    if (chan_code < 8) {
      int nch = static_cast<int>(chan_code) + 1;
      if (nch != channels) {
        *err = "frame channel count != STREAMINFO";
        return false;
      }
      for (int c = 0; c < nch; ++c)
        if (!decode_subframe(&br, block_size, frame_bps, &subs[c], err))
          return false;
      for (int c = 0; c < nch; ++c)
        chans[c].insert(chans[c].end(), subs[c].begin(), subs[c].end());
    } else if (chan_code <= 10) {
      if (channels != 2) {
        *err = "decorrelated frame in non-stereo stream";
        return false;
      }
      int bps0 = frame_bps + (chan_code == 9 ? 1 : 0);
      int bps1 = frame_bps + (chan_code != 9 ? 1 : 0);
      if (!decode_subframe(&br, block_size, bps0, &sub[0], err)) return false;
      if (!decode_subframe(&br, block_size, bps1, &sub[1], err)) return false;
      for (int i = 0; i < block_size; ++i) {
        int64_t left, right;
        if (chan_code == 8) {  // left/side
          left = sub[0][i];
          right = left - sub[1][i];
        } else if (chan_code == 9) {  // side/right
          right = sub[1][i];
          left = right + sub[0][i];
        } else {  // mid/side
          int64_t mid = sub[0][i], side = sub[1][i];
          left = (((mid << 1) | (side & 1)) + side) >> 1;
          right = left - side;
        }
        chans[0].push_back(left);
        chans[1].push_back(right);
      }
    } else {
      *err = "reserved channel assignment";
      return false;
    }
    decoded += block_size;
    br.align();
    br.read(16);  // frame CRC-16 (unverified)
  }
  f->frames = chans.empty() ? 0 : chans[0].size();
  if (total && total < f->frames) f->frames = total;
  return true;
}

void flac_take(const Flac& f, bool mono, float* dst) {
  const size_t frames = f.frames;
  const int channels = f.channels;
  const size_t out_ch = (mono || channels == 1) ? 1 : channels;
  const float scale = 1.0f / static_cast<float>(1u << (f.bps - 1));
  if (mono && channels > 1) {
    const float inv = scale / static_cast<float>(channels);
    for (size_t i = 0; i < frames; ++i) {
      int64_t acc = 0;
      for (int c = 0; c < channels; ++c) acc += f.chans[c][i];
      dst[i] = static_cast<float>(acc) * inv;
    }
  } else {
    for (size_t c = 0; c < out_ch; ++c)
      for (size_t i = 0; i < frames; ++i)
        dst[c * frames + i] = static_cast<float>(f.chans[c][i]) * scale;
  }
}

struct Handle {
  bool flac = false, mono = false;
  WavInfo wav;
  size_t frames = 0;
  Flac decoded;
};

}  // namespace

extern "C" {

void* lassio_decode(const uint8_t* buf, int64_t n, int flac, int mono,
                    int64_t* shape, const char** err) {
  Handle* h = new Handle;
  h->flac = flac != 0;
  h->mono = mono != 0;
  const size_t len = static_cast<size_t>(n);
  int channels, rate;
  if (h->flac) {
    if (!decode_flac(buf, len, &h->decoded, err)) {
      delete h;
      return nullptr;
    }
    h->frames = h->decoded.frames;
    channels = h->decoded.channels;
    rate = h->decoded.sample_rate;
  } else {
    if (!parse_wav(buf, len, &h->wav, err)) {
      delete h;
      return nullptr;
    }
    if (!wav_supported(h->wav)) {
      *err = "unsupported WAVE encoding";
      delete h;
      return nullptr;
    }
    const size_t bytes_per = h->wav.bits / 8;
    h->frames = h->wav.data_size / (bytes_per * h->wav.channels);
    channels = h->wav.channels;
    rate = static_cast<int>(h->wav.sample_rate);
  }
  shape[0] = (h->mono || channels == 1) ? 1 : channels;
  shape[1] = static_cast<int64_t>(h->frames);
  shape[2] = rate;
  return h;
}

void lassio_take(void* handle, float* dst) {
  Handle* h = static_cast<Handle*>(handle);
  if (h->flac)
    flac_take(h->decoded, h->mono, dst);
  else
    wav_take(h->wav, h->mono, h->frames, dst);
  delete h;
}

}  // extern "C"
