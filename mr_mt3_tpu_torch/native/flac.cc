// Native FLAC codec (decoder + subset encoder).
//
// The Slakh dataset ships mixes as FLAC; this image has no FLAC tooling, so
// the framework carries its own. The decoder covers the full streamable
// subset used in practice: constant / verbatim / fixed(0-4) / LPC(1-32)
// subframes, all stereo decorrelation modes (left-side, right-side,
// mid-side), rice partitions with escapes, wasted bits, 8/16/24-bit depths.
// The encoder (independent or mid-side stereo, fixed or LPC predictors,
// rice partition order 0) exists so the decoder paths are testable without
// external files; it writes spec-correct CRCs so real decoders accept its
// output too.
//
// A copy of the JAX package's codec (mr_mt3_tpu/native/flac.cc). C API at
// the bottom; Python wrapper in mr_mt3_tpu_torch/native/flac.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------- bit reader ----------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed in current byte (0..7)
  bool error = false;

  bool eof() const { return byte_pos >= size; }

  // byte-at-a-time extraction: this reader sits on the serving path
  // parsing UNTRUSTED client FLAC, so a per-bit loop would be a ~10x
  // CPU amplifier on large rice/verbatim streams
  uint64_t bits(int n) {
    if (n < 0 || n > 64) { error = true; return 0; }
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { error = true; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      v = (v << take) |
          (uint64_t)((data[byte_pos] >> shift) & ((1u << take) - 1));
      bit_pos += take;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
      n -= take;
    }
    return v;
  }

  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n == 0) return 0;
    if (v & (1ULL << (n - 1))) return (int64_t)(v - (1ULL << n));
    return (int64_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!error) {
      if (byte_pos >= size) { error = true; break; }
      uint8_t cur = (uint8_t)(data[byte_pos] << bit_pos);
      if (cur == 0) {  // remaining bits of this byte are all zeros
        q += (uint32_t)(8 - bit_pos);
        bit_pos = 0;
        ++byte_pos;
      } else {
        int lz = 0;
        while (!(cur & 0x80)) { cur = (uint8_t)(cur << 1); ++lz; }
        q += (uint32_t)lz;
        bit_pos += lz + 1;  // the zeros plus the terminating 1
        if (bit_pos >= 8) { bit_pos -= 8; ++byte_pos; }
        break;
      }
      if (q > 1u << 24) { error = true; break; }
    }
    if (q > 1u << 24) error = true;
    return q;
  }

  void align() {
    if (bit_pos) { bit_pos = 0; ++byte_pos; }
  }
};

// ---------------- decoder ----------------

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits_per_sample = 0;
  uint64_t total_samples = 0;
  bool valid = false;
};

int64_t zigzag(uint64_t v) {
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

bool read_residual(BitReader& br, int block_size, int order,
                   std::vector<int64_t>& out) {
  uint32_t method = (uint32_t)br.bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = (uint32_t)br.bits(4);
  uint32_t parts = 1u << part_order;
  if (block_size % parts) return false;
  int samples_per_part = block_size >> part_order;
  for (uint32_t p = 0; p < parts; ++p) {
    int count = samples_per_part - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.bits(param_bits);
    if (param == escape) {
      uint32_t raw_bits = (uint32_t)br.bits(5);
      for (int i = 0; i < count; ++i)
        out.push_back(raw_bits ? br.sbits(raw_bits) : 0);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.unary();
        uint64_t r = br.bits(param);
        out.push_back(zigzag(((uint64_t)q << param) | r));
      }
    }
    if (br.error) return false;
  }
  return true;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// Wrap-safe signed ops (adversarial residual/coef values can overflow
// int64; unsigned arithmetic keeps that defined, and the final cast back
// is two's-complement on every supported target).
int64_t wrap_mul_add(int64_t acc, int64_t a, int64_t b) {
  return (int64_t)((uint64_t)acc + (uint64_t)a * (uint64_t)b);
}

int64_t wrap_add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // padding bit
  uint32_t type = (uint32_t)br.bits(6);
  uint32_t wasted = 0;
  if (br.bits(1)) wasted = br.unary() + 1;
  // spec: wasted bits are a property of samples that still have content;
  // wasted >= bps (or a huge unary run) only appears in corrupt streams
  if ((int)wasted >= bps || wasted > 32) return false;
  int eff_bps = bps - (int)wasted;
  out.clear();
  out.reserve(block_size);

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(eff_bps);
    out.assign(block_size, v);
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out.push_back(br.sbits(eff_bps));
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    int order = type - 8;
    for (int i = 0; i < order; ++i) out.push_back(br.sbits(eff_bps));
    std::vector<int64_t> residual;
    if (!read_residual(br, block_size, order, residual)) return false;
    const int* c = kFixedCoefs[order];
    for (size_t i = 0; i < residual.size(); ++i) {
      int64_t pred = 0;
      size_t n = out.size();
      for (int j = 0; j < order; ++j)
        pred = wrap_mul_add(pred, c[j], out[n - 1 - j]);
      out.push_back(wrap_add(residual[i], pred));
    }
  } else if (type >= 32) {  // LPC, order = type - 31
    int order = (int)type - 31;
    for (int i = 0; i < order; ++i) out.push_back(br.sbits(eff_bps));
    int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.sbits(precision);
    std::vector<int64_t> residual;
    if (!read_residual(br, block_size, order, residual)) return false;
    for (size_t i = 0; i < residual.size(); ++i) {
      int64_t pred = 0;
      size_t n = out.size();
      for (int j = 0; j < order; ++j)
        pred = wrap_mul_add(pred, coefs[j], out[n - 1 - j]);
      out.push_back(wrap_add(residual[i], pred >> shift));
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& v : out) v = (int64_t)((uint64_t)v << wasted);
  return !br.error;
}

uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = (uint32_t)br.bits(8);
  int extra = 0;
  uint64_t v;
  if ((b0 & 0x80) == 0) { return b0; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else { br.error = true; return 0; }
  for (int i = 0; i < extra; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
  return v;
}

const uint32_t kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0, 256,
                                  512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kSampleRates[12] = {0, 88200, 176400, 192000, 8000, 16000,
                                   22050, 24000, 32000, 44100, 48000, 96000};

struct DecodedAudio {
  std::vector<int32_t> samples;  // interleaved
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
};

bool decode_flac(const uint8_t* data, size_t size, DecodedAudio* out) {
  if (size < 8 || memcmp(data, "fLaC", 4)) return false;
  size_t pos = 4;
  StreamInfo info;
  bool last = false;
  while (!last && pos + 4 <= size) {
    uint8_t header = data[pos];
    last = header & 0x80;
    uint8_t type = header & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) |
                   data[pos + 3];
    pos += 4;
    if (pos + len > size) return false;
    if (type == 0 && len >= 34) {
      const uint8_t* b = data + pos;
      info.sample_rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4);
      info.channels = ((b[12] >> 1) & 0x7) + 1;
      info.bits_per_sample = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      info.total_samples = ((uint64_t)(b[13] & 0xF) << 32) |
                           ((uint64_t)b[14] << 24) | (b[15] << 16) |
                           (b[16] << 8) | b[17];
      info.valid = true;
    }
    pos += len;
  }
  if (!info.valid) return false;
  // STREAMINFO sanity: zero sample_rate / out-of-range depth only occur
  // in corrupt streams (and would divide-by-zero or misscale downstream)
  if (info.sample_rate == 0 || info.sample_rate > 655350) return false;
  if (info.bits_per_sample < 4 || info.bits_per_sample > 32) return false;

  // hard cap on decoded output: tiny adversarial inputs can otherwise
  // request ~3000 samples per input byte (constant subframes) and OOM the
  // host. 2^28 interleaved samples = 1 GiB of int32, ~2.2 h of 16 kHz
  // stereo — far beyond any real transcription request.
  const uint64_t kMaxSamples = 1ull << 28;

  out->sample_rate = info.sample_rate;
  out->channels = info.channels;
  out->bits = info.bits_per_sample;
  if (info.total_samples) {
    uint64_t want = info.total_samples * info.channels;
    if (want > kMaxSamples) return false;
    // reserve is only an optimization; a crafted STREAMINFO could claim
    // ~2^28 samples in a 50-byte stream, so cap the UP-FRONT allocation
    // (~64 MB) and let real decoded frames grow the vector beyond it —
    // growth stays bounded by kMaxSamples above
    out->samples.reserve(std::min<uint64_t>(want, 1ull << 24));
  }

  BitReader br{data, size};
  br.byte_pos = pos;

  std::vector<std::vector<int64_t>> chans(info.channels);
  while (true) {
    // find frame sync
    br.align();
    if (br.byte_pos + 2 > size) break;
    uint32_t sync = (uint32_t)br.bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return false;
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    uint32_t bs_code = (uint32_t)br.bits(4);
    uint32_t sr_code = (uint32_t)br.bits(4);
    uint32_t ch_code = (uint32_t)br.bits(4);
    uint32_t ss_code = (uint32_t)br.bits(3);
    br.bits(1);  // reserved
    read_utf8(br);  // frame/sample number
    uint32_t block_size;
    if (bs_code == 6) block_size = (uint32_t)br.bits(8) + 1;
    else if (bs_code == 7) block_size = (uint32_t)br.bits(16) + 1;
    else block_size = kBlockSizes[bs_code];
    if (!block_size) return false;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int bps = (int)info.bits_per_sample;
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      default: break;  // 0: from streaminfo
    }
    br.bits(8);  // header CRC-8

    int nch = info.channels;
    bool left_side = ch_code == 8, right_side = ch_code == 9,
         mid_side = ch_code == 10;
    if (ch_code <= 7) nch = (int)ch_code + 1;
    else if (ch_code <= 10) nch = 2;
    else return false;  // 11-15 reserved
    // every frame must match STREAMINFO's channel count (FLAC spec):
    // more would write past the per-channel buffers, fewer would
    // misalign the interleaved output for every later frame
    if (nch != (int)info.channels) return false;

    for (int c = 0; c < nch; ++c) {
      int sub_bps = bps;
      if ((left_side && c == 1) || (right_side && c == 0) ||
          (mid_side && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, (int)block_size, sub_bps, chans[c]))
        return false;
    }
    br.align();
    br.bits(16);  // frame CRC-16

    // stereo decorrelation (wrap-safe: garbage streams can hold values
    // near the int64 limits)
    if (left_side) {
      for (uint32_t i = 0; i < block_size; ++i)
        chans[1][i] = (int64_t)((uint64_t)chans[0][i] -
                                (uint64_t)chans[1][i]);
    } else if (right_side) {
      for (uint32_t i = 0; i < block_size; ++i)
        chans[0][i] = wrap_add(chans[1][i], chans[0][i]);
    } else if (mid_side) {
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t mid = chans[0][i], side = chans[1][i];
        mid = (int64_t)(((uint64_t)mid << 1) | ((uint64_t)side & 1));
        chans[0][i] = wrap_add(mid, side) >> 1;
        chans[1][i] = (int64_t)((uint64_t)mid - (uint64_t)side) >> 1;
      }
    }
    if (out->samples.size() + (uint64_t)block_size * nch > kMaxSamples)
      return false;  // output cap (see above)
    for (uint32_t i = 0; i < block_size; ++i)
      for (int c = 0; c < nch; ++c)
        out->samples.push_back((int32_t)chans[c][i]);

    if (info.total_samples &&
        out->samples.size() >= info.total_samples * info.channels)
      break;
    if (br.byte_pos >= size) break;
  }
  return true;
}

// ---------------- encoder (testing + prep subset) ----------------

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint8_t cur = 0;
  int nbits = 0;

  void bit(uint32_t b) {
    cur = (uint8_t)((cur << 1) | (b & 1));
    if (++nbits == 8) { bytes.push_back(cur); cur = 0; nbits = 0; }
  }
  void bits(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bit((uint32_t)(v >> i));
  }
  void align() { while (nbits) bit(0); }
};

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= d[i];
    for (int b = 0; b < 8; ++b)
      crc = (uint8_t)((crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; ++b)
      crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
  }
  return crc;
}

uint64_t zigzag_enc(int64_t v) {
  return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

void write_rice(BitWriter& bw, const std::vector<int64_t>& res) {
  // choose rice parameter from mean magnitude
  uint64_t total = 0;
  for (int64_t r : res) total += zigzag_enc(r);
  uint32_t param = 0;
  uint64_t mean = res.empty() ? 0 : total / res.size();
  while ((1ULL << (param + 1)) < mean + 1 && param < 14) ++param;
  bw.bits(0, 2);        // rice method 0
  bw.bits(0, 4);        // partition order 0
  bw.bits(param, 4);
  for (int64_t r : res) {
    uint64_t z = zigzag_enc(r);
    uint64_t q = z >> param;
    for (uint64_t i = 0; i < q; ++i) bw.bit(0);
    bw.bit(1);
    bw.bits(z & ((1ULL << param) - 1), param);
  }
}

void encode_channel(BitWriter& bw, const std::vector<int64_t>& x, int bps,
                    int force_mode /* -1 auto, 0-4 fixed, 100+o LPC */) {
  int n = (int)x.size();
  int order;
  bool use_lpc = false;
  std::vector<int64_t> qcoef;
  int qshift = 0, precision = 14;

  if (force_mode >= 100) {
    use_lpc = true;
    order = force_mode - 100;
  } else if (force_mode >= 0) {
    order = force_mode;
  } else {
    order = std::min(2, n);
  }
  // a block shorter than the analysis window cannot carry the forced
  // LPC order — fall back to a fixed predictor instead of indexing an
  // empty qcoef / reading warmup samples past the block
  if (use_lpc && n <= order * 2) {
    use_lpc = false;
    order = std::min(2, n);
  }
  // fixed predictors exist for orders 0-4 only, and the warmup must
  // fit the block (a forced order larger than the final short block
  // would read x[] out of bounds)
  if (!use_lpc) order = std::min(order, std::min(n, 4));

  if (use_lpc) {
    // autocorrelation + Levinson-Durbin
    std::vector<double> ac(order + 1, 0.0);
    for (int k = 0; k <= order; ++k)
      for (int i = k; i < n; ++i)
        ac[k] += (double)x[i] * (double)x[i - k];
    std::vector<double> lpc(order, 0.0);
    double err = ac[0];
    if (err <= 0) { use_lpc = false; order = std::min(2, n); }
    else {
      for (int i = 0; i < order; ++i) {
        double r = -ac[i + 1];
        for (int j = 0; j < i; ++j) r -= lpc[j] * ac[i - j];
        r /= err;
        lpc[i] = r;
        for (int j = 0; j < i / 2; ++j) {
          double tmp = lpc[j];
          lpc[j] += r * lpc[i - 1 - j];
          lpc[i - 1 - j] += r * tmp;
        }
        if (i & 1) lpc[i / 2] += lpc[i / 2] * r;
        err *= (1.0 - r * r);
      }
      // quantize (predictor uses -lpc)
      double cmax = 0;
      for (int i = 0; i < order; ++i) cmax = std::max(cmax, std::fabs(lpc[i]));
      if (cmax <= 0) { use_lpc = false; order = std::min(2, n); }
      else {
        int headroom = (int)std::floor(std::log2(cmax)) + 1;
        qshift = std::min(15, std::max(1, precision - 1 - headroom));
        qcoef.resize(order);
        for (int i = 0; i < order; ++i) {
          int64_t q = (int64_t)std::llround(-lpc[i] * (1 << qshift));
          int64_t lim = (1 << (precision - 1)) - 1;
          qcoef[i] = std::max(-lim - 1, std::min(lim, q));
        }
      }
    }
  }

  std::vector<int64_t> residual;
  if (use_lpc) {
    bw.bits(0, 1);
    bw.bits(32 + order - 1, 6);
    bw.bits(0, 1);  // no wasted bits
    for (int i = 0; i < order; ++i) bw.bits((uint64_t)x[i] & ((1ULL << bps) - 1), bps);
    bw.bits(precision - 1, 4);
    bw.bits((uint64_t)qshift & 0x1F, 5);
    for (int i = 0; i < order; ++i)
      bw.bits((uint64_t)qcoef[i] & ((1ULL << precision) - 1), precision);
    for (int i = order; i < n; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += qcoef[j] * x[i - 1 - j];
      residual.push_back(x[i] - (pred >> qshift));
    }
  } else {
    bw.bits(0, 1);
    bw.bits(8 + order, 6);
    bw.bits(0, 1);  // no wasted bits
    const int* c = kFixedCoefs[order];
    for (int i = 0; i < order; ++i) bw.bits((uint64_t)x[i] & ((1ULL << bps) - 1), bps);
    for (int i = order; i < n; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += c[j] * x[i - 1 - j];
      residual.push_back(x[i] - pred);
    }
  }
  write_rice(bw, residual);
}

std::vector<uint8_t> encode_flac(const int32_t* samples, int64_t n_frames,
                                 int channels, int sample_rate, int bps,
                                 int force_mode, bool mid_side) {
  std::vector<uint8_t> out;
  out.insert(out.end(), {'f', 'L', 'a', 'C'});
  // STREAMINFO (last metadata block)
  uint8_t si[38] = {};
  si[0] = 0x80;  // last, type 0
  si[3] = 34;
  const uint32_t kBlock = 4096;
  si[4] = kBlock >> 8; si[5] = kBlock & 0xFF;
  si[6] = kBlock >> 8; si[7] = kBlock & 0xFF;
  si[14] = (uint8_t)(sample_rate >> 12);
  si[15] = (uint8_t)(sample_rate >> 4);
  si[16] = (uint8_t)(((sample_rate & 0xF) << 4) | (((channels - 1) & 0x7) << 1) |
                     (((bps - 1) >> 4) & 1));
  si[17] = (uint8_t)((((bps - 1) & 0xF) << 4) | ((n_frames >> 32) & 0xF));
  si[18] = (uint8_t)(n_frames >> 24);
  si[19] = (uint8_t)(n_frames >> 16);
  si[20] = (uint8_t)(n_frames >> 8);
  si[21] = (uint8_t)(n_frames);
  out.insert(out.end(), si, si + 38);

  int64_t pos = 0;
  uint64_t frame_idx = 0;
  while (pos < n_frames) {
    int block = (int)std::min<int64_t>(kBlock, n_frames - pos);
    BitWriter bw;
    bw.bits(0x3FFE, 14);
    bw.bits(0, 1);
    bw.bits(0, 1);  // fixed blocksize strategy, frame number coding
    bw.bits(7, 4);  // block size: 16-bit at end of header
    uint32_t sr_code = 0;
    for (uint32_t i = 1; i < 12; ++i)
      if (kSampleRates[i] == (uint32_t)sample_rate) sr_code = i;
    bw.bits(sr_code ? sr_code : 14, 4);  // else 16-bit sr at end (in 10s of Hz? use code 14: 16-bit Hz/10... avoid)
    uint32_t ch_code = mid_side && channels == 2 ? 10 : (uint32_t)(channels - 1);
    bw.bits(ch_code, 4);
    uint32_t ss_code = bps == 8 ? 1 : bps == 16 ? 4 : bps == 24 ? 6 : 0;
    bw.bits(ss_code, 3);
    bw.bits(0, 1);
    // frame number, UTF-8 (3- and 4-byte forms matter: frame 2048 of a
    // long file would otherwise write 0xE0 as a 2-byte lead, which the
    // decoder parses as a 3-byte sequence and desyncs)
    if (frame_idx < 0x80) {
      bw.bits(frame_idx, 8);
    } else if (frame_idx < 0x800) {
      bw.bits(0xC0 | (frame_idx >> 6), 8);
      bw.bits(0x80 | (frame_idx & 0x3F), 8);
    } else if (frame_idx < 0x10000) {
      bw.bits(0xE0 | (frame_idx >> 12), 8);
      bw.bits(0x80 | ((frame_idx >> 6) & 0x3F), 8);
      bw.bits(0x80 | (frame_idx & 0x3F), 8);
    } else {
      bw.bits(0xF0 | (frame_idx >> 18), 8);
      bw.bits(0x80 | ((frame_idx >> 12) & 0x3F), 8);
      bw.bits(0x80 | ((frame_idx >> 6) & 0x3F), 8);
      bw.bits(0x80 | (frame_idx & 0x3F), 8);
    }
    bw.bits((uint64_t)block - 1, 16);
    if (!sr_code) bw.bits((uint64_t)sample_rate / 10, 16);
    bw.align();
    uint8_t c8 = crc8(bw.bytes.data(), bw.bytes.size());
    bw.bits(c8, 8);

    if (ch_code == 10) {
      std::vector<int64_t> mid(block), side(block);
      for (int i = 0; i < block; ++i) {
        int64_t l = samples[(pos + i) * channels];
        int64_t r = samples[(pos + i) * channels + 1];
        mid[i] = (l + r) >> 1;
        side[i] = l - r;
      }
      encode_channel(bw, mid, bps, force_mode);
      encode_channel(bw, side, bps + 1, force_mode);
    } else {
      for (int c = 0; c < channels; ++c) {
        std::vector<int64_t> x(block);
        for (int i = 0; i < block; ++i)
          x[i] = samples[(pos + i) * channels + c];
        encode_channel(bw, x, bps, force_mode);
      }
    }
    bw.align();
    uint16_t c16 = crc16(bw.bytes.data(), bw.bytes.size());
    bw.bits(c16, 16);
    out.insert(out.end(), bw.bytes.begin(), bw.bytes.end());
    pos += block;
    ++frame_idx;
  }
  return out;
}

}  // namespace

// ---------------- C API ----------------

extern "C" {

struct FlacAudio {
  int32_t* samples;
  int64_t n_samples;  // total interleaved values
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
};

int mt3_flac_decode(const uint8_t* data, int64_t size, FlacAudio* out) {
  // never let an exception (bad_alloc on adversarial sizes) cross the C
  // boundary into ctypes — report failure instead
  try {
    DecodedAudio audio;
    if (size < 0 || !decode_flac(data, (size_t)size, &audio)) return -1;
    out->n_samples = (int64_t)audio.samples.size();
    out->samples = new int32_t[audio.samples.size()];
    std::copy(audio.samples.begin(), audio.samples.end(), out->samples);
    out->sample_rate = (int32_t)audio.sample_rate;
    out->channels = (int32_t)audio.channels;
    out->bits = (int32_t)audio.bits;
    return 0;
  } catch (...) {
    return -1;
  }
}

void mt3_flac_free(FlacAudio* a) {
  delete[] a->samples;
  a->samples = nullptr;
}

struct FlacBytes {
  uint8_t* data;
  int64_t size;
};

int mt3_flac_encode(const int32_t* samples, int64_t n_frames,
                    int32_t channels, int32_t sample_rate, int32_t bps,
                    int32_t force_mode, int32_t mid_side, FlacBytes* out) {
  // same invariant as mt3_flac_decode: an exception unwinding through
  // the C ABI into ctypes is UB (in practice std::terminate)
  try {
    auto bytes = encode_flac(samples, n_frames, channels, sample_rate, bps,
                             force_mode, mid_side != 0);
    out->size = (int64_t)bytes.size();
    out->data = new uint8_t[bytes.size()];
    std::copy(bytes.begin(), bytes.end(), out->data);
    return 0;
  } catch (...) {
    return -1;
  }
}

void mt3_flac_bytes_free(FlacBytes* b) {
  delete[] b->data;
  b->data = nullptr;
}

}  // extern "C"
