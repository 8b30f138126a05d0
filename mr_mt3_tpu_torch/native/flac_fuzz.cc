// Deterministic fuzzer for the FLAC decoder (built with ASan/UBSan by
// mr_mt3_tpu_torch/native/flac.py::build_flac_fuzz). The decoder is the one
// place this framework parses UNTRUSTED input in C++ (mr_mt3_tpu_torch/serve.py
// accepts client FLAC bytes), so it must never crash, overflow, or OOM on
// malformed data — only return -1.
//
// Strategy: encode a pool of valid seed streams with the in-repo encoder
// (covering mono/stereo, 8/16/24-bit, fixed + LPC predictors, mid-side),
// then run N deterministic mutations — bit flips, byte stomps, splices,
// truncations, extensions, and fully random buffers — through
// mt3_flac_decode. Any sanitizer report aborts with a nonzero exit.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
struct FlacAudio {
  int32_t* samples;
  int64_t n_samples;
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
};
struct FlacBytes {
  uint8_t* data;
  int64_t size;
};
int mt3_flac_decode(const uint8_t* data, int64_t size, FlacAudio* out);
void mt3_flac_free(FlacAudio* a);
int mt3_flac_encode(const int32_t* samples, int64_t n_frames,
                    int32_t channels, int32_t sample_rate, int32_t bps,
                    int32_t force_mode, int32_t mid_side, FlacBytes* out);
void mt3_flac_bytes_free(FlacBytes* b);
}

namespace {

struct Rng {  // xorshift64*, fixed seed -> reproducible runs
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

std::vector<uint8_t> make_seed(int channels, int bps, int force_mode,
                               bool mid_side, int kind) {
  const int n = 6000;
  std::vector<int32_t> samples(n * channels);
  int32_t amp = (1 << (bps - 2)) - 1;
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < channels; ++c) {
      double v;
      if (kind == 0)
        v = std::sin(i * (0.02 + 0.01 * c));
      else if (kind == 1)
        v = ((i * 2654435761u + c * 40503u) % 1000) / 500.0 - 1.0;
      else
        v = (i % 256 < 128) ? 0.7 : -0.7;  // square
      samples[i * channels + c] = (int32_t)(v * amp);
    }
  FlacBytes out{};
  if (mt3_flac_encode(samples.data(), n, channels, 16000, bps, force_mode,
                      mid_side ? 1 : 0, &out) != 0) {
    std::fprintf(stderr, "seed encode failed\n");
    std::exit(2);
  }
  std::vector<uint8_t> bytes(out.data, out.data + out.size);
  mt3_flac_bytes_free(&out);
  return bytes;
}

void run_one(const std::vector<uint8_t>& buf) {
  FlacAudio audio{};
  if (mt3_flac_decode(buf.data(), (int64_t)buf.size(), &audio) == 0)
    mt3_flac_free(&audio);
}

}  // namespace

int main(int argc, char** argv) {
  long iterations = argc > 1 ? std::atol(argv[1]) : 5000;
  Rng rng(argc > 2 ? std::strtoull(argv[2], nullptr, 10) : 1234567);

  std::vector<std::vector<uint8_t>> seeds;
  for (int kind = 0; kind < 3; ++kind) {
    seeds.push_back(make_seed(1, 16, -1, false, kind));
    seeds.push_back(make_seed(2, 16, -1, true, kind));
  }
  seeds.push_back(make_seed(1, 8, 2, false, 0));
  seeds.push_back(make_seed(2, 24, 104, false, 1));  // LPC order 4
  seeds.push_back(make_seed(2, 16, 100 + 8, true, 2));

  for (const auto& s : seeds) run_one(s);  // clean seeds must decode

  for (long it = 0; it < iterations; ++it) {
    std::vector<uint8_t> buf;
    uint32_t mode = (uint32_t)rng.below(16);
    if (mode == 0) {
      // fully random buffer (often not even fLaC-magic)
      buf.resize(rng.below(4096) + 1);
      for (auto& b : buf) b = (uint8_t)rng.next();
      if (buf.size() >= 4 && rng.below(2))
        std::memcpy(buf.data(), "fLaC", 4);
    } else {
      buf = seeds[rng.below(seeds.size())];
      uint32_t n_mut = 1 + (uint32_t)rng.below(32);
      for (uint32_t m = 0; m < n_mut; ++m) {
        switch (rng.below(5)) {
          case 0:  // bit flip
            buf[rng.below(buf.size())] ^= (uint8_t)(1u << rng.below(8));
            break;
          case 1:  // byte stomp
            buf[rng.below(buf.size())] = (uint8_t)rng.next();
            break;
          case 2: {  // splice a chunk from another seed
            const auto& other = seeds[rng.below(seeds.size())];
            size_t dst = rng.below(buf.size());
            size_t src = rng.below(other.size());
            size_t len = rng.below(64) + 1;
            for (size_t i = 0; i < len && dst + i < buf.size() &&
                               src + i < other.size();
                 ++i)
              buf[dst + i] = other[src + i];
            break;
          }
          case 3:  // truncate
            buf.resize(rng.below(buf.size()) + 1);
            break;
          case 4: {  // extend with noise
            size_t extra = rng.below(256) + 1;
            for (size_t i = 0; i < extra; ++i)
              buf.push_back((uint8_t)rng.next());
            break;
          }
        }
      }
    }
    run_one(buf);
  }
  std::printf("fuzz ok: %ld iterations, %zu seeds\n", iterations,
              seeds.size());
  return 0;
}
