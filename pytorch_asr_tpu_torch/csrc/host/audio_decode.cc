// Host audio decoders of the port: WAV and FLAC to float32 mono, one file
// or a batch on a pool of threads.  The port's copy of the JAX package's
// native WAV and FLAC readers, built at first use with the host compiler
// (g++ -O3 -fPIC -std=c++17 -pthread -shared) and bound with ctypes by
// pytorch_asr_tpu_torch/native.py.
//
// The samples equal the numpy readers' (data/librispeech.py::read_wav,
// data/flac.py::read_flac) bit for bit: each channel is scaled in float32
// as numpy scales it, and channels are summed in float32 in order and
// divided by their count, as numpy's float32 mean does.
//
// The FLAC decoder covers CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32)
// subframes, RICE / RICE2 partitioned residuals with escapes, wasted bits,
// all four channel assignments, 8-32 bit samples, fixed and variable
// blocking, and checks every frame's CRC-8 and CRC-16.
//
// Every entry returns 0 on success and writes the file's full sample count
// to *n_samples, even when it is more than max_samples; only the first
// max_samples samples are written, so a caller can retry with a larger
// buffer.  The batch entries write rc[i] per file.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace flacdec {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;
  bool bad = false;

  uint64_t read(int n) {
    uint64_t out = 0;
    while (n > 0) {
      if (byte >= size) { bad = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      out = (out << take) | ((data[byte] >> (avail - take)) & ((1u << take) - 1));
      bit += take;
      n -= take;
      if (bit == 8) { bit = 0; byte++; }
    }
    return out;
  }
  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }
  int read_unary() {
    int q = 0;
    while (!bad && read(1) == 0) q++;
    return q;
  }
  void align() { if (bit) { bit = 0; byte++; } }
  int64_t read_utf8() {
    uint32_t b0 = (uint32_t)read(8);
    if (b0 < 0x80) return b0;
    int n = 0;
    for (uint32_t m = 0x80; b0 & m; m >>= 1) n++;
    if (n < 2 || n > 7) { bad = true; return -1; }
    int64_t v = b0 & (0xFFu >> (n + 1));
    for (int i = 0; i < n - 1; i++) {
      uint32_t c = (uint32_t)read(8);
      if ((c & 0xC0u) != 0x80u) { bad = true; return -1; }
      v = (v << 6) | (c & 0x3F);
    }
    return v;
  }
};

inline uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= p[i];
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

inline uint16_t crc16(const uint8_t* p, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= (uint16_t)(p[i] << 8);
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
  }
  return crc;
}

static const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// residual into res[0:blocksize-order]; false on malformed stream
bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& res) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1;
  int po = (int)br.read(4);
  int nparts = 1 << po;
  if (blocksize % nparts) return false;
  if (po > 0 && (blocksize >> po) <= order) return false;
  if ((blocksize >> po) < order) return false;
  res.clear();
  res.reserve(blocksize - order);
  for (int p = 0; p < nparts; p++) {
    int count = (blocksize >> po) - (p == 0 ? order : 0);
    uint32_t param = (uint32_t)br.read(plen);
    if (param == escape) {
      int bits = (int)br.read(5);
      for (int i = 0; i < count; i++)
        res.push_back(bits ? br.read_signed(bits) : 0);
    } else {
      for (int i = 0; i < count; i++) {
        uint64_t q = (uint64_t)br.read_unary();
        uint64_t r = param ? br.read(param) : 0;
        uint64_t v = (q << param) | r;
        res.push_back((int64_t)(v >> 1) ^ -(int64_t)(v & 1));  // zigzag
      }
    }
    if (br.bad) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read(1)) return false;                       // padding bit
  int t = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = 1 + br.read_unary();
  int eff = bps - wasted;
  if (eff <= 0 || br.bad) return false;
  out.clear();
  out.reserve(blocksize);
  std::vector<int64_t> res;
  if (t == 0) {                                       // CONSTANT
    int64_t v = br.read_signed(eff);
    out.assign(blocksize, v);
  } else if (t == 1) {                                // VERBATIM
    for (int i = 0; i < blocksize; i++) out.push_back(br.read_signed(eff));
  } else if (t >= 8 && t <= 12) {                     // FIXED
    int order = t - 8;
    for (int i = 0; i < order; i++) out.push_back(br.read_signed(eff));
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++)
        pred += (int64_t)kFixedCoeffs[order][j] * out[i - 1 - j];
      out.push_back(res[i - order] + pred);
    }
  } else if (t >= 32) {                               // LPC
    int order = t - 31;
    for (int i = 0; i < order; i++) out.push_back(br.read_signed(eff));
    int prec = (int)br.read(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; i++) coefs[i] = br.read_signed(prec);
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coefs[j] * out[i - 1 - j];
      out.push_back(res[i - order] + (acc >> shift));
    }
  } else {
    return false;                                     // reserved
  }
  if (br.bad) return false;
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return true;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total = 0;
};

// (blocksize, channels) samples appended per-channel; false on error
bool decode_frame(BitReader& br, const StreamInfo& si,
                  std::vector<std::vector<int64_t>>& chans, int* out_bs) {
  size_t start = br.byte;
  if (br.read(14) != 0x3FFE) return false;
  if (br.read(1)) return false;
  br.read(1);                                         // blocking strategy
  int bs_code = (int)br.read(4);
  int sr_code = (int)br.read(4);
  int ch_code = (int)br.read(4);
  int ss_code = (int)br.read(3);
  if (br.read(1)) return false;
  br.read_utf8();
  int blocksize;
  if (bs_code == 0) return false;
  else if (bs_code == 1) blocksize = 192;
  else if (bs_code <= 5) blocksize = 576 << (bs_code - 2);
  else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
  else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
  else blocksize = 256 << (bs_code - 8);
  if (sr_code == 12) br.read(8);
  else if (sr_code == 13 || sr_code == 14) br.read(16);
  else if (sr_code == 15) return false;
  static const int ss_map[8] = {0, 8, 12, -1, 16, 20, 24, 32};
  int bps = ss_code == 0 ? si.bps : ss_map[ss_code];
  if (bps <= 0) return false;
  br.align();
  if (br.bad) return false;
  uint8_t hdr_crc = (uint8_t)br.read(8);
  if (crc8(br.data + start, br.byte - 1 - start) != hdr_crc) return false;

  int nch = ch_code <= 7 ? ch_code + 1 : 2;
  if (nch != si.channels) return false;        // frame vs STREAMINFO mismatch
  if ((int)chans.size() < nch) chans.resize(nch);
  std::vector<int64_t> a, b;
  if (ch_code <= 7) {
    for (int c = 0; c < nch; c++) {
      if (!decode_subframe(br, blocksize, bps, a)) return false;
      chans[c].insert(chans[c].end(), a.begin(), a.end());
    }
  } else if (ch_code == 8) {                          // left/side
    if (!decode_subframe(br, blocksize, bps, a)) return false;
    if (!decode_subframe(br, blocksize, bps + 1, b)) return false;
    for (int i = 0; i < blocksize; i++) {
      chans[0].push_back(a[i]);
      chans[1].push_back(a[i] - b[i]);
    }
  } else if (ch_code == 9) {                          // right/side
    if (!decode_subframe(br, blocksize, bps + 1, a)) return false;
    if (!decode_subframe(br, blocksize, bps, b)) return false;
    for (int i = 0; i < blocksize; i++) {
      chans[0].push_back(a[i] + b[i]);
      chans[1].push_back(b[i]);
    }
  } else if (ch_code == 10) {                         // mid/side
    if (!decode_subframe(br, blocksize, bps, a)) return false;
    if (!decode_subframe(br, blocksize, bps + 1, b)) return false;
    for (int i = 0; i < blocksize; i++) {
      int64_t m2 = (a[i] << 1) | (b[i] & 1);
      chans[0].push_back((m2 + b[i]) >> 1);
      chans[1].push_back((m2 - b[i]) >> 1);
    }
  } else {
    return false;
  }
  br.align();
  if (br.bad) return false;
  uint16_t frame_crc = (uint16_t)br.read(16);
  if (crc16(br.data + start, br.byte - 2 - start) != frame_crc) return false;
  *out_bs = blocksize;
  return !br.bad;
}

}  // namespace flacdec


namespace {

// One WAV sample of one channel as numpy's read_wav scales it (float32).
bool wav_sample(const uint8_t* p, int fmt_code, int bits, float* v) {
  if (fmt_code == 3 && bits == 32) {          // IEEE float
    memcpy(v, p, 4);
  } else if (bits == 16) {
    int16_t s;
    memcpy(&s, p, 2);
    *v = (float)s / 32768.0f;
  } else if (bits == 32) {
    int32_t s;
    memcpy(&s, p, 4);
    *v = (float)s / 2147483648.0f;
  } else if (bits == 24) {
    int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
    *v = (float)(s >> 8) / 8388608.0f;
  } else if (bits == 8) {
    *v = ((float)p[0] - 128.0f) / 128.0f;
  } else {
    return false;
  }
  return true;
}

template <typename Fn>
void run_batch(int32_t n, int32_t n_threads, Fn fn) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  int32_t nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace


extern "C" {

int audio_read_wav(const char* path, float* out, int64_t max_samples,
                   int64_t* n_samples, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  auto fail = [&](int code) { fclose(f); return code; };

  char riff[4];
  uint32_t riff_size;
  char wave[4];
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
      fread(&riff_size, 4, 1, f) != 1 || fread(wave, 1, 4, f) != 4 ||
      memcmp(wave, "WAVE", 4))
    return fail(2);

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  bool got_fmt = false;
  while (true) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) return fail(3);
    if (!memcmp(id, "fmt ", 4)) {
      uint16_t block_align;
      uint32_t byte_rate;
      if (fread(&fmt_code, 2, 1, f) != 1 || fread(&channels, 2, 1, f) != 1 ||
          fread(&rate, 4, 1, f) != 1 || fread(&byte_rate, 4, 1, f) != 1 ||
          fread(&block_align, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1)
        return fail(4);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
      got_fmt = true;
    } else if (!memcmp(id, "data", 4)) {
      if (!got_fmt || channels == 0 || bits < 8) return fail(5);
      int64_t bytes_per = bits / 8;
      int64_t frames = size / (bytes_per * channels);
      int64_t n = std::min<int64_t>(frames, max_samples);
      std::vector<uint8_t> buf(size);
      if (fread(buf.data(), 1, size, f) != size) return fail(6);
      for (int64_t i = 0; i < n; i++) {
        float acc = 0.0f;
        for (int c = 0; c < channels; c++) {
          float v;
          if (!wav_sample(buf.data() + (i * channels + c) * bytes_per, fmt_code,
                          bits, &v))
            return fail(7);
          acc = c ? acc + v : v;
        }
        out[i] = channels > 1 ? acc / (float)channels : acc;
      }
      *n_samples = frames;
      *sample_rate = (int32_t)rate;
      fclose(f);
      return 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

void audio_read_wav_batch(const char** paths, int32_t n, float* out,
                          int64_t max_samples, int64_t* n_samples,
                          int32_t* rates, int32_t* rc, int32_t n_threads) {
  run_batch(n, n_threads, [&](int32_t i) {
    rc[i] = audio_read_wav(paths[i], out + (int64_t)i * max_samples, max_samples,
                           &n_samples[i], &rates[i]);
  });
}

int audio_read_flac(const char* path, float* out, int64_t max_samples,
                    int64_t* n_samples, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize > 0 ? (size_t)fsize : 0);
  if (fsize <= 8 || fread(data.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return 2;
  }
  fclose(f);
  if (memcmp(data.data(), "fLaC", 4)) return 3;

  flacdec::StreamInfo si;
  size_t pos = 4;
  bool have_si = false;
  while (true) {
    if (pos + 4 > data.size()) return 4;
    bool last = data[pos] & 0x80;
    int btype = data[pos] & 0x7F;
    uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                   ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    if (pos + 4 + len > data.size()) return 4;
    if (btype == 0) {
      if (len < 34) return 5;
      flacdec::BitReader br{data.data() + pos + 4, len};
      br.read(16); br.read(16); br.read(24); br.read(24);
      si.sample_rate = (uint32_t)br.read(20);
      si.channels = (int)br.read(3) + 1;
      si.bps = (int)br.read(5) + 1;
      si.total = br.read(36);
      have_si = true;
    }
    pos += 4 + len;
    if (last) break;
  }
  if (!have_si) return 5;

  flacdec::BitReader br{data.data(), data.size()};
  br.byte = pos;
  std::vector<std::vector<int64_t>> chans;
  uint64_t got = 0;
  while ((si.total == 0 || got < si.total) && br.byte < br.size) {
    int bs = 0;
    if (!flacdec::decode_frame(br, si, chans, &bs)) return 6;
    got += (uint64_t)bs;
  }
  *sample_rate = (int32_t)si.sample_rate;
  int nch = (int)chans.size();
  if (nch == 0) { *n_samples = 0; return 0; }
  int64_t total = (int64_t)chans[0].size();
  if (si.total) total = std::min<int64_t>(total, (int64_t)si.total);
  int64_t n = std::min(total, max_samples);
  // numpy: pcm.astype(float32) / float(1 << (bps - 1)), then the float32
  // mean over channels.
  float scale = (float)((int64_t)1 << (si.bps - 1));
  for (int64_t i = 0; i < n; i++) {
    float acc = 0.0f;
    for (int c = 0; c < nch; c++) {
      float v = (float)(int32_t)chans[c][i] / scale;
      acc = c ? acc + v : v;
    }
    out[i] = nch > 1 ? acc / (float)nch : acc;
  }
  *n_samples = total;
  return 0;
}

void audio_read_flac_batch(const char** paths, int32_t n, float* out,
                           int64_t max_samples, int64_t* n_samples,
                           int32_t* rates, int32_t* rc, int32_t n_threads) {
  run_batch(n, n_threads, [&](int32_t i) {
    rc[i] = audio_read_flac(paths[i], out + (int64_t)i * max_samples, max_samples,
                            &n_samples[i], &rates[i]);
  });
}

}  // extern "C"
