// First-party native WAV I/O for the host-side data path.
//
// The reference delegates audio I/O to torchaudio's C++ backends
// (SURVEY §2c); this is the framework's own native equivalent: a
// dependency-free RIFF/WAVE reader/writer compiled to a shared library
// and bound via ctypes (audiocodecs_tpu/native/wavio.py). Handles PCM
// 8/16/24/32-bit and IEEE float32, including WAVE_FORMAT_EXTENSIBLE
// headers and unaligned/odd-sized chunks. Decoding int->float runs here
// (tight loops over the sample buffer) instead of numpy — one pass, no
// intermediate allocations.
//
// C API (stable, minimal):
//   wavio_read(path, &data, &frames, &channels, &sample_rate) -> 0/err
//     data: malloc'd interleaved float32 [frames*channels], caller frees
//     with wavio_free.
//   wavio_write(path, data, frames, channels, sample_rate, bits) -> 0/err
//     bits in {16, 32}; 32 writes IEEE float.
//   wavio_error() -> thread-local message for the last failure.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

thread_local char g_error[256] = {0};

int fail(const char* msg, const char* detail = nullptr) {
  if (detail) {
    snprintf(g_error, sizeof(g_error), "%s: %s", msg, detail);
  } else {
    snprintf(g_error, sizeof(g_error), "%s", msg);
  }
  return 1;
}

struct Reader {
  FILE* f;
  explicit Reader(FILE* file) : f(file) {}
  bool read(void* dst, size_t n) { return fread(dst, 1, n, f) == n; }
  bool skip(long n) { return fseek(f, n, SEEK_CUR) == 0; }
  uint32_t u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
  }
  uint16_t u16(const uint8_t* p) {
    return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
  }
};

constexpr uint16_t kFormatPCM = 1;
constexpr uint16_t kFormatFloat = 3;
constexpr uint16_t kFormatExtensible = 0xFFFE;

}  // namespace

extern "C" {

const char* wavio_error() { return g_error; }

void wavio_free(float* p) { free(p); }

int wavio_read(const char* path, float** out, int64_t* frames,
               int32_t* channels, int32_t* sample_rate) {
  *out = nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return fail("cannot open", path);
  Reader r(f);

  uint8_t hdr[12];
  if (!r.read(hdr, 12) || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return fail("not a RIFF/WAVE file", path);
  }

  uint16_t fmt = 0, nch = 0, bits = 0;
  uint32_t rate = 0;
  bool have_fmt = false;
  uint8_t* raw = nullptr;
  uint64_t data_bytes = 0;

  uint8_t chdr[8];
  while (r.read(chdr, 8)) {
    uint32_t size = r.u32(chdr + 4);
    if (memcmp(chdr, "fmt ", 4) == 0) {
      if (size < 16 || size > 512) {
        fclose(f);
        return fail("bad fmt chunk size");
      }
      uint8_t buf[512];
      if (!r.read(buf, size)) {
        fclose(f);
        return fail("truncated fmt chunk");
      }
      fmt = r.u16(buf);
      nch = r.u16(buf + 2);
      rate = r.u32(buf + 4);
      bits = r.u16(buf + 14);
      if (fmt == kFormatExtensible && size >= 40) {
        // subformat GUID: first two bytes carry the real format tag
        fmt = r.u16(buf + 24);
      }
      have_fmt = true;
    } else if (memcmp(chdr, "data", 4) == 0) {
      raw = (uint8_t*)malloc(size ? size : 1);
      if (!raw) {
        fclose(f);
        return fail("out of memory for data chunk");
      }
      // tolerate writers that over-declare the chunk size, but clamp to
      // the bytes actually present — decoding past the short read would
      // turn uninitialized heap into "audio"
      data_bytes = fread(raw, 1, size, f);
    } else {
      if (!r.skip((long)size)) break;
    }
    if (size & 1) r.skip(1);  // chunks are word-aligned
    if (have_fmt && raw) break;
  }
  fclose(f);

  if (!have_fmt || !raw) {
    free(raw);
    return fail("missing fmt or data chunk", path);
  }
  if (nch == 0 || rate == 0) {
    free(raw);
    return fail("bad channel count or sample rate");
  }
  if (!((fmt == kFormatPCM && (bits == 8 || bits == 16 || bits == 24 ||
                               bits == 32)) ||
        (fmt == kFormatFloat && bits == 32))) {
    free(raw);
    return fail("unsupported format (need PCM 8/16/24/32 or float32)");
  }

  const uint64_t bytes_per = (uint64_t)(bits / 8) * nch;
  const int64_t n = (int64_t)(data_bytes / bytes_per);
  const int64_t total = n * nch;
  float* data = (float*)malloc(sizeof(float) * (total ? total : 1));
  if (!data) {
    free(raw);
    return fail("out of memory for samples");
  }

  if (fmt == kFormatFloat) {
    memcpy(data, raw, sizeof(float) * total);
  } else if (bits == 16) {
    const int16_t* s = (const int16_t*)raw;
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < total; ++i) data[i] = s[i] * k;
  } else if (bits == 32) {
    const int32_t* s = (const int32_t*)raw;
    constexpr float k = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < total; ++i) data[i] = s[i] * k;
  } else if (bits == 24) {
    constexpr float k = 1.0f / 8388608.0f;
    const uint8_t* p = raw;
    for (int64_t i = 0; i < total; ++i, p += 3) {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      data[i] = v * k;
    }
  } else {  // 8-bit unsigned
    constexpr float k = 1.0f / 128.0f;
    for (int64_t i = 0; i < total; ++i) data[i] = ((int)raw[i] - 128) * k;
  }
  free(raw);

  *out = data;
  *frames = n;
  *channels = (int32_t)nch;
  *sample_rate = (int32_t)rate;
  return 0;
}

int wavio_write(const char* path, const float* data, int64_t frames,
                int32_t channels, int32_t sample_rate, int32_t bits) {
  if (bits != 16 && bits != 32) return fail("bits must be 16 or 32");
  if (channels <= 0 || frames < 0) return fail("bad shape");
  FILE* f = fopen(path, "wb");
  if (!f) return fail("cannot open for write", path);

  const uint16_t fmt = (bits == 32) ? kFormatFloat : kFormatPCM;
  const uint32_t byte_rate = (uint32_t)sample_rate * channels * (bits / 8);
  const uint16_t block = (uint16_t)(channels * (bits / 8));
  const uint32_t data_size = (uint32_t)(frames * channels * (bits / 8));
  const uint32_t riff_size = 36 + data_size;

  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  auto w32 = [&](int off, uint32_t v) {
    hdr[off] = v & 0xFF;
    hdr[off + 1] = (v >> 8) & 0xFF;
    hdr[off + 2] = (v >> 16) & 0xFF;
    hdr[off + 3] = (v >> 24) & 0xFF;
  };
  auto w16 = [&](int off, uint16_t v) {
    hdr[off] = v & 0xFF;
    hdr[off + 1] = (v >> 8) & 0xFF;
  };
  w32(4, riff_size);
  w32(16, 16);          // fmt chunk size
  w16(20, fmt);
  w16(22, (uint16_t)channels);
  w32(24, (uint32_t)sample_rate);
  w32(28, byte_rate);
  w16(32, block);
  w16(34, (uint16_t)bits);
  memcpy(hdr + 36, "data", 4);
  w32(40, data_size);
  if (fwrite(hdr, 1, 44, f) != 44) {
    fclose(f);
    return fail("short header write");
  }

  const int64_t total = frames * channels;
  int ok = 1;
  if (bits == 32) {
    ok = fwrite(data, sizeof(float), (size_t)total, f) == (size_t)total;
  } else {
    const size_t kChunk = 1 << 16;
    int16_t buf[1 << 16];
    for (int64_t i = 0; i < total && ok; i += kChunk) {
      size_t m = (size_t)((total - i) < (int64_t)kChunk ? (total - i)
                                                        : (int64_t)kChunk);
      for (size_t j = 0; j < m; ++j) {
        float v = data[i + j] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        // truncate toward zero — byte-identical to the numpy fallback's
        // astype("<i2") so both writers produce the same file
        buf[j] = (int16_t)v;
      }
      ok = fwrite(buf, sizeof(int16_t), m, f) == m;
    }
  }
  fclose(f);
  return ok ? 0 : fail("short data write");
}

}  // extern "C"
