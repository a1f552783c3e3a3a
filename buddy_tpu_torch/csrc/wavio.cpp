// Native WAV codec and training-crop sampler of the port's data pipeline.
//
// Decodes PCM16/24/32 and IEEE-float WAV files straight into caller-provided
// float32 buffers, averaging channels to mono, writes mono IEEE-float WAVs,
// and implements the training segment rule (a random crop of a longer file,
// a wrap-pad at a random offset of a shorter one) from an mt19937_64 seed,
// so that a worker thread of loader.cpp fills a batch slot with no Python on
// its path.  The code is that of the JAX package's wavio.cpp, so that a
// seed gives the same segment bit for bit in both packages.
//
// Bound with ctypes by buddy_tpu_torch/data/audio_io.py; built with
// loader.cpp by buddy_tpu_torch/ops/_build.py::build_host at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <random>

namespace {

struct WavInfo {
  uint16_t format;      // 1 = PCM, 3 = IEEE float
  uint16_t channels;
  uint32_t sample_rate;
  uint16_t bits;
  int64_t data_offset;  // byte offset of sample data
  int64_t n_frames;     // frames (samples per channel)
};

// Parse RIFF chunks to find fmt + data. Returns 0 on success.
int parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size = 0;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return -1;
  if (fread(&size, 4, 1, f) != 1) return -1;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return -1;

  bool have_fmt = false, have_data = false;
  uint32_t data_size = 0;
  while (!(have_fmt && have_data)) {
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) return -1;
      if (size > n && fseek(f, size - n, SEEK_CUR) != 0) return -1;
      memcpy(&info->format, buf + 0, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits, buf + 14, 2);
      if (info->format == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub;
        memcpy(&sub, buf + 24, 2);
        info->format = sub;
      }
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      data_size = size;
      have_data = true;
      if (fseek(f, (size + 1) & ~1u, SEEK_CUR) != 0) break;  // chunks are 2-aligned
    } else {
      if (fseek(f, (size + 1) & ~1u, SEEK_CUR) != 0) break;
    }
    if (size & 1) {}  // padding handled above
  }
  if (!have_fmt || !have_data) return -1;
  int bytes_per_frame = info->channels * (info->bits / 8);
  if (bytes_per_frame == 0) return -1;
  info->n_frames = data_size / bytes_per_frame;
  return 0;
}

// Decode [start, start+n) frames as float32, averaging channels to mono.
int decode_mono(FILE* f, const WavInfo& info, int64_t start, int64_t n,
                float* out) {
  const int ch = info.channels;
  const int bps = info.bits / 8;
  const int64_t frame_bytes = (int64_t)ch * bps;
  if (fseek(f, info.data_offset + start * frame_bytes, SEEK_SET) != 0) return -1;

  const int64_t CHUNK = 1 << 16;
  uint8_t* buf = (uint8_t*)malloc(CHUNK * frame_bytes);
  if (!buf) return -1;
  int64_t done = 0;
  while (done < n) {
    int64_t todo = n - done < CHUNK ? n - done : CHUNK;
    if ((int64_t)fread(buf, frame_bytes, todo, f) != todo) { free(buf); return -1; }
    for (int64_t i = 0; i < todo; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* p = buf + i * frame_bytes + c * bps;
        float v = 0.f;
        if (info.format == 3 && info.bits == 32) {
          memcpy(&v, p, 4);
        } else if (info.format == 3 && info.bits == 64) {
          double d; memcpy(&d, p, 8); v = (float)d;
        } else if (info.format == 1 && info.bits == 16) {
          int16_t s; memcpy(&s, p, 2); v = s / 32768.f;
        } else if (info.format == 1 && info.bits == 24) {
          int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
          v = (s >> 8) / 8388608.f;
        } else if (info.format == 1 && info.bits == 32) {
          int32_t s; memcpy(&s, p, 4); v = s / 2147483648.f;
        } else {
          free(buf); return -2;  // unsupported
        }
        acc += v;
      }
      out[done + i] = acc / ch;
    }
    done += todo;
  }
  free(buf);
  return 0;
}

}  // namespace

extern "C" {

// Returns n_frames (>0) on success and fills sample_rate; <0 on error.
int64_t wav_info(const char* path, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != 0) return -1;
  *sample_rate = (int32_t)info.sample_rate;
  return info.n_frames;
}

// Decode the whole file to mono float32 (out must hold n_frames floats).
int64_t wav_read_mono(const char* path, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (parse_header(f, &info) != 0) { fclose(f); return -1; }
  int64_t n = info.n_frames < capacity ? info.n_frames : capacity;
  int rc = decode_mono(f, info, 0, n, out);
  fclose(f);
  return rc == 0 ? n : rc;
}

// The training segment rule: if the file is longer than segment_length,
// take a random crop; else wrap-pad at a random offset.  seed seeds a PRNG
// local to the call.
int wav_read_segment(const char* path, float* out, int64_t segment_length,
                     uint64_t seed) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (parse_header(f, &info) != 0) { fclose(f); return -1; }
  std::mt19937_64 rng(seed);
  const int64_t L = info.n_frames;
  int rc;
  if (L > segment_length) {
    std::uniform_int_distribution<int64_t> dist(0, L - segment_length - 1);
    rc = decode_mono(f, info, dist(rng), segment_length, out);
  } else {
    float* tmp = (float*)malloc(sizeof(float) * L);
    if (!tmp) { fclose(f); return -1; }
    rc = decode_mono(f, info, 0, L, tmp);
    if (rc == 0) {
      std::uniform_int_distribution<int64_t> dist(0, segment_length - L == 0 ? 0 : segment_length - L - 1);
      int64_t idx = segment_length - L > 0 ? dist(rng) : 0;
      // np.pad(..., 'wrap'): cyclic continuation on both sides
      for (int64_t i = 0; i < segment_length; ++i) {
        int64_t j = (i - idx) % L;
        if (j < 0) j += L;
        out[i] = tmp[j];
      }
    }
    free(tmp);
  }
  fclose(f);
  return rc;
}

// Write a mono float32 WAV (IEEE float, format 3): every WAV the port writes.
int wav_write_mono(const char* path, const float* data, int64_t n,
                   int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(n * 4);
  uint32_t riff_size = 4 + (8 + 16) + (8 + data_bytes);
  uint16_t fmt = 3, ch = 1, bits = 32;
  uint32_t byte_rate = sample_rate * 4, fmt_size = 16;
  uint16_t block_align = 4;
  fwrite("RIFF", 1, 4, f); fwrite(&riff_size, 4, 1, f); fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f); fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f); fwrite(&ch, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f); fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f); fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f); fwrite(&data_bytes, 4, 1, f);
  fwrite(data, 4, n, f);
  fclose(f);
  return 0;
}

}  // extern "C"
