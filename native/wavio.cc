// Native IO runtime: threaded WAV decoding, energy silence removal, and
// padded-batch assembly for device upload.
//
// Role: the host-side data loader of the framework. The reference keeps
// its hot math in C++ (src/gmm/src/*, threaded via src/gmm/src/Threadpool/);
// here the math lives on the accelerator (XLA/Pallas), and the native layer
// owns what must stay on the host: RIFF parsing, PCM conversion, the
// data-dependent silence-removal scan (src/filters/silence.py:11-50 — its
// variable-stride advance cannot be a device kernel), and assembling many
// ragged files into one zero-padded float32 [B, L_max] batch ready for a
// single host->device transfer.
//
// Exposed as a C ABI consumed by ctypes (speaker_recognition/utils/
// native_io.py), mirroring how the reference exposes its core through
// extern "C" (src/gmm/src/pygmm.hh).
//
// Build: make -C native   (produces libwavio.so)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  int32_t fs = 0;
  int32_t channels = 0;
  std::vector<float> samples;  // mono (channel 0), int16 scale
  bool ok = false;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Minimal RIFF/WAVE reader: PCM 8/16/32-bit and IEEE float32, any channel
// count (keeps channel 0, like the reference's read_wav + mononize).
WavData read_wav(const char* path) {
  WavData out;
  FILE* f = fopen(path, "rb");
  if (!f) {
    out.error = "cannot open file";
    return out;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    out.error = "short read";
    return out;
  }
  fclose(f);

  if (size < 44 || memcmp(buf.data(), "RIFF", 4) != 0 ||
      memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }

  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t fs = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    size_t avail = buf.size() - pos - 8;  // bytes actually present
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16 && avail >= 16) {
      audio_format = rd_u16(body);
      channels = rd_u16(body + 2);
      fs = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
      if (pos + 8 + data_len > buf.size())
        data_len = static_cast<uint32_t>(buf.size() - pos - 8);
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }

  if (!data || channels == 0 || fs == 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  // WAVE_FORMAT_EXTENSIBLE (0xFFFE) carries the real format in a
  // sub-chunk; PCM layouts below still apply for the common cases.
  if (audio_format != 1 && audio_format != 3 && audio_format != 0xFFFE) {
    out.error = "unsupported audio format " + std::to_string(audio_format);
    return out;
  }

  if (bits != 8 && bits != 16 && bits != 32) {
    out.error = "unsupported bit depth " + std::to_string(bits);
    return out;
  }
  uint32_t bytes_per = bits / 8;  // nonzero: bits validated above
  uint32_t frames = data_len / (bytes_per * channels);
  out.fs = static_cast<int32_t>(fs);
  out.channels = channels;
  out.samples.resize(frames);

  for (uint32_t i = 0; i < frames; i++) {
    const uint8_t* s = data + static_cast<size_t>(i) * bytes_per * channels;
    float v = 0.f;
    switch (bits) {
      case 8:  // unsigned, centered like silence.py's uint path
        v = static_cast<float>(static_cast<int>(s[0]) - 128) * 256.0f;
        break;
      case 16:
        v = static_cast<float>(static_cast<int16_t>(rd_u16(s)));
        break;
      case 32:
        if (audio_format == 3) {
          float fv;
          memcpy(&fv, s, 4);
          v = fv * 32768.0f;
        } else {
          v = static_cast<float>(static_cast<int32_t>(rd_u32(s))) / 65536.0f;
        }
        break;
      default:
        out.error = "unsupported bit depth " + std::to_string(bits);
        return out;
    }
    out.samples[i] = v;
  }
  out.ok = true;
  return out;
}

// Energy-gated silence removal, the reference algorithm verbatim
// (src/filters/silence.py:11-50): advance by frame_length over silence,
// copy frame_shift samples and advance by frame_shift over speech.
size_t remove_silence_inplace(std::vector<float>& sig, int fs,
                              double frame_duration, double frame_shift,
                              double perc) {
  const size_t n = sig.size();
  if (n == 0) return 0;
  const size_t frame_len = static_cast<size_t>(frame_duration * fs);
  const size_t shift_len = static_cast<size_t>(frame_shift * fs);
  double total = 0;
  for (float v : sig) total += static_cast<double>(v) * v;
  const double avg = total / static_cast<double>(n);
  const double gate = avg * perc;

  size_t out_len = 0, i = 0;
  while (i < n) {
    const size_t end = i + frame_len < n ? i + frame_len : n;
    double e = 0;
    for (size_t j = i; j < end; j++) e += static_cast<double>(sig[j]) * sig[j];
    e /= static_cast<double>(end - i);
    if (e < gate) {
      i += frame_len;
    } else {
      size_t add = shift_len < (end - i) ? shift_len : (end - i);
      memmove(sig.data() + out_len, sig.data() + i, add * sizeof(float));
      out_len += add;
      i += shift_len;
    }
  }
  sig.resize(out_len);
  return out_len;
}

}  // namespace

extern "C" {

// Decode one wav file. Returns n_samples (>=0) or -1 on error. Caller first
// calls with samples=nullptr to query the length, then with a buffer.
long wavio_read(const char* path, float* samples, long capacity,
                int32_t* fs_out) {
  WavData w = read_wav(path);
  if (!w.ok) return -1;
  *fs_out = w.fs;
  long n = static_cast<long>(w.samples.size());
  if (samples) {
    long c = n < capacity ? n : capacity;
    memcpy(samples, w.samples.data(), static_cast<size_t>(c) * sizeof(float));
  }
  return n;
}

// Load a batch of wav files in parallel into a zero-padded row-major
// float32 [n_files, max_len] buffer. lengths_out[i] receives each file's
// sample count (0 on decode failure), fs_out[i] its sample rate.
// remove_silence_flag applies the reference energy gate per file before
// padding. n_threads <= 0 uses the hardware concurrency.
// Returns the max length actually written, or -1 if every file failed.
long wavio_load_batch(const char** paths, int n_files, float* batch,
                      long max_len, int32_t* lengths_out, int32_t* fs_out,
                      int remove_silence_flag, double silence_perc,
                      int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  std::atomic<int> next(0);
  std::atomic<long> max_written(-1);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      WavData w = read_wav(paths[i]);
      if (!w.ok) {
        lengths_out[i] = 0;
        fs_out[i] = 0;
        continue;
      }
      if (remove_silence_flag)
        remove_silence_inplace(w.samples, w.fs, 0.02, 0.01, silence_perc);
      long n = static_cast<long>(w.samples.size());
      if (n > max_len) n = max_len;
      memcpy(batch + static_cast<size_t>(i) * max_len, w.samples.data(),
             static_cast<size_t>(n) * sizeof(float));
      lengths_out[i] = static_cast<int32_t>(n);
      fs_out[i] = w.fs;
      long prev = max_written.load();
      while (n > prev && !max_written.compare_exchange_weak(prev, n)) {
      }
    }
  };

  std::vector<std::thread> threads;
  int n_workers = n_threads < n_files ? n_threads : n_files;
  for (int t = 0; t < n_workers; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return max_written.load();
}

// Standalone energy silence removal over a caller buffer (in place).
// Returns the new length.
long wavio_remove_silence(float* samples, long n, int fs,
                          double frame_duration, double frame_shift,
                          double perc) {
  std::vector<float> v(samples, samples + n);
  size_t out = remove_silence_inplace(v, fs, frame_duration, frame_shift, perc);
  memcpy(samples, v.data(), out * sizeof(float));
  return static_cast<long>(out);
}

}  // extern "C"
