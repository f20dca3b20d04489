// Host-side batch assembler of maavss_tpu_torch's --native_loader: the
// {audio, frames} batches of an AV dataset, built in C++ worker threads
// behind a bounded prefetch ring, over the ingested stores (a float32 audio
// memmap and uint8 .npy frame shards). A copy of the JAX package's
// native/dataloader.cc, its code unchanged (tests/test_torch_package.py pins
// it), so that both loaders give the same batches from the same store and
// seed.
//
// A plain C API, loaded with ctypes by maavss_tpu_torch/data/native_loader.py,
// which builds it with the host's C++ compiler at first use (no CUDA):
//   c++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared dataloader.cc

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// Minimal .npy reader (v1.x headers, C-order uint8 arrays) — enough to mmap
// the frame shards written by numpy.save (frame_shards.py).
// ---------------------------------------------------------------------------

struct NpyArray {
  const uint8_t* data = nullptr;   // payload (within the mapping)
  void* map = nullptr;             // mmap base
  size_t map_len = 0;
  std::vector<int64_t> shape;

  bool open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return false; }
    map_len = static_cast<size_t>(st.st_size);
    map = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (map == MAP_FAILED) { map = nullptr; return false; }
    const uint8_t* p = static_cast<const uint8_t*>(map);
    if (map_len < 10 || memcmp(p, "\x93NUMPY", 6) != 0) return false;
    uint32_t hlen;
    size_t off;
    if (p[6] == 1) { hlen = p[8] | (p[9] << 8); off = 10; }
    else { hlen = p[8] | (p[9] << 8) | (p[10] << 16) | (p[11] << 24); off = 12; }
    std::string hdr(reinterpret_cast<const char*>(p + off), hlen);
    if (hdr.find("|u1") == std::string::npos) return false;  // uint8 only
    if (hdr.find("'fortran_order': False") == std::string::npos) return false;
    size_t sp = hdr.find("'shape':");
    if (sp == std::string::npos) return false;
    sp = hdr.find('(', sp);
    size_t ep = hdr.find(')', sp);
    std::string dims = hdr.substr(sp + 1, ep - sp - 1);
    shape.clear();
    const char* c = dims.c_str();
    while (*c) {
      while (*c == ' ' || *c == ',') ++c;
      if (!*c) break;
      shape.push_back(strtoll(c, const_cast<char**>(&c), 10));
    }
    data = p + off + hlen;
    return !shape.empty();
  }

  ~NpyArray() {
    if (map) munmap(map, map_len);
  }
};

// ---------------------------------------------------------------------------
// Loader: epoch-shuffled clip order -> worker threads fill batch slots ->
// bounded ring consumed by dl_next.
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<float> audio;     // [B, S]
  std::vector<uint8_t> frames;  // [B, T, H, W] raw uint8 (device normalizes)
};

struct Loader {
  // stores
  const float* audio_map = nullptr;
  void* audio_mmap = nullptr;
  size_t audio_len = 0;  // samples
  std::vector<NpyArray> shards;
  int64_t fh = 0, fw = 0;

  // clip table
  std::vector<int64_t> clip_audio_start;  // absolute sample offset
  std::vector<int64_t> clip_audio_end;    // file-end clamp (zero-pad beyond)
  std::vector<int32_t> clip_video;
  std::vector<int64_t> clip_frames;  // [n_clips, t_total] local frame indices
  int64_t n_clips = 0;
  int t_total = 0;
  int64_t samples = 0;
  int batch = 0;

  // scheduling
  std::mt19937_64 rng;
  std::vector<int64_t> order;
  std::atomic<int64_t> cursor{0};
  std::mutex order_mu;

  // ring
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t queue_cap = 2;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    std::lock_guard<std::mutex> lk(mu);
    while (!ready.empty()) { delete ready.front(); ready.pop(); }
    if (audio_mmap) munmap(audio_mmap, audio_len * sizeof(float));
  }

  void reshuffle_locked() {
    for (int64_t i = order.size() - 1; i > 0; --i) {
      std::swap(order[i], order[rng() % (i + 1)]);
    }
    cursor.store(0);
  }

  int64_t next_clip() {
    std::lock_guard<std::mutex> lk(order_mu);
    int64_t c = cursor.fetch_add(1);
    if (c >= static_cast<int64_t>(order.size())) {
      // epoch boundary: reshuffle, continue as an infinite stream
      reshuffle_locked();
      c = cursor.fetch_add(1);
    }
    return order[c];
  }

  void fill_one(int64_t clip, float* a_out, uint8_t* f_out) const {
    // audio slice with zero-pad past file end (audio_memmap.read parity)
    int64_t s0 = clip_audio_start[clip];
    int64_t s1 = clip_audio_end[clip];
    int64_t n = std::min<int64_t>(samples, std::max<int64_t>(0, s1 - s0));
    if (n > 0) memcpy(a_out, audio_map + s0, n * sizeof(float));
    if (n < samples) memset(a_out + n, 0, (samples - n) * sizeof(float));

    const NpyArray& sh = shards[clip_video[clip]];
    const int64_t hw = fh * fw;
    const int64_t* fidx = &clip_frames[clip * t_total];
    for (int t = 0; t < t_total; ++t) {
      memcpy(f_out + t * hw, sh.data + fidx[t] * hw, hw);
    }
  }

  void worker() {
    while (!stop.load()) {
      auto* b = new Batch;
      b->audio.resize(static_cast<size_t>(batch) * samples);
      b->frames.resize(static_cast<size_t>(batch) * t_total * fh * fw);
      for (int i = 0; i < batch; ++i) {
        int64_t clip = next_clip();
        fill_one(clip, b->audio.data() + static_cast<size_t>(i) * samples,
                 b->frames.data() + static_cast<size_t>(i) * t_total * fh * fw);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < queue_cap || stop.load(); });
      if (stop.load()) { delete b; return; }
      ready.push(b);
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* dl_create(const char* audio_path,
                const char** shard_paths, int32_t n_shards,
                const int64_t* clip_audio_start,
                const int64_t* clip_audio_end,
                const int32_t* clip_video,
                const int64_t* clip_frames,
                int64_t n_clips, int32_t t_total, int64_t samples,
                int32_t batch, int32_t queue_cap, int32_t n_threads,
                uint64_t seed) {
  auto* L = new Loader;
  // audio memmap
  int fd = ::open(audio_path, O_RDONLY);
  if (fd < 0) { delete L; return nullptr; }
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); delete L; return nullptr; }
  L->audio_len = st.st_size / sizeof(float);
  L->audio_mmap = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (L->audio_mmap == MAP_FAILED) { L->audio_mmap = nullptr; delete L; return nullptr; }
  L->audio_map = static_cast<const float*>(L->audio_mmap);

  L->shards.resize(n_shards);
  for (int i = 0; i < n_shards; ++i) {
    if (!L->shards[i].open(shard_paths[i]) || L->shards[i].shape.size() != 3) {
      fprintf(stderr, "dl_create: bad shard %s\n", shard_paths[i]);
      delete L;
      return nullptr;
    }
  }
  L->fh = L->shards[0].shape[1];
  L->fw = L->shards[0].shape[2];

  L->clip_audio_start.assign(clip_audio_start, clip_audio_start + n_clips);
  L->clip_audio_end.assign(clip_audio_end, clip_audio_end + n_clips);
  L->clip_video.assign(clip_video, clip_video + n_clips);
  L->clip_frames.assign(clip_frames, clip_frames + n_clips * t_total);
  L->n_clips = n_clips;
  L->t_total = t_total;
  L->samples = samples;
  L->batch = batch;
  L->queue_cap = queue_cap > 0 ? queue_cap : 2;
  L->rng.seed(seed);
  L->order.resize(n_clips);
  for (int64_t i = 0; i < n_clips; ++i) L->order[i] = i;
  {
    std::lock_guard<std::mutex> lk(L->order_mu);
    L->reshuffle_locked();
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking: copies the next ready batch into caller buffers.
// audio_out: [batch, samples] float32; frames_out: [batch, t_total, H, W] uint8.
int32_t dl_next(void* handle, float* audio_out, uint8_t* frames_out) {
  auto* L = static_cast<Loader*>(handle);
  Batch* b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
    if (L->stop.load()) return -1;
    b = L->ready.front();
    L->ready.pop();
    L->cv_space.notify_one();
  }
  memcpy(audio_out, b->audio.data(), b->audio.size() * sizeof(float));
  memcpy(frames_out, b->frames.data(), b->frames.size());
  delete b;
  return 0;
}

void dl_frame_dims(void* handle, int64_t* h, int64_t* w) {
  auto* L = static_cast<Loader*>(handle);
  *h = L->fh;
  *w = L->fw;
}

void dl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
