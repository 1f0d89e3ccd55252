// Native data-pipeline runtime for the TPU-native trainer.
//
// The reference's input pipeline rides PyTorch's native machinery:
// torchvision's IDX decode (reference data.py:11-14) and the C++-backed
// DataLoader worker pool with pinned staging buffers (reference
// data.py:21-25, `num_workers=2, pin_memory=True`). This library is the
// framework's own native equivalent:
//
//   * dt_idx_read     — IDX-format decode (raw or gzip) off the Python heap
//   * DtLoader        — a threaded batch-assembly pool: workers gather
//                       sample rows into a ring of staging buffers ahead
//                       of the consumer, delivered strictly in batch order
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Thread model: N worker threads claim batch tickets under a mutex, fill
// the slot `ticket % depth` once it is free, and mark it ready; the
// consumer (`dt_loader_next`) waits for slot readiness in order, copies
// out, frees the slot. Epochs are started with an explicit index plan so
// shuffle semantics (and their torch DistributedSampler parity) stay in
// the Python sampler — determinism lives in one place.

#include <zlib.h>

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Read an entire file into a heap buffer. Returns false on IO error.
bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  return got == out.size();
}

// Inflate a gzip stream (magic 0x1f 0x8b) into `out`.
bool gunzip(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+16: max window, gzip wrapper.
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  out.clear();
  std::vector<uint8_t> chunk(1 << 20);
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    zs.next_out = chunk.data();
    zs.avail_out = static_cast<uInt>(chunk.size());
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), chunk.data(),
               chunk.data() + (chunk.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

}  // namespace

extern "C" {

// Decode an IDX file (raw or gzipped) at `path`.
// On success returns 0 and fills:
//   *out_data  — malloc'd payload (big-endian for multi-byte dtypes, as
//                stored); caller frees with dt_free
//   *out_len   — payload bytes
//   *out_ndim  — number of dims (<= 8)
//   out_dims   — the dims
//   *out_dtype — the IDX dtype code (0x08 uint8 ... 0x0E float64)
// Error codes: 1 io, 2 gzip, 3 header, 4 size mismatch.
int dt_idx_read(const char* path, uint8_t** out_data, int64_t* out_len,
                int32_t* out_ndim, int64_t out_dims[8], int32_t* out_dtype) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return 1;
  if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    std::vector<uint8_t> inflated;
    if (!gunzip(raw, inflated)) return 2;
    raw.swap(inflated);
  }
  if (raw.size() < 4 || raw[0] != 0 || raw[1] != 0) return 3;
  int dtype = raw[2];
  int ndim = raw[3];
  if (ndim < 0 || ndim > 8) return 3;
  size_t header = 4 + 4 * static_cast<size_t>(ndim);
  if (raw.size() < header) return 3;
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) {
    uint32_t d = (uint32_t(raw[4 + 4 * i]) << 24) |
                 (uint32_t(raw[5 + 4 * i]) << 16) |
                 (uint32_t(raw[6 + 4 * i]) << 8) | uint32_t(raw[7 + 4 * i]);
    out_dims[i] = d;
    count *= d;
  }
  int64_t item = 0;
  switch (dtype) {
    case 0x08:
    case 0x09:
      item = 1;
      break;
    case 0x0B:
      item = 2;
      break;
    case 0x0C:
    case 0x0D:
      item = 4;
      break;
    case 0x0E:
      item = 8;
      break;
    default:
      return 3;
  }
  int64_t payload = count * item;
  if (static_cast<int64_t>(raw.size() - header) != payload) return 4;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(payload ? payload : 1));
  if (!buf) return 1;
  std::memcpy(buf, raw.data() + header, static_cast<size_t>(payload));
  *out_data = buf;
  *out_len = payload;
  *out_ndim = ndim;
  *out_dtype = dtype;
  return 0;
}

void dt_free(void* p) { std::free(p); }

// Decode a binary PPM (P6, RGB) or PGM (P5, gray) image at `path` —
// the zero-dependency raw-image format for the ImageNet ingest path
// (scripts/preprocess_imagenet.py): header `P6`, whitespace- and
// `#`-comment-separated width/height/maxval (maxval <= 255), then a
// raw payload of h*w*channels bytes.
// On success returns 0 and fills *out_data (malloc'd [h, w, c]
// interleaved uint8; caller frees with dt_free), *out_h/*out_w/*out_c.
// Error codes: 1 io, 3 header/format, 4 size mismatch.
int dt_ppm_read(const char* path, uint8_t** out_data, int32_t* out_h,
                int32_t* out_w, int32_t* out_c) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return 1;
  if (raw.size() < 2 || raw[0] != 'P' || (raw[1] != '5' && raw[1] != '6'))
    return 3;
  int channels = raw[1] == '6' ? 3 : 1;
  size_t pos = 2;
  long fields[3];  // width, height, maxval
  for (int f = 0; f < 3; ++f) {
    // Skip whitespace and `#` comments (which run to end of line).
    for (;;) {
      while (pos < raw.size() && std::isspace(raw[pos])) ++pos;
      if (pos < raw.size() && raw[pos] == '#') {
        while (pos < raw.size() && raw[pos] != '\n') ++pos;
        continue;
      }
      break;
    }
    if (pos >= raw.size() || !std::isdigit(raw[pos])) return 3;
    long v = 0;
    while (pos < raw.size() && std::isdigit(raw[pos])) {
      v = v * 10 + (raw[pos] - '0');
      if (v > (1l << 30)) return 3;
      ++pos;
    }
    fields[f] = v;
  }
  // Exactly ONE whitespace byte separates the header from the payload.
  if (pos >= raw.size() || !std::isspace(raw[pos])) return 3;
  ++pos;
  long w = fields[0], h = fields[1], maxval = fields[2];
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 255) return 3;
  int64_t payload = int64_t(w) * h * channels;
  if (static_cast<int64_t>(raw.size() - pos) < payload) return 4;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(payload));
  if (!buf) return 1;
  std::memcpy(buf, raw.data() + pos, static_cast<size_t>(payload));
  *out_data = buf;
  *out_h = static_cast<int32_t>(h);
  *out_w = static_cast<int32_t>(w);
  *out_c = channels;
  return 0;
}

// Decode a CIFAR binary batch (already in memory — the files live
// inside tarballs): n records of
//   [label_bytes of labels][3072 bytes RGB, channel-planar CHW].
// label_bytes: 1 (CIFAR-10) or 2 (CIFAR-100: coarse then fine — the
// FINE label, the last byte, is kept, matching data/cifar.py).
// Caller-buffer convention (like dt_loader_next): Python computes
// n = size / record, allocates the numpy outputs, and passes their
// data pointers — no double-buffering:
//   out_images — [n, 32, 32, 3] uint8, filled HWC-interleaved here so
//                the Python side needs no transpose/copy pass
//   out_labels — [n] int32
// Returns 0 on success, 3 on malformed input (size not a multiple of
// the record, or bad label_bytes).
int dt_cifar_decode(const uint8_t* data, int64_t size, int32_t label_bytes,
                    uint8_t* out_images, int32_t* out_labels) {
  constexpr int64_t kSide = 32, kChan = 3;
  constexpr int64_t kPixels = kSide * kSide;       // 1024 per plane
  constexpr int64_t kImageBytes = kPixels * kChan; // 3072
  if (label_bytes != 1 && label_bytes != 2) return 3;
  const int64_t record = label_bytes + kImageBytes;
  if (!data || !out_images || !out_labels || size <= 0 || size % record != 0)
    return 3;
  const int64_t n = size / record;
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* rec = data + r * record;
    out_labels[r] = rec[label_bytes - 1];  // fine label for CIFAR-100
    const uint8_t* planes = rec + label_bytes;
    uint8_t* dst = out_images + r * kImageBytes;
    // CHW planes → HWC interleaved.
    for (int64_t p = 0; p < kPixels; ++p) {
      dst[p * kChan + 0] = planes[p];
      dst[p * kChan + 1] = planes[kPixels + p];
      dst[p * kChan + 2] = planes[2 * kPixels + p];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// Threaded prefetching batch loader.
// ---------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> img;
  std::vector<int32_t> lbl;
  int64_t batch_id = -1;  // batch stored here; -1 = free
  bool ready = false;     // fill complete
};

struct DtLoader {
  const uint8_t* items = nullptr;   // [num_items, item_bytes], row-major
  const int32_t* labels = nullptr;  // [num_items]
  int64_t num_items = 0;
  int64_t item_bytes = 0;
  int64_t batch_size = 0;
  int32_t depth = 0;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::vector<int64_t> indices;  // owned copy of the epoch plan

  int64_t n_batches = 0;
  int64_t tickets_issued = 0;  // next batch id a worker may claim
  int64_t next_out = 0;        // next batch id the consumer expects
  bool shutdown = false;

  std::mutex mu;
  std::condition_variable cv_worker;    // slot freed / epoch started / stop
  std::condition_variable cv_consumer;  // slot became ready

  void worker_loop() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_worker.wait(
          lk, [&] { return shutdown || tickets_issued < n_batches; });
      if (shutdown) return;
      int64_t t = tickets_issued++;
      Slot& s = slots[t % depth];
      // Sliding-window gate: fill only once every earlier ticket that
      // used this slot has been consumed (t - depth < next_out). A
      // plain "slot free" check deadlocks when two workers hold
      // tickets for the same slot and the later one wins the race.
      cv_worker.wait(lk, [&] { return shutdown || t < next_out + depth; });
      if (shutdown) return;
      s.batch_id = t;
      s.ready = false;
      lk.unlock();
      const int64_t* plan = indices.data() + t * batch_size;
      uint8_t* img = s.img.data();
      int32_t* lbl = s.lbl.data();
      for (int64_t i = 0; i < batch_size; ++i) {
        int64_t src = plan[i];
        std::memcpy(img + i * item_bytes, items + src * item_bytes,
                    static_cast<size_t>(item_bytes));
        lbl[i] = labels[src];
      }
      lk.lock();
      s.ready = true;
      cv_consumer.notify_all();
    }
  }
};

DtLoader* dt_loader_create(const uint8_t* items, const int32_t* labels,
                           int64_t num_items, int64_t item_bytes,
                           int64_t batch_size, int32_t num_workers,
                           int32_t queue_depth) {
  if (!items || !labels || num_items <= 0 || item_bytes <= 0 ||
      batch_size <= 0 || num_workers <= 0 || queue_depth <= 0)
    return nullptr;
  DtLoader* L = new DtLoader();
  L->items = items;
  L->labels = labels;
  L->num_items = num_items;
  L->item_bytes = item_bytes;
  L->batch_size = batch_size;
  L->depth = queue_depth;
  L->slots.resize(queue_depth);
  for (auto& s : L->slots) {
    s.img.resize(static_cast<size_t>(batch_size * item_bytes));
    s.lbl.resize(static_cast<size_t>(batch_size));
  }
  for (int i = 0; i < num_workers; ++i)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

// Begin a new epoch with an explicit index plan (values in
// [0, num_items)). Trailing indices that don't fill a whole batch are
// dropped — drop_last semantics, matching the Python loader. Must not be
// called while the previous epoch is still being drained.
void dt_loader_start_epoch(DtLoader* L, const int64_t* indices, int64_t n) {
  std::lock_guard<std::mutex> lk(L->mu);
  int64_t nb = n / L->batch_size;
  L->indices.assign(indices, indices + nb * L->batch_size);
  L->n_batches = nb;
  L->tickets_issued = 0;
  L->next_out = 0;
  for (auto& s : L->slots) {
    s.batch_id = -1;
    s.ready = false;
  }
  L->cv_worker.notify_all();
}

// Copy the next batch into caller buffers. Returns 1 on success, 0 when
// the epoch is exhausted. Blocks while workers catch up.
int dt_loader_next(DtLoader* L, uint8_t* img_out, int32_t* lbl_out) {
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= L->n_batches) return 0;
  int64_t want = L->next_out;
  Slot& s = L->slots[want % L->depth];
  L->cv_consumer.wait(lk, [&] {
    return L->shutdown || (s.batch_id == want && s.ready);
  });
  if (L->shutdown) return 0;
  std::memcpy(img_out, s.img.data(), s.img.size());
  std::memcpy(lbl_out, s.lbl.data(), s.lbl.size() * sizeof(int32_t));
  s.batch_id = -1;
  s.ready = false;
  L->next_out = want + 1;
  L->cv_worker.notify_all();
  return 1;
}

void dt_loader_destroy(DtLoader* L) {
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->shutdown = true;
    L->cv_worker.notify_all();
    L->cv_consumer.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
