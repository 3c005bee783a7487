// Native multi-threaded shard data loader for QAT input pipelines.
//
// The PyTorch port's copy of jaxlsq/native/loader.cpp (the same code).  Batch
// assembly runs off the Python thread: worker threads gather shuffled rows
// from .npy shards on disk into a ring of prefetched batch buffers; Python
// (jaxlsq_torch/native/loader.py) drains the ring via ctypes into pinned
// host tensors and copies them to the card.
//
// Design:
//  * shards are memory-mapped read-only (npy v1/v2, C-order); rows are
//    memcpy'd into the slot buffer — the kernel's page cache does the IO.
//  * one global shuffled permutation over (shard, row), reshuffled each
//    epoch with a counter-salted seed -> deterministic for a given seed
//    regardless of worker count (batch k always holds permutation rows
//    [k*B, (k+1)*B), delivered in order).
//  * ring of `prefetch` slots, each one full batch (x bytes + y bytes);
//    workers claim batch indices with an atomic cursor, fill their slot,
//    publish; the consumer takes batches IN ORDER (sequencing keeps
//    determinism; workers still overlap on different slots).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see build.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const uint8_t* base = nullptr;   // whole file
  size_t file_bytes = 0;
  const uint8_t* data = nullptr;   // payload (past the npy header)
  int64_t rows = 0;
  int64_t row_bytes = 0;
};

// Minimal .npy header parse: returns false + err on anything unsupported.
bool map_npy(const std::string& path, Mapped* out, std::string* err) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) { *err = "cannot open " + path; return false; }
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); *err = "fstat failed: " + path; return false; }
  size_t n = (size_t)st.st_size;
  void* m = mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) { *err = "mmap failed: " + path; return false; }
  const uint8_t* p = (const uint8_t*)m;
  if (n < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(m, n); *err = "not a .npy file: " + path; return false;
  }
  uint8_t major = p[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = p[8] | (p[9] << 8); hoff = 10; }
  else { hlen = p[8] | (p[9] << 8) | ((size_t)p[10] << 16) | ((size_t)p[11] << 24); hoff = 12; }
  // A corrupt/truncated header length must be rejected BEFORE building the
  // header string (and before the payload check below, whose size_t
  // subtraction would underflow if hoff + hlen exceeded the file).
  if (hoff + hlen > n) {
    munmap(m, n); *err = "truncated npy header: " + path; return false;
  }
  std::string hdr((const char*)p + hoff, hlen);
  if (hdr.find("'fortran_order': False") == std::string::npos) {
    munmap(m, n); *err = "fortran-order npy unsupported: " + path; return false;
  }
  // itemsize from descr like '<f4', '|u1', '<i8'
  auto dpos = hdr.find("'descr':");
  auto q1 = hdr.find('\'', dpos + 8);
  auto q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  int itemsize = 0;
  if (descr.size() >= 3) itemsize = atoi(descr.c_str() + 2);
  if (itemsize <= 0) { munmap(m, n); *err = "bad descr " + descr + ": " + path; return false; }
  // shape tuple
  auto spos = hdr.find("'shape':");
  auto l = hdr.find('(', spos);
  auto r = hdr.find(')', l);
  std::string shape = hdr.substr(l + 1, r - l - 1);
  std::vector<int64_t> dims;
  const char* s = shape.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    dims.push_back(strtoll(s, (char**)&s, 10));
  }
  if (dims.empty()) { munmap(m, n); *err = "scalar npy unsupported: " + path; return false; }
  int64_t row_elems = 1;
  for (size_t i = 1; i < dims.size(); i++) row_elems *= dims[i];
  out->base = p;
  out->file_bytes = n;
  out->data = p + hoff + hlen;
  out->rows = dims[0];
  out->row_bytes = row_elems * itemsize;
  size_t payload = n - hoff - hlen;  // checked non-negative above
  if (out->rows < 0 || out->row_bytes <= 0 ||
      (uint64_t)out->rows > payload / (uint64_t)out->row_bytes) {
    munmap(m, n); *err = "truncated npy: " + path; return false;
  }
  return true;
}

struct Slot {
  std::vector<uint8_t> x, y;
  int64_t batch_idx = -1;   // which batch this slot holds
  int64_t turn = 0;         // next batch index allowed to fill this slot
  enum State { FREE, FILLING, READY } state = FREE;
};

struct Loader {
  std::vector<Mapped> xs, ys;
  std::vector<std::pair<int32_t, int32_t>> index;  // (shard, row)
  int64_t batch = 0;
  int64_t x_row_bytes = 0, y_row_bytes = 0;
  uint64_t seed = 0;
  int64_t batches_per_epoch = 0;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int64_t> next_fill{0};   // next batch index to be claimed
  int64_t next_take = 0;               // next batch index the consumer wants
  std::atomic<bool> stop{false};
  std::atomic<int64_t> delivered{0};

  // Immutable per-epoch permutation snapshots.  Each epoch's permutation is
  // built FROM IDENTITY with an epoch-salted seed, so it is a pure function
  // of (seed, epoch) no matter which worker builds it or in what order —
  // workers prefetching across an epoch boundary each get the right
  // snapshot (an earlier in-place reshuffle design raced here: a straggler
  // re-shuffling the evolving array produced a different epoch-e
  // permutation than its peers).  Workers hold shared_ptrs — no copies.
  std::mutex perm_mu;
  std::map<int64_t, std::shared_ptr<const std::vector<int64_t>>> perms;

  std::shared_ptr<const std::vector<int64_t>> perm_for_epoch(int64_t epoch) {
    std::lock_guard<std::mutex> g(perm_mu);
    auto it = perms.find(epoch);
    if (it != perms.end()) return it->second;
    auto p = std::make_shared<std::vector<int64_t>>(index.size());
    for (size_t i = 0; i < p->size(); i++) (*p)[i] = (int64_t)i;
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)epoch);
    for (size_t i = p->size() - 1; i > 0; i--) {
      size_t j = rng() % (i + 1);
      std::swap((*p)[i], (*p)[j]);
    }
    perms[epoch] = p;
    // prune epochs far behind (prefetch skew is bounded by ring+workers)
    while (!perms.empty() && perms.begin()->first < epoch - 8)
      perms.erase(perms.begin());
    return p;
  }

  void fill_batch(int64_t b, Slot* slot) {
    int64_t epoch = b / batches_per_epoch;
    int64_t off = (b % batches_per_epoch) * batch;
    auto perm = perm_for_epoch(epoch);
    for (int64_t i = 0; i < batch; i++) {
      auto [shard, row] = index[(*perm)[off + i]];
      memcpy(slot->x.data() + i * x_row_bytes,
             xs[shard].data + (int64_t)row * x_row_bytes, x_row_bytes);
      if (y_row_bytes)
        memcpy(slot->y.data() + i * y_row_bytes,
               ys[shard].data + (int64_t)row * y_row_bytes, y_row_bytes);
    }
    slot->batch_idx = b;
  }

  void worker() {
    while (!stop.load()) {
      int64_t b = next_fill.fetch_add(1);
      // Batch b always lives in ring slot b % D; the slot's `turn` field
      // serializes its occupants (b-D must be filled AND consumed before b
      // may fill), so two workers can never write one slot concurrently.
      size_t s = (size_t)(b % (int64_t)slots.size());
      Slot* slot = &slots[s];
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() ||
                 (slot->state == Slot::FREE && slot->turn == b);
        });
        if (stop.load()) return;
        slot->state = Slot::FILLING;
      }
      fill_batch(b, slot);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->state = Slot::READY;
      }
      cv_ready.notify_all();
    }
  }

  bool take(void* x_out, void* y_out) {
    size_t s = (size_t)(next_take % (int64_t)slots.size());
    std::unique_lock<std::mutex> lk(mu);
    Slot& slot = slots[s];
    cv_ready.wait(lk, [&] {
      return stop.load() ||
             (slot.state == Slot::READY && slot.batch_idx == next_take);
    });
    if (stop.load()) return false;
    memcpy(x_out, slot.x.data(), slot.x.size());
    if (y_row_bytes && y_out) memcpy(y_out, slot.y.data(), slot.y.size());
    slot.state = Slot::FREE;
    slot.turn = next_take + (int64_t)slots.size();
    next_take++;
    delivered.fetch_add(1);
    lk.unlock();
    cv_free.notify_all();
    return true;
  }
};

void set_err(char* err, long errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

int jl_loader_abi_version() { return 1; }

void* jl_open(const char** x_paths, const char** y_paths, int n_shards,
              long batch, int prefetch, int n_workers,
              unsigned long long seed, char* err, long errlen) {
  auto* L = new Loader();
  std::string e;
  for (int i = 0; i < n_shards; i++) {
    Mapped mx;
    if (!map_npy(x_paths[i], &mx, &e)) { set_err(err, errlen, e); delete L; return nullptr; }
    L->xs.push_back(mx);
    if (y_paths) {
      Mapped my;
      if (!map_npy(y_paths[i], &my, &e)) { set_err(err, errlen, e); delete L; return nullptr; }
      if (my.rows != mx.rows) {
        set_err(err, errlen, "x/y row mismatch in shard " + std::to_string(i));
        delete L; return nullptr;
      }
      L->ys.push_back(my);
    }
  }
  L->x_row_bytes = L->xs[0].row_bytes;
  L->y_row_bytes = L->ys.empty() ? 0 : L->ys[0].row_bytes;
  for (size_t i = 0; i < L->xs.size(); i++) {
    if (L->xs[i].row_bytes != L->x_row_bytes ||
        (!L->ys.empty() && L->ys[i].row_bytes != L->y_row_bytes)) {
      set_err(err, errlen, "inconsistent row shapes across shards");
      delete L; return nullptr;
    }
    for (int64_t r = 0; r < L->xs[i].rows; r++)
      L->index.push_back({(int32_t)i, (int32_t)r});
  }
  if ((int64_t)L->index.size() < batch) {
    set_err(err, errlen, "dataset smaller than one batch");
    delete L; return nullptr;
  }
  L->batch = batch;
  L->seed = seed;
  L->batches_per_epoch = (int64_t)L->index.size() / batch;  // drop remainder
  int depth = prefetch > 0 ? prefetch : 4;
  L->slots.resize(depth);
  for (size_t i = 0; i < L->slots.size(); i++) {
    L->slots[i].x.resize(batch * L->x_row_bytes);
    L->slots[i].y.resize(batch * L->y_row_bytes);
    L->slots[i].turn = (int64_t)i;  // slot i's first occupant is batch i
  }
  int w = n_workers > 0 ? n_workers : 2;
  for (int i = 0; i < w; i++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

long jl_x_row_bytes(void* h) { return ((Loader*)h)->x_row_bytes; }
long jl_y_row_bytes(void* h) { return ((Loader*)h)->y_row_bytes; }
long jl_num_examples(void* h) { return (long)((Loader*)h)->index.size(); }
long jl_batches_per_epoch(void* h) { return ((Loader*)h)->batches_per_epoch; }
long jl_delivered(void* h) { return (long)((Loader*)h)->delivered.load(); }

int jl_next(void* h, void* x_out, void* y_out) {
  return ((Loader*)h)->take(x_out, y_out) ? 0 : -1;
}

void jl_close(void* h) {
  auto* L = (Loader*)h;
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  for (auto& m : L->xs) munmap((void*)m.base, m.file_bytes);
  for (auto& m : L->ys) munmap((void*)m.base, m.file_bytes);
  delete L;
}

}  // extern "C"
