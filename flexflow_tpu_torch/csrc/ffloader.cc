// Native data loader (the counterpart of the reference's
// python/flexflow_dataloader.{h,cc}: SingleDataLoader stages the whole
// dataset in host memory once, then copies each iteration's batch out).
//
// The dataset file is mmap'd (the page cache is the staging buffer), and a
// background worker thread gathers shuffled sample rows into a small ring
// of contiguous batch buffers, off the GIL, while the training step runs.
// Python pops filled buffers and copies them to the device.
//
// Plain C ABI for ctypes: ffl_open / ffl_config / ffl_reset / ffl_next /
// ffl_close. The batches and their order for a seed are those of the JAX
// package's loader (native/ffloader.cc), whose source this is.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
    int fd = -1;
    const uint8_t* base = nullptr;   // mmap of the whole file
    size_t map_bytes = 0;
    size_t offset = 0;               // payload start (npy header skipped)
    size_t sample_bytes = 0;
    int64_t num_samples = 0;

    int batch = 0;
    bool shuffle = false;
    std::mt19937_64 rng;
    std::vector<int64_t> order;

    static constexpr int kRing = 4;
    std::vector<std::vector<uint8_t>> bufs;
    std::queue<int> ready;           // filled buffer indices (epoch order)
    std::queue<int> empty;           // reusable buffer indices
    std::mutex mu;
    std::condition_variable cv_ready, cv_empty;
    std::thread worker;
    std::atomic<bool> stop{false};

    ~Loader() { shutdown(); }

    void stop_worker() {
        {
            // take mu before setting stop + notifying: without it the
            // worker can evaluate its wait predicate (stop=false), lose
            // the notify, and sleep forever -> join() deadlocks
            std::lock_guard<std::mutex> lk(mu);
            stop.store(true);
        }
        cv_empty.notify_all();
        cv_ready.notify_all();
        if (worker.joinable()) worker.join();
        stop.store(false);
    }

    void shutdown() {
        stop_worker();
        stop.store(true);  // no restart after shutdown
        if (base) munmap(const_cast<uint8_t*>(base), map_bytes);
        if (fd >= 0) close(fd);
        base = nullptr;
        fd = -1;
    }

    int64_t num_batches() const { return num_samples / batch; }

    void fill_loop() {
        const int64_t nb = num_batches();
        for (int64_t b = 0; b < nb && !stop.load(); ++b) {
            int buf_idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_empty.wait(lk, [&] { return stop.load() || !empty.empty(); });
                if (stop.load()) return;
                buf_idx = empty.front();
                empty.pop();
            }
            uint8_t* dst = bufs[buf_idx].data();
            const int64_t* idx = order.data() + b * batch;
            for (int i = 0; i < batch; ++i) {
                std::memcpy(dst + size_t(i) * sample_bytes,
                            base + offset + size_t(idx[i]) * sample_bytes,
                            sample_bytes);
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.push(buf_idx);
            }
            cv_ready.notify_one();
        }
    }

    void start_epoch() {
        // join the previous epoch's worker, reset the ring, reshuffle
        stop_worker();
        ready = {};
        empty = {};
        for (int i = 0; i < kRing; ++i) empty.push(i);
        if (shuffle) {
            for (int64_t i = num_samples - 1; i > 0; --i) {
                std::uniform_int_distribution<int64_t> d(0, i);
                std::swap(order[i], order[size_t(d(rng))]);
            }
        }
        worker = std::thread([this] { fill_loop(); });
    }

    // returns 1 and copies a batch into out; 0 at epoch end
    int next(uint8_t* out, int64_t produced) {
        if (produced >= num_batches()) return 0;
        int buf_idx;
        {
            std::unique_lock<std::mutex> lk(mu);
            cv_ready.wait(lk, [&] { return stop.load() || !ready.empty(); });
            if (stop.load() && ready.empty()) return 0;
            buf_idx = ready.front();
            ready.pop();
        }
        std::memcpy(out, bufs[buf_idx].data(), size_t(batch) * sample_bytes);
        {
            std::lock_guard<std::mutex> lk(mu);
            empty.push(buf_idx);
        }
        cv_empty.notify_one();
        return 1;
    }
};

}  // namespace

extern "C" {

void* ffl_open(const char* path, long sample_bytes, long num_samples,
               long offset) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
    }
    size_t need = size_t(offset) + size_t(sample_bytes) * size_t(num_samples);
    if (size_t(st.st_size) < need) {
        close(fd);
        return nullptr;
    }
    void* base = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
    if (base == MAP_FAILED) {
        close(fd);
        return nullptr;
    }
    auto* l = new Loader();
    l->fd = fd;
    l->base = static_cast<const uint8_t*>(base);
    l->map_bytes = size_t(st.st_size);
    l->offset = size_t(offset);
    l->sample_bytes = size_t(sample_bytes);
    l->num_samples = num_samples;
    l->order.resize(size_t(num_samples));
    for (int64_t i = 0; i < num_samples; ++i) l->order[size_t(i)] = i;
    return l;
}

void ffl_config(void* h, int batch, int shuffle, long seed) {
    auto* l = static_cast<Loader*>(h);
    // a worker from a previous epoch may still be writing into bufs —
    // stop and join it BEFORE reallocating the ring or changing batch
    l->stop_worker();
    l->batch = batch;
    l->shuffle = shuffle != 0;
    l->rng.seed(uint64_t(seed));
    l->bufs.assign(Loader::kRing,
                   std::vector<uint8_t>(size_t(batch) * l->sample_bytes));
}

void ffl_reset(void* h) { static_cast<Loader*>(h)->start_epoch(); }

int ffl_next(void* h, void* out, long produced) {
    return static_cast<Loader*>(h)->next(static_cast<uint8_t*>(out), produced);
}

void ffl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
