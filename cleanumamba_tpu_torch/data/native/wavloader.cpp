// Native data loader: multithreaded WAV decode + random crop + batch fill.
//
// Replacement for the reference's torchaudio/PySoundFile C decode
// path + torch DataLoader worker processes (reference src/util/dataset.py:27,
// :156-185, num_workers=4).  Threads decode paired clean/noisy PCM16 WAV
// files, take aligned random crops (repeat-padding short clips, reference
// dataset.py:119-134), and fill a ring of preallocated float32 batch buffers
// so the Python side only does a pointer copy into device transfer.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread wavloader.cpp -o libwavloader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
    std::vector<float> samples;
    int sample_rate = 0;
};

// Minimal RIFF/WAVE PCM16 + PCM32 + float32 reader (mono-mixes multichannel).
bool read_wav(const std::string& path, WavData* out) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    auto rd_u32 = [&](uint32_t* v) { return fread(v, 4, 1, f) == 1; };
    auto rd_u16 = [&](uint16_t* v) { return fread(v, 2, 1, f) == 1; };
    char tag[4];
    uint32_t riff_size;
    if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0 ||
        !rd_u32(&riff_size) || fread(tag, 1, 4, f) != 4 ||
        memcmp(tag, "WAVE", 4) != 0) {
        fclose(f);
        return false;
    }
    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    bool got_fmt = false;
    while (fread(tag, 1, 4, f) == 4) {
        uint32_t size;
        if (!rd_u32(&size)) break;
        if (memcmp(tag, "fmt ", 4) == 0) {
            uint32_t byte_rate;
            uint16_t block_align;
            if (!rd_u16(&fmt) || !rd_u16(&channels) || !rd_u32(&rate) ||
                !rd_u32(&byte_rate) || !rd_u16(&block_align) || !rd_u16(&bits)) {
                fclose(f);
                return false;
            }
            if (size > 16) fseek(f, size - 16, SEEK_CUR);
            got_fmt = true;
        } else if (memcmp(tag, "data", 4) == 0) {
            if (!got_fmt || channels == 0) {
                fclose(f);
                return false;
            }
            size_t n_frames = 0;
            out->sample_rate = static_cast<int>(rate);
            if (fmt == 1 && bits == 16) {
                n_frames = size / (2 * channels);
                std::vector<int16_t> raw(size / 2);
                if (fread(raw.data(), 1, size, f) != size) { fclose(f); return false; }
                out->samples.resize(n_frames);
                for (size_t i = 0; i < n_frames; ++i) {
                    float acc = 0.f;
                    for (int c = 0; c < channels; ++c)
                        acc += raw[i * channels + c] / 32768.0f;
                    out->samples[i] = acc / channels;
                }
            } else if (fmt == 1 && bits == 32) {
                n_frames = size / (4 * channels);
                std::vector<int32_t> raw(size / 4);
                if (fread(raw.data(), 1, size, f) != size) { fclose(f); return false; }
                out->samples.resize(n_frames);
                for (size_t i = 0; i < n_frames; ++i) {
                    float acc = 0.f;
                    for (int c = 0; c < channels; ++c)
                        acc += raw[i * channels + c] / 2147483648.0f;
                    out->samples[i] = acc / channels;
                }
            } else if (fmt == 3 && bits == 32) {
                n_frames = size / (4 * channels);
                std::vector<float> raw(size / 4);
                if (fread(raw.data(), 1, size, f) != size) { fclose(f); return false; }
                out->samples.resize(n_frames);
                for (size_t i = 0; i < n_frames; ++i) {
                    float acc = 0.f;
                    for (int c = 0; c < channels; ++c) acc += raw[i * channels + c];
                    out->samples[i] = acc / channels;
                }
            } else {
                fclose(f);
                return false;
            }
            fclose(f);
            return true;
        } else {
            fseek(f, size + (size & 1), SEEK_CUR);
        }
    }
    fclose(f);
    return false;
}

struct Batch {
    std::vector<float> clean;
    std::vector<float> noisy;
};

struct Loader {
    std::vector<std::string> clean_paths;
    std::vector<std::string> noisy_paths;
    int crop_len = 0;
    int batch_size = 0;
    int n_threads = 0;
    uint64_t seed = 0;

    std::queue<Batch*> ready;
    std::vector<Batch*> pool;
    std::mutex mu;
    std::condition_variable cv_ready, cv_pool;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> batch_counter{0};

    ~Loader() {
        stop.store(true);
        cv_pool.notify_all();
        cv_ready.notify_all();
        for (auto& t : workers) t.join();
        std::lock_guard<std::mutex> l(mu);
        while (!ready.empty()) { delete ready.front(); ready.pop(); }
        for (auto* b : pool) delete b;
    }

    void crop_pair(std::mt19937_64& rng, const WavData& c, const WavData& n,
                   float* out_c, float* out_n) {
        size_t len = std::min(c.samples.size(), n.samples.size());
        if (len == 0) {
            memset(out_c, 0, crop_len * sizeof(float));
            memset(out_n, 0, crop_len * sizeof(float));
            return;
        }
        if (len < static_cast<size_t>(crop_len)) {
            // repeat-pad short clips (reference dataset.py:119-134)
            for (int i = 0; i < crop_len; ++i) {
                out_c[i] = c.samples[i % len];
                out_n[i] = n.samples[i % len];
            }
        } else {
            std::uniform_int_distribution<size_t> d(0, len - crop_len);
            size_t start = d(rng);
            memcpy(out_c, c.samples.data() + start, crop_len * sizeof(float));
            memcpy(out_n, n.samples.data() + start, crop_len * sizeof(float));
        }
    }

    void worker(int tid) {
        while (!stop.load()) {
            Batch* b = nullptr;
            {
                std::unique_lock<std::mutex> l(mu);
                cv_pool.wait(l, [&] { return stop.load() || !pool.empty(); });
                if (stop.load()) return;
                b = pool.back();
                pool.pop_back();
            }
            uint64_t batch_id = batch_counter.fetch_add(1);
            std::mt19937_64 rng(seed ^ (batch_id * 0x9E3779B97F4A7C15ull));
            std::uniform_int_distribution<size_t> pick(0, clean_paths.size() - 1);
            for (int i = 0; i < batch_size; ++i) {
                size_t idx = pick(rng);
                WavData c, n;
                if (!read_wav(clean_paths[idx], &c) || !read_wav(noisy_paths[idx], &n)) {
                    memset(b->clean.data() + i * crop_len, 0, crop_len * sizeof(float));
                    memset(b->noisy.data() + i * crop_len, 0, crop_len * sizeof(float));
                    continue;
                }
                crop_pair(rng, c, n, b->clean.data() + i * crop_len,
                          b->noisy.data() + i * crop_len);
            }
            {
                std::lock_guard<std::mutex> l(mu);
                ready.push(b);
            }
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

// paths: '\n'-separated clean paths, then noisy paths (same count, aligned).
void* wavloader_create(const char* clean_paths, const char* noisy_paths,
                       int crop_len, int batch_size, int n_threads,
                       int queue_depth, uint64_t seed) {
    auto split = [](const char* s) {
        std::vector<std::string> out;
        std::string cur;
        for (const char* p = s; *p; ++p) {
            if (*p == '\n') {
                if (!cur.empty()) out.push_back(cur);
                cur.clear();
            } else {
                cur += *p;
            }
        }
        if (!cur.empty()) out.push_back(cur);
        return out;
    };
    auto* ld = new Loader();
    ld->clean_paths = split(clean_paths);
    ld->noisy_paths = split(noisy_paths);
    if (ld->clean_paths.empty() ||
        ld->clean_paths.size() != ld->noisy_paths.size()) {
        delete ld;
        return nullptr;
    }
    ld->crop_len = crop_len;
    ld->batch_size = batch_size;
    ld->n_threads = n_threads;
    ld->seed = seed;
    for (int i = 0; i < queue_depth; ++i) {
        auto* b = new Batch();
        b->clean.resize(static_cast<size_t>(batch_size) * crop_len);
        b->noisy.resize(static_cast<size_t>(batch_size) * crop_len);
        ld->pool.push_back(b);
    }
    for (int i = 0; i < n_threads; ++i)
        ld->workers.emplace_back(&Loader::worker, ld, i);
    return ld;
}

// Blocks until a batch is ready; copies into caller buffers of
// batch_size*crop_len floats each.  Returns 0 on success.
int wavloader_next(void* handle, float* clean_out, float* noisy_out) {
    auto* ld = static_cast<Loader*>(handle);
    Batch* b = nullptr;
    {
        std::unique_lock<std::mutex> l(ld->mu);
        ld->cv_ready.wait(l, [&] { return ld->stop.load() || !ld->ready.empty(); });
        if (ld->stop.load()) return 1;
        b = ld->ready.front();
        ld->ready.pop();
    }
    size_t n = static_cast<size_t>(ld->batch_size) * ld->crop_len;
    memcpy(clean_out, b->clean.data(), n * sizeof(float));
    memcpy(noisy_out, b->noisy.data(), n * sizeof(float));
    {
        std::lock_guard<std::mutex> l(ld->mu);
        ld->pool.push_back(b);
    }
    ld->cv_pool.notify_one();
    return 0;
}

void wavloader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Standalone single-file decode (for tests / the Python fallback check).
int wavloader_decode(const char* path, float* out, int max_len) {
    WavData w;
    if (!read_wav(path, &w)) return -1;
    int n = static_cast<int>(std::min<size_t>(w.samples.size(), max_len));
    memcpy(out, w.samples.data(), n * sizeof(float));
    return n;
}

}  // extern "C"
