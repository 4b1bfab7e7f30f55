// Native data-pipeline core: parallel zero-padded batch collation.
//
// Replaces the copy work torch's C++ DataLoader workers do for the reference
// (dataloader.py custom_collate + pinned-memory transfer): N decoded clips
// of ragged temporal length are memcpy'd into one contiguous zero-filled
// (B, T, H, W, C) uint8 batch buffer. Runs a small thread pool and releases
// the Python GIL at the ctypes boundary, overlapping collation with decode.
//
// Build: g++ -O3 -march=native -shared -fPIC -o collate.so collate.cpp -lpthread
// (driven by picklebot_tpu_torch/data/native.py through utils/build.py,
// which builds on first use into picklebot_tpu_torch/_build/)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// dst: (batch, t_out, frame_bytes) zero-initialized
// srcs[i]: pointer to clip i, (t_i, frame_bytes) contiguous
// t_lens[i]: t_i
int collate_u8(uint8_t* dst, const uint8_t** srcs, const int64_t* t_lens,
               int64_t batch, int64_t t_out, int64_t frame_bytes,
               int num_threads) {
    if (batch <= 0 || t_out <= 0 || frame_bytes <= 0) return -1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= batch) break;
            int64_t t_i = t_lens[i] < t_out ? t_lens[i] : t_out;
            std::memcpy(dst + i * t_out * frame_bytes, srcs[i],
                        (size_t)(t_i * frame_bytes));
            // tail beyond t_i stays zero (caller provides zeroed dst)
        }
    };
    if (num_threads <= 1 || batch == 1) {
        worker();
        return 0;
    }
    std::vector<std::thread> pool;
    int n = num_threads < (int)batch ? num_threads : (int)batch;
    pool.reserve(n);
    for (int t = 0; t < n; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
