// Native dataset loader: minimal PNG decoder + prefetching frame loader.
//
// The reference relies on OpenCV imread on the hot dataset path
// (examples/main_TUM.cpp:230-260, examples/main_CAPE.cpp:48-65).  At the
// engine's target frame rates the Python/PIL decode path becomes the host
// bottleneck, so this C++ loader decodes TUM-style PNGs (8-bit gray/RGB color
// images and 16-bit grayscale depth) straight into float32 buffers with a worker
// thread pool prefetching ahead of the device pipeline.
//
// Exposed via a C ABI consumed by ctypes (rgbd_slam/io/native_loader.py).
// Zero third-party deps beyond zlib.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Image {
    int width = 0;
    int height = 0;
    int channels = 0;   // 1 or 3
    int bit_depth = 0;  // 8 or 16
    std::vector<uint16_t> pixels;  // row-major, channel-interleaved
};

uint32_t read_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Decode a PNG file (color types 0=gray, 2=rgb; bit depths 8/16; no interlace).
bool decode_png(const std::string& path, Image& out) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data(size);
    if (fread(data.data(), 1, size, f) != size_t(size)) {
        fclose(f);
        return false;
    }
    fclose(f);

    static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (size < 8 || memcmp(data.data(), magic, 8) != 0) return false;

    int width = 0, height = 0, bit_depth = 0, color_type = 0;
    std::vector<uint8_t> idat;
    size_t pos = 8;
    while (pos + 8 <= data.size()) {
        uint32_t len = read_be32(&data[pos]);
        const char* type = reinterpret_cast<const char*>(&data[pos + 4]);
        const uint8_t* payload = &data[pos + 8];
        if (pos + 12 + len > data.size()) return false;
        if (memcmp(type, "IHDR", 4) == 0) {
            width = read_be32(payload);
            height = read_be32(payload + 4);
            bit_depth = payload[8];
            color_type = payload[9];
            if (payload[12] != 0) return false;  // interlaced unsupported
        } else if (memcmp(type, "IDAT", 4) == 0) {
            idat.insert(idat.end(), payload, payload + len);
        } else if (memcmp(type, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + len;
    }
    if (width <= 0 || height <= 0) return false;
    if (color_type != 0 && color_type != 2) return false;  // gray or rgb only
    if (bit_depth != 8 && bit_depth != 16) return false;

    const int channels = (color_type == 2) ? 3 : 1;
    const int bytes_per_sample = bit_depth / 8;
    const size_t stride = size_t(width) * channels * bytes_per_sample;
    std::vector<uint8_t> raw((stride + 1) * height);

    uLongf raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
        return false;

    // unfilter
    const int bpp = channels * bytes_per_sample;
    std::vector<uint8_t> cur(stride, 0), prev(stride, 0);
    out.width = width;
    out.height = height;
    out.channels = channels;
    out.bit_depth = bit_depth;
    out.pixels.resize(size_t(width) * height * channels);

    for (int y = 0; y < height; ++y) {
        const uint8_t* line = &raw[size_t(y) * (stride + 1)];
        uint8_t filter = line[0];
        const uint8_t* src = line + 1;
        for (size_t x = 0; x < stride; ++x) {
            int a = (x >= size_t(bpp)) ? cur[x - bpp] : 0;
            int b = prev[x];
            int c = (x >= size_t(bpp)) ? prev[x - bpp] : 0;
            int v = src[x];
            switch (filter) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) / 2; break;
                case 4: v += paeth(a, b, c); break;
                default: return false;
            }
            cur[x] = uint8_t(v);
        }
        // samples to uint16
        uint16_t* dst = &out.pixels[size_t(y) * width * channels];
        if (bytes_per_sample == 1) {
            for (int i = 0; i < width * channels; ++i) dst[i] = cur[i];
        } else {
            for (int i = 0; i < width * channels; ++i)
                dst[i] = (uint16_t(cur[2 * i]) << 8) | cur[2 * i + 1];
        }
        std::swap(cur, prev);
    }
    return true;
}

struct Frame {
    std::vector<float> gray;
    std::vector<float> depth;
    int width = 0, height = 0;
    bool ok = false;
};

struct Loader {
    std::vector<std::string> rgb_paths;
    std::vector<std::string> depth_paths;
    float depth_scale = 0.2f;  // TUM: 1/5 to millimeters (main_TUM.cpp:242)
    int prefetch_ahead = 8;

    std::unordered_map<int, Frame> cache;
    std::deque<int> pending;
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};

    void worker_loop() {
        for (;;) {
            int idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [&] { return stop || !pending.empty(); });
                if (stop) return;
                idx = pending.front();
                pending.pop_front();
            }
            Frame fr = load_frame(idx);
            {
                std::unique_lock<std::mutex> lk(mu);
                cache[idx] = std::move(fr);
            }
            cv_done.notify_all();
        }
    }

    Frame load_frame(int idx) {
        Frame fr;
        Image rgb, depth;
        if (!decode_png(rgb_paths[idx], rgb) ||
            !decode_png(depth_paths[idx], depth))
            return fr;
        fr.width = rgb.width;
        fr.height = rgb.height;
        fr.gray.resize(size_t(rgb.width) * rgb.height);
        if (rgb.channels == 3) {
            for (size_t i = 0; i < fr.gray.size(); ++i) {
                // BT.601 luma like cv::cvtColor BGR2GRAY (rgbd_slam.cpp:118)
                const uint16_t* p = &rgb.pixels[3 * i];
                fr.gray[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
            }
        } else {
            for (size_t i = 0; i < fr.gray.size(); ++i)
                fr.gray[i] = float(rgb.pixels[i]);
        }
        fr.depth.resize(size_t(depth.width) * depth.height);
        for (size_t i = 0; i < fr.depth.size(); ++i)
            fr.depth[i] = float(depth.pixels[i]) * depth_scale;
        fr.ok = true;
        return fr;
    }

    void request(int idx) {
        std::unique_lock<std::mutex> lk(mu);
        if (cache.count(idx)) return;
        for (int p : pending)
            if (p == idx) return;
        pending.push_back(idx);
        cv_work.notify_one();
    }
};

}  // namespace

extern "C" {

void* loader_create(const char** rgb_paths, const char** depth_paths, int n,
                    int workers, float depth_scale) {
    auto* l = new Loader();
    l->rgb_paths.assign(rgb_paths, rgb_paths + n);
    l->depth_paths.assign(depth_paths, depth_paths + n);
    l->depth_scale = depth_scale;
    int w = workers > 0 ? workers : 2;
    for (int i = 0; i < w; ++i)
        l->workers.emplace_back([l] { l->worker_loop(); });
    return l;
}

// Blocking fetch of frame idx into caller-provided buffers; also schedules
// prefetch of the next frames.  Returns 1 on success.
int loader_get(void* handle, int idx, float* gray_out, float* depth_out,
               int expected_h, int expected_w) {
    auto* l = static_cast<Loader*>(handle);
    if (idx < 0 || size_t(idx) >= l->rgb_paths.size()) return 0;
    l->request(idx);
    for (int ahead = 1; ahead <= l->prefetch_ahead; ++ahead)
        if (size_t(idx + ahead) < l->rgb_paths.size()) l->request(idx + ahead);

    Frame fr;
    {
        std::unique_lock<std::mutex> lk(l->mu);
        l->cv_done.wait(lk, [&] { return l->cache.count(idx) > 0; });
        fr = std::move(l->cache[idx]);
        l->cache.erase(idx);
        // drop stale entries far behind the cursor
        for (auto it = l->cache.begin(); it != l->cache.end();) {
            if (it->first < idx - 2) it = l->cache.erase(it);
            else ++it;
        }
    }
    if (!fr.ok || fr.height != expected_h || fr.width != expected_w) return 0;
    memcpy(gray_out, fr.gray.data(), fr.gray.size() * sizeof(float));
    memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(float));
    return 1;
}

void loader_destroy(void* handle) {
    auto* l = static_cast<Loader*>(handle);
    l->stop = true;
    l->cv_work.notify_all();
    for (auto& t : l->workers) t.join();
    delete l;
}

// Standalone single-image decode (for tests / simple use).
int decode_png_file(const char* path, float* out, int expected_h, int expected_w,
                    int to_gray, float scale) {
    Image img;
    if (!decode_png(path, img)) return 0;
    if (img.height != expected_h || img.width != expected_w) return 0;
    size_t n = size_t(img.width) * img.height;
    if (to_gray && img.channels == 3) {
        for (size_t i = 0; i < n; ++i) {
            const uint16_t* p = &img.pixels[3 * i];
            out[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) * scale;
        }
    } else if (img.channels == 1) {
        for (size_t i = 0; i < n; ++i) out[i] = float(img.pixels[i]) * scale;
    } else {
        return 0;
    }
    return 1;
}

}  // extern "C"
