// Native data loader of the port: multithreaded JPEG batch decode (a copy of
// the top-level csrc/dataio.cpp of ocl_tpu, so that the two packages decode
// the same pixels).
//
// CORe50 materializes thousands of 128x128 JPEGs per task on the host
// (reference continuum/dataset_scripts/core50.py:100-158 decodes them one by
// one through PIL on the Python thread). This C++ loader decodes a batch of
// files into a caller-provided uint8 [n, h, w, 3] buffer with a thread pool.
// It is host code, not a device kernel.
//
// Built at first use by ocl_tpu_torch/data/native_io.py:
//   g++ -O2 -shared -fPIC -o libdataio_<hash>.so dataio.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

// Returns 0 on success, nonzero error code otherwise.
int decode_one(const char* path, int h, int w, unsigned char* dst) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;

    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(f);
        return 3;  // corrupt stream
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_width) != w ||
        static_cast<int>(cinfo.output_height) != h ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        std::fclose(f);
        return 2;  // unexpected geometry — caller falls back to PIL
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = dst + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
}

}  // namespace

extern "C" {

// paths: n C strings; out: uint8 [n, h, w, 3]. Returns the number of files
// that failed to decode (their slots are zero-filled).
int decode_jpeg_batch(const char** paths, int n, int h, int w,
                      unsigned char* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0);
    std::atomic<int> failures(0);
    const size_t stride = static_cast<size_t>(h) * w * 3;

    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            unsigned char* dst = out + stride * i;
            if (decode_one(paths[i], h, w, dst) != 0) {
                std::memset(dst, 0, stride);
                failures.fetch_add(1);
            }
        }
    };

    std::vector<std::thread> pool;
    int workers = n_threads < n ? n_threads : n;
    for (int t = 0; t < workers; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return failures.load();
}

}  // extern "C"
