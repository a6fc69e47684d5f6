// Multi-threaded JPEG/PNG decode + resize + center-crop for the host data
// path.
//
// Native counterpart of the reference's PIL-based dataset loading
// (reference: dataset/base_segmentation_dataset.py, dataset/voc.py — PIL
// Image.open/resize per sample inside DataLoader workers).  On a TPU host
// the Python/PIL decode of a 512² batch costs more than the train step
// itself; this pool decodes a whole batch in parallel with a plain C ABI
// for ctypes.
//
// Semantics (matching bacs_tpu/data/datasets.py:_load_pair):
//   - scale the short side to `size` (nw = max(size, round(w*scale)) etc.)
//   - images: bilinear with half-pixel centers, RGB uint8
//   - labels: nearest (src = floor((i+0.5)*in/out)), raw palette/gray index
//   - center crop to [size, size]
//
// Build: g++ -O3 -march=native -shared -fPIC fastdecode.cpp -o
//        libfastdecode.so -ljpeg -lpng
//
// Return codes: 0 ok, <0 per-image failure count (callers fall back to PIL).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
    std::vector<uint8_t> data;  // h * w * channels
    int w = 0, h = 0, channels = 0;
};

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->channels = 3;
    out->data.resize(size_t(out->w) * out->h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// ----------------------------------------------------------------- PNG ----

// expand_rgb: true → RGB image output; false → raw index/gray (labels)
bool decode_png(FILE* f, Image* out, bool expand_rgb) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);

    if (expand_rgb) {
        if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
        if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
            png_set_gray_to_rgb(png);
        if (depth == 16) png_set_strip_16(png);
        if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
        png_set_strip_alpha(png);
        out->channels = 3;
    } else {
        // labels: keep raw palette indices / gray values, 8-bit
        if (depth < 8) png_set_packing(png);
        if (depth == 16) png_set_strip_16(png);
        png_set_strip_alpha(png);
        out->channels = 1;
        if (color != PNG_COLOR_TYPE_PALETTE && color != PNG_COLOR_TYPE_GRAY) {
            png_destroy_read_struct(&png, &info, nullptr);
            return false;  // RGB label png unsupported — PIL fallback
        }
    }
    png_read_update_info(png, info);
    size_t rowbytes = png_get_rowbytes(png, info);
    if (rowbytes < size_t(w) * out->channels) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    out->w = int(w);
    out->h = int(h);
    out->data.resize(size_t(w) * h * out->channels);
    std::vector<uint8_t> rowbuf(rowbytes);
    for (png_uint_32 y = 0; y < h; ++y) {
        png_read_row(png, rowbuf.data(), nullptr);
        std::memcpy(out->data.data() + size_t(y) * w * out->channels,
                    rowbuf.data(), size_t(w) * out->channels);
    }
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool decode_file(const char* path, Image* out, bool expand_rgb) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[8] = {0};
    size_t got = std::fread(magic, 1, 8, f);
    std::rewind(f);
    bool ok = false;
    if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
        ok = decode_jpeg(f, out);
        if (ok && !expand_rgb) ok = false;  // jpeg labels unsupported
    } else if (got >= 8 && magic[0] == 0x89 && magic[1] == 'P') {
        ok = decode_png(f, out, expand_rgb);
    }
    std::fclose(f);
    return ok;
}

// --------------------------------------------------------------- resize ----

void geometry(int w, int h, int size, int* nw, int* nh, int* left, int* top) {
    double scale = double(size) / std::min(w, h);
    *nw = std::max(size, int(std::lround(w * scale)));
    *nh = std::max(size, int(std::lround(h * scale)));
    *left = (*nw - size) / 2;
    *top = (*nh - size) / 2;
}

// PIL-style BILINEAR resampling: separable triangle filter whose support
// scales with the downscale ratio (anti-aliased), matching PIL's
// ImagingResample semantics in float precision.
struct Taps {
    std::vector<int> lo;      // first source index per output pixel
    std::vector<int> n;       // tap count per output pixel
    std::vector<double> w;    // kmax weights per output pixel (normalized)
    int kmax = 0;
};

Taps build_taps(int in_dim, int out_full, int crop_off, int crop_n) {
    Taps t;
    const double scale = double(in_dim) / out_full;
    const double filterscale = std::max(scale, 1.0);
    const double support = 1.0 * filterscale;  // triangle filter support
    t.kmax = int(std::ceil(support)) * 2 + 1;
    t.lo.resize(crop_n);
    t.n.resize(crop_n);
    t.w.assign(size_t(crop_n) * t.kmax, 0.0);
    for (int o = 0; o < crop_n; ++o) {
        const double center = (o + crop_off + 0.5) * scale;
        int xmin = std::max(0, int(center - support + 0.5));
        int xmax = std::min(in_dim, int(center + support + 0.5));
        double sum = 0.0;
        for (int x = xmin; x < xmax; ++x) {
            double arg = (x + 0.5 - center) / filterscale;
            double ww = arg < 0 ? 1.0 + arg : 1.0 - arg;
            if (ww < 0) ww = 0;
            t.w[size_t(o) * t.kmax + (x - xmin)] = ww;
            sum += ww;
        }
        if (sum > 0) {
            for (int k = 0; k < xmax - xmin; ++k)
                t.w[size_t(o) * t.kmax + k] /= sum;
        }
        t.lo[o] = xmin;
        t.n[o] = xmax - xmin;
    }
    return t;
}

void resize_bilinear_crop(const Image& src, int size, uint8_t* out) {
    int nw, nh, left, top;
    geometry(src.w, src.h, size, &nw, &nh, &left, &top);
    const int C = src.channels;
    const Taps tx = build_taps(src.w, nw, left, size);
    const Taps ty = build_taps(src.h, nh, top, size);
    // horizontal pass over all source rows → [src.h, size, C] float
    std::vector<float> tmp(size_t(src.h) * size * C);
    for (int y = 0; y < src.h; ++y) {
        const uint8_t* row = &src.data[size_t(y) * src.w * C];
        float* trow = &tmp[size_t(y) * size * C];
        for (int o = 0; o < size; ++o) {
            const double* w = &tx.w[size_t(o) * tx.kmax];
            const int lo = tx.lo[o], n = tx.n[o];
            for (int c = 0; c < C; ++c) {
                double acc = 0;
                for (int k = 0; k < n; ++k)
                    acc += w[k] * row[(lo + k) * C + c];
                trow[o * C + c] = float(acc);
            }
        }
    }
    // vertical pass
    for (int o = 0; o < size; ++o) {
        const double* w = &ty.w[size_t(o) * ty.kmax];
        const int lo = ty.lo[o], n = ty.n[o];
        uint8_t* orow = out + size_t(o) * size * C;
        for (int x = 0; x < size * C; ++x) {
            double acc = 0;
            for (int k = 0; k < n; ++k)
                acc += w[k] * tmp[size_t(lo + k) * size * C + x];
            acc = std::min(std::max(acc, 0.0), 255.0);
            orow[x] = uint8_t(std::lround(acc));
        }
    }
}

void resize_nearest_crop(const Image& src, int size, uint8_t* out) {
    int nw, nh, left, top;
    geometry(src.w, src.h, size, &nw, &nh, &left, &top);
    const double sx = double(src.w) / nw, sy = double(src.h) / nh;
    for (int oy = 0; oy < size; ++oy) {
        int y = std::min(int((oy + top + 0.5) * sy), src.h - 1);
        for (int ox = 0; ox < size; ++ox) {
            int x = std::min(int((ox + left + 0.5) * sx), src.w - 1);
            out[size_t(oy) * size + ox] = src.data[size_t(y) * src.w + x];
        }
    }
}

}  // namespace

extern "C" {

// Decode one (image, label) pair into canonical [size,size] buffers.
// Returns 0 on success, -1 on any failure (caller falls back to PIL).
int decode_pair(const char* img_path, const char* lbl_path, int size,
                uint8_t* out_img, uint8_t* out_lbl) {
    Image img, lbl;
    if (!decode_file(img_path, &img, /*expand_rgb=*/true)) return -1;
    if (!decode_file(lbl_path, &lbl, /*expand_rgb=*/false)) return -1;
    resize_bilinear_crop(img, size, out_img);
    resize_nearest_crop(lbl, size, out_lbl);
    return 0;
}

// Parallel batch decode. Path arrays are NUL-separated concatenations with
// explicit byte offsets. Returns the number of FAILED pairs (0 = all ok);
// failed slots are left zeroed for the caller to patch via PIL.
int decode_batch(const char* img_paths, const int64_t* img_offsets,
                 const char* lbl_paths, const int64_t* lbl_offsets,
                 int64_t n, int size, int n_threads, uint8_t* out_imgs,
                 uint8_t* out_lbls, uint8_t* failed) {
    if (n_threads <= 0) {
        n_threads = int(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 1;
    }
    n_threads = int(std::min<int64_t>(n_threads, n));
    std::atomic<int64_t> next(0);
    std::atomic<int> failures(0);
    auto worker = [&]() {
        while (true) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            int rc = decode_pair(
                img_paths + img_offsets[i], lbl_paths + lbl_offsets[i], size,
                out_imgs + size_t(i) * size * size * 3,
                out_lbls + size_t(i) * size * size);
            failed[i] = rc == 0 ? 0 : 1;
            if (rc != 0) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return failures.load();
}

}  // extern "C"
