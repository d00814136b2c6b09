// Native EXR IO bridge over the system OpenEXR (full compression coverage:
// DWA/PIZ/ZIP/...): the port's copy of nmf_tpu/native/exrio.cpp. The
// numpy reader in nmf_tpu_torch/data/exr.py covers NONE/ZIPS/ZIP without
// this library; this shim exists so files in the other compressions (RLE,
// PIZ, PXR24, B44, DWA) load too. Host code, built with g++ by
// nmf_tpu_torch/data/exr_native.py at first use; no part of it runs on the
// card.
#include <ImfRgbaFile.h>
#include <ImfArray.h>
#include <ImfHeader.h>
#include <ImathBox.h>

#include <cstring>
#include <string>

using namespace Imf;
using namespace Imath;

extern "C" {

// Returns 0 on success and fills (w, h); negative on failure.
int exr_read_size(const char* path, int* w, int* h) {
    try {
        RgbaInputFile file(path);
        Box2i dw = file.dataWindow();
        *w = dw.max.x - dw.min.x + 1;
        *h = dw.max.y - dw.min.y + 1;
        return 0;
    } catch (...) {
        return -1;
    }
}

// out must hold w*h*4 floats (RGBA). Returns 0 on success.
int exr_read_rgba(const char* path, float* out, int w, int h) {
    try {
        RgbaInputFile file(path);
        Box2i dw = file.dataWindow();
        int fw = dw.max.x - dw.min.x + 1;
        int fh = dw.max.y - dw.min.y + 1;
        if (fw != w || fh != h) return -2;
        Array2D<Rgba> px(fh, fw);
        file.setFrameBuffer(&px[0][0] - dw.min.x - dw.min.y * fw, 1, fw);
        file.readPixels(dw.min.y, dw.max.y);
        for (int y = 0; y < fh; ++y) {
            for (int x = 0; x < fw; ++x) {
                const Rgba& p = px[y][x];
                float* o = out + 4 * (y * (size_t)fw + x);
                o[0] = p.r; o[1] = p.g; o[2] = p.b; o[3] = p.a;
            }
        }
        return 0;
    } catch (...) {
        return -1;
    }
}

// rgb: w*h*c floats with c in {1, 3, 4}; compression: 0=none, 2=zips,
// 3=zip, 4=piz, 9=dwab. Returns 0 on success.
int exr_write_rgba(const char* path, const float* rgb, int w, int h, int c,
                   int compression) {
    try {
        Array2D<Rgba> px(h, w);
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const float* s = rgb + c * (y * (size_t)w + x);
                Rgba& p = px[y][x];
                if (c == 1) { p.r = p.g = p.b = s[0]; p.a = 1.f; }
                else { p.r = s[0]; p.g = s[1]; p.b = s[2];
                       p.a = (c == 4) ? s[3] : 1.f; }
            }
        }
        Header hdr(w, h);
        hdr.compression() = (Compression)compression;
        RgbaOutputFile file(path, hdr,
                            c == 4 ? WRITE_RGBA : WRITE_RGB);
        file.setFrameBuffer(&px[0][0], 1, w);
        file.writePixels(h);
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
