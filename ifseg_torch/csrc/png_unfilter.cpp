// PNG row filters undone on the host (the one sequential loop of PNG decoding),
// and the CMYK to RGB conversion of `to_rgb`.
//
// `np.asarray(PIL.Image.open(...))` decodes the TSV rows of the JAX package's
// data pipeline; the port decodes them with `zlib` and this loop
// (`ifseg_torch/data/png.py`), so that the port depends on no image library.
// Each row of a PNG image starts with a filter byte (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth, PNG specification section 9). Average and Paeth read
// the pixel to the left once it is reconstructed, so a row is a chain of
// dependent bytes that numpy cannot vectorise; a Python loop costs about a
// second an image. `cmyk_to_rgb` is Pillow's Convert.c `cmyk2rgb`, which
// numpy runs as a chain of 16-bit temporaries about ten times slower. Built
// with the host C++ compiler at first use (`ifseg_torch/ops/build.py`) and
// called through ctypes, which releases the interpreter lock for the call.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

// raw: height rows of (1 filter byte + stride bytes), as zlib inflated them;
// out: height * stride bytes; bpp: bytes a complete pixel takes, at least 1.
// Returns 0, or the 1-based index of the first row whose filter byte is not
// 0..4.
extern "C" int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                                int64_t stride, int64_t bpp) {
    const uint8_t* prev = nullptr;  // the row above, reconstructed; none for row 0
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* src = raw + y * (stride + 1);
        const uint8_t filter = src[0];
        ++src;
        uint8_t* dst = out + y * stride;
        const int64_t lead = bpp < stride ? bpp : stride;
        switch (filter) {
            case 0:
                std::memcpy(dst, src, static_cast<size_t>(stride));
                break;
            case 1:
                std::memcpy(dst, src, static_cast<size_t>(lead));
                for (int64_t x = lead; x < stride; ++x) dst[x] = static_cast<uint8_t>(src[x] + dst[x - bpp]);
                break;
            case 2:
                if (prev == nullptr) {
                    std::memcpy(dst, src, static_cast<size_t>(stride));
                } else {
                    for (int64_t x = 0; x < stride; ++x) dst[x] = static_cast<uint8_t>(src[x] + prev[x]);
                }
                break;
            case 3:
                for (int64_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? dst[x - bpp] : 0;
                    const int up = prev != nullptr ? prev[x] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (int64_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? dst[x - bpp] : 0;
                    const int up = prev != nullptr ? prev[x] : 0;
                    const int corner = (prev != nullptr && x >= bpp) ? prev[x - bpp] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + paeth(left, up, corner));
                }
                break;
            default:
                return y + 1;
        }
        prev = dst;
    }
    return 0;
}

// in: n pixels of C, M, Y, K bytes; out: n pixels of R, G, B bytes, each
// (255 - K) - (255 - K) * C / 255 rounded as Pillow's MULDIV255.
extern "C" void cmyk_to_rgb(const uint8_t* in, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i, in += 4, out += 3) {
        const uint32_t nk = 255 - in[3];
        for (int c = 0; c < 3; ++c) {
            const uint32_t t = in[c] * nk + 128;
            out[c] = static_cast<uint8_t>(nk - (((t >> 8) + t) >> 8));
        }
    }
}
