// PNG row filters undone on the host (the one sequential loop of PNG decoding),
// and the CMYK and Lab to RGB conversions of `to_rgb`.
//
// `np.asarray(PIL.Image.open(...))` decodes the TSV rows of the JAX package's
// data pipeline; the port decodes them with `zlib` and this loop
// (`ifseg_torch/data/png.py`), so that the port depends on no image library.
// Each row of a PNG image starts with a filter byte (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth, PNG specification section 9). Average and Paeth read
// the pixel to the left once it is reconstructed, so a row is a chain of
// dependent bytes that numpy cannot vectorise; a Python loop costs about a
// second an image. `cmyk_to_rgb` is Pillow's Convert.c `cmyk2rgb`, which
// numpy runs as a chain of 16-bit temporaries about ten times slower.
// `lab_to_rgb` is LittleCMS's tetrahedral interpolation of the 16-bit grid
// that `ifseg_torch/data/lab.py` computes (cmsintrp.c `Eval3Inputs`). Built
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

// in: n pixels of L, a, b bytes as PIL stores them (LittleCMS's 8-bit input);
// out: n pixels of R, G, B bytes; grid: (g, g, g, 3) uint16 nodes indexed L,
// a, b. Each byte is read as v * 257 (FROM_8_TO_16), placed on the grid in
// 16.16 fixed point (_cmsToFixedDomain), interpolated over the tetrahedron
// its three fractions pick, largest first, with LittleCMS's rounding of
// the int32 sum, and written as FROM_16_TO_8.
extern "C" void lab_to_rgb(const uint8_t* in, uint8_t* out, int64_t n, const uint16_t* grid,
                           int64_t g) {
    const int64_t opta[3] = {3 * g * g, 3 * g, 3};  // the strides of L, a and b
    for (int64_t i = 0; i < n; ++i, in += 3, out += 3) {
        int64_t base = 0, step[3];
        int32_t rest[3];
        for (int d = 0; d < 3; ++d) {
            const int32_t v = in[d] * 257;
            const int32_t a = v * static_cast<int32_t>(g - 1);
            const int32_t f = a + (a + 0x7fff) / 0xffff;
            base += (f >> 16) * opta[d];
            rest[d] = f & 0xffff;
            step[d] = v == 0xffff ? 0 : opta[d];
        }
        // the dimensions by their fraction, largest first (ties in L, a, b order)
        int o[3] = {0, 1, 2};
        for (int x = 0; x < 2; ++x)
            for (int y = 0; y < 2 - x; ++y)
                if (rest[o[y]] < rest[o[y + 1]]) {
                    const int t = o[y];
                    o[y] = o[y + 1];
                    o[y + 1] = t;
                }
        const int64_t k1 = step[o[0]], k2 = k1 + step[o[1]], k3 = k2 + step[o[2]];
        const uint16_t* p = grid + base;
        for (int c = 0; c < 3; ++c) {
            const int32_t c0 = p[c], c1 = p[k1 + c], c2 = p[k2 + c], c3 = p[k3 + c];
            // LittleCMS sums in int32: wrap as it does
            const int64_t wide = int64_t{c1 - c0} * rest[o[0]] + int64_t{c2 - c1} * rest[o[1]] +
                                 int64_t{c3 - c2} * rest[o[2]] + 0x8001;
            const int32_t sum = static_cast<int32_t>(static_cast<uint32_t>(wide));
            const int32_t t = static_cast<int32_t>(static_cast<uint32_t>(sum) +
                                                   static_cast<uint32_t>(sum >> 16));
            const uint32_t w = static_cast<uint16_t>(c0 + (t >> 16));
            out[c] = static_cast<uint8_t>(((w * 65281u + 8388608u) >> 24) & 0xff);
        }
    }
}
