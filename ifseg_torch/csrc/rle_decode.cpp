// The run-length and op-stream loops of PIL's raw image formats on the host,
// each as PIL 12.1's own decoder runs it (`ifseg_torch/data/{tga,sgi,pcx,
// qoi,dds}.py` parse the headers around them and unpack the rows with numpy):
//
//   tga_rle  TgaRleDecode.c: a packet byte, bit 7 a run of (low 7 bits + 1)
//            copies of one pixel, else as many literal pixels; a literal runs
//            on across rows, a run that passes its row's end ends the image;
//            only whole rows are written
//   sgi_rle  SgiRleDecode.c: one RLE row a channel at the offset and with the
//            length the file's tables give (8- or 16-bit words); the row
//            buffer is not cleared between rows, a bad row ends the image
//   pcx_rle  PcxDecode.c: 0xC0 | n repeats the next byte n times (cut at the
//            row's end), any other byte is itself; PIL's move of a row's
//            planes to be contiguous; and
//            PcxEncode.c's runs, plane by plane
//   qoi      QoiImagePlugin.py's QoiDecoder and QoiEncoder, op for op (its
//            index table starts empty when decoding, {0: (0, 0, 0, 0)} when
//            encoding)
//   sun_rle  SunRleDecode.c: a Sun raster file's byte-encoded rows
//   im_bits  BitDecode.c: the 2- to 31-bit samples of an IM file's "L*n" types
//   bcn      BcnDecode.c: BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4, BC5
//            (unsigned and signed), BC6H (unsigned and signed, each half
//            float clamped to 0..1 and truncated to 8 bits) and BC7 4 x 4
//            blocks, whole blocks only, after the format's published
//            description (its mode, partition, anchor and weight tables)
//
// Built with the host C++ compiler at first use (`ifseg_torch/ops/build.py`)
// and called through ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>

extern "C" {

// tga_rle: rows of row_bytes bytes in file order, pixels of `depth` bytes;
// returns the whole rows written.
int64_t tga_rle(const uint8_t* in, int64_t n, uint8_t* out, int64_t rows, int64_t row_bytes,
                int64_t depth) {
    if (depth <= 0 || row_bytes <= 0) return 0;
    int64_t pos = 0, at = 0;
    const int64_t total = rows * row_bytes;
    while (at < total && pos < n) {
        const int64_t count = depth * ((in[pos] & 0x7f) + 1);
        if (in[pos] & 0x80) {
            if (n - pos < 1 + depth) break;
            if (at % row_bytes + count > row_bytes) break;  // PIL's overrun: the image ends
            for (int64_t i = 0; i < count; i += depth, at += depth) {
                std::memcpy(out + at, in + pos + 1, static_cast<size_t>(depth));
            }
            pos += 1 + depth;
        } else {
            if (n - pos < 1 + count) break;
            const int64_t k = count < total - at ? count : total - at;
            std::memcpy(out + at, in + pos + 1, static_cast<size_t>(k));
            at += k;
            pos += 1 + count;
        }
    }
    return at / row_bytes;
}

namespace {

// SgiRleDecode.c expandrow / expandrow2: 0 at the end marker, 1 where the
// length ran out on a live packet, -1 for an overrun
int sgi_row(uint8_t* dest, const uint8_t* src, int64_t n, int64_t z, int64_t xsize,
            const uint8_t* end, int64_t word) {
    int64_t x = 0;
    for (; n > 0; --n) {
        if (src + (word - 1) > end) return -1;
        const uint8_t pixel = src[word - 1];
        src += word;
        if (n == 1 && pixel != 0) return 1;
        int count = pixel & 0x7f;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (src + word * count > end) return -1;
            while (count--) {
                std::memcpy(dest, src, static_cast<size_t>(word));
                src += word;
                dest += z * word;
            }
        } else {
            if (word == 1 ? src > end : src + 2 > end) return -1;
            while (count--) {
                std::memcpy(dest, src, static_cast<size_t>(word));
                dest += z * word;
            }
            src += word;
        }
    }
    return 0;
}

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

// sgi_rle: `body` is the file after its 512-byte header (n bytes); `out` gets
// ysize rows of xsize * bands words (bpc bytes each, interleaved) in file
// order.  Returns the rows stored, or -1 where the tables do not fit.
int64_t sgi_rle(const uint8_t* body, int64_t n, uint8_t* out, int64_t xsize, int64_t ysize,
                int64_t bands, int64_t bpc) {
    const int64_t tablen = bands * ysize;
    if (n < 8 * tablen) return -1;
    const int64_t row = xsize * bands * bpc;
    uint8_t* buffer = new uint8_t[static_cast<size_t>(row > 0 ? row : 1)]();
    int64_t y = 0;
    for (; y < ysize; ++y) {
        int status = 0;
        for (int64_t c = 0; c < bands; ++c) {
            int64_t offset = be32(body + 4 * (y + c * ysize));
            // PIL passes the length as an int: one of 2^31 or more is negative, no packet
            const int64_t length = int32_t(be32(body + 4 * (tablen + y + c * ysize)));
            if (offset < 512) {
                status = -1;
                break;
            }
            offset -= 512;
            status = sgi_row(buffer + c * bpc, body + offset, length, bands, xsize,
                             body + n - 1, bpc);
            if (status) break;
        }
        if (status) break;
        std::memcpy(out + y * row, buffer, static_cast<size_t>(row));
    }
    delete[] buffer;
    return y;
}

// pcx_rle: rows of row_bytes bytes (planes x the header's stride) in file
// order; `xsize` the width in pixels, `bits` those a pixel of PIL's unpacker
// (1, 2 or 4 for bit planes, 8, 24).  Returns the rows written.
int64_t pcx_rle(const uint8_t* in, int64_t n, uint8_t* out, int64_t rows, int64_t row_bytes,
                int64_t xsize, int64_t bits) {
    if (rows <= 0 || row_bytes <= 0) return 0;
    int64_t pos = 0, x = 0, y = 0;
    uint8_t* buffer = out;
    while (pos < n) {
        if ((in[pos] & 0xC0) == 0xC0) {
            if (n - pos < 2) break;
            for (int k = in[pos] & 0x3F; k > 0 && x < row_bytes; --k) buffer[x++] = in[pos + 1];
            pos += 2;
        } else {
            buffer[x++] = in[pos++];
        }
        if (x >= row_bytes) {
            // PIL's planes: `bands` of `stride` bytes moved to `line` bytes apart
            int64_t line = xsize, bands, stride = 0;
            if (bits == 2 || bits == 4) {
                line = (xsize + 7) / 8;
                bands = bits;
                stride = row_bytes / bits;
            } else {
                bands = row_bytes / xsize;
                if (bands) stride = row_bytes / bands;
            }
            if (stride > line) {
                for (int64_t i = 1; i < bands; ++i) {
                    std::memmove(buffer + i * line, buffer + i * stride, static_cast<size_t>(line));
                }
            }
            x = 0;
            if (++y >= rows) break;
            buffer = out + y * row_bytes;
        }
    }
    return y;
}

// pcx_encode: PcxEncode.c over h rows of `planes` planes of `line` bytes:
// each plane's runs of up to 63 bytes as 0xC0 | n and the byte (a lone byte
// below 0xC0 as itself), then `pad` zero bytes; at one byte a plane, the
// last plane of each row is not written, as in PIL.  `out` holds at least
// 2 * h * planes * (line + pad) bytes.  Returns the bytes written.
int64_t pcx_encode(const uint8_t* rows, int64_t h, int64_t planes, int64_t line, int64_t pad,
                   uint8_t* out) {
    int64_t o = 0;
    for (int64_t p = 0; p < h * planes; ++p) {
        // PcxEncode.c loads the last plane's one byte and stops before writing it
        if (line == 1 && planes > 1 && p % planes == planes - 1) continue;
        const uint8_t* src = rows + p * line;
        for (int64_t x = 0; x < line;) {
            int64_t k = 1;
            while (x + k < line && k < 63 && src[x + k] == src[x]) ++k;
            if (k == 1 && src[x] < 0xC0) {
                out[o++] = src[x];
            } else {
                out[o++] = uint8_t(0xC0 | k);
                out[o++] = src[x];
            }
            x += k;
        }
        for (int64_t i = 0; i < pad; ++i) out[o++] = 0;
    }
    return o;
}

// qoi_decode: npix pixels of `bands` (3 or 4) bytes from the op stream at
// in[0..n); returns 0, or -1 where the stream ends early (PIL raises).
int64_t qoi_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t npix, int64_t bands) {
    uint8_t seen[64][4];
    bool has[64] = {};
    uint8_t prev[4] = {0, 0, 0, 255};
    int64_t pos = 0, got = 0;
    const int64_t want = npix * bands;
    while (got < want) {
        if (pos >= n) return -1;
        const uint8_t byte = in[pos++];
        uint8_t v[4];
        if (byte == 0xFE) {
            if (n - pos < 3) return -1;
            v[0] = in[pos], v[1] = in[pos + 1], v[2] = in[pos + 2], v[3] = prev[3];
            pos += 3;
        } else if (byte == 0xFF) {
            if (n - pos < 4) return -1;
            std::memcpy(v, in + pos, 4);
            pos += 4;
        } else {
            const int op = byte >> 6;
            if (op == 0) {
                const int i = byte & 63;
                if (has[i]) {
                    std::memcpy(v, seen[i], 4);
                } else {
                    std::memset(v, 0, 4);
                }
            } else if (op == 1) {
                v[0] = uint8_t(prev[0] + ((byte >> 4) & 3) - 2);
                v[1] = uint8_t(prev[1] + ((byte >> 2) & 3) - 2);
                v[2] = uint8_t(prev[2] + (byte & 3) - 2);
                v[3] = prev[3];
            } else if (op == 2) {
                if (pos >= n) return -1;
                const uint8_t second = in[pos++];
                const int dg = (byte & 63) - 32;
                v[0] = uint8_t(prev[0] + dg + ((second >> 4) - 8));
                v[1] = uint8_t(prev[1] + dg);
                v[2] = uint8_t(prev[2] + dg + ((second & 15) - 8));
                v[3] = prev[3];
            } else {  // a run of the previous pixel; the table is left as it is
                for (int run = (byte & 63) + 1; run > 0 && got < want; --run) {
                    std::memcpy(out + got, prev, static_cast<size_t>(bands));
                    got += bands;
                }
                continue;
            }
        }
        std::memcpy(prev, v, 4);
        const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        std::memcpy(seen[h], v, 4);
        has[h] = true;
        std::memcpy(out + got, v, static_cast<size_t>(bands));
        got += bands;
    }
    return 0;
}

// qoi_encode: the op stream (no header) PIL writes for npix RGB pixels, its
// 8 bytes of padding included; `out` holds at least 4 * npix + 8 bytes.
// Returns the bytes written.
int64_t qoi_encode(const uint8_t* rgb, int64_t npix, uint8_t* out) {
    uint8_t seen[64][4];
    bool has[64] = {};
    std::memset(seen[0], 0, 4);
    has[0] = true;
    uint8_t prev[4] = {0, 0, 0, 255};
    int64_t o = 0;
    int run = 0;
    for (int64_t i = 0; i < npix; ++i) {
        const uint8_t px[4] = {rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], 255};
        if (std::memcmp(px, prev, 4) == 0) {
            if (++run == 62) {
                out[o++] = uint8_t(0xC0 | (run - 1));
                run = 0;
            }
            continue;
        }
        if (run) {
            out[o++] = uint8_t(0xC0 | (run - 1));
            run = 0;
        }
        const int h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
        if (has[h] && std::memcmp(seen[h], px, 4) == 0) {
            out[o++] = uint8_t(h);
        } else {
            std::memcpy(seen[h], px, 4);
            has[h] = true;
            // the alpha is 255 on both sides: no RGBA op
            const int dr = int8_t(uint8_t(px[0] - prev[0]));
            const int dg = int8_t(uint8_t(px[1] - prev[1]));
            const int db = int8_t(uint8_t(px[2] - prev[2]));
            if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
                out[o++] = uint8_t(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2));
            } else {
                const int dgr = int8_t(uint8_t(dr - dg)), dgb = int8_t(uint8_t(db - dg));
                if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
                    out[o++] = uint8_t(0x80 | (dg + 32));
                    out[o++] = uint8_t((dgr + 8) << 4 | (dgb + 8));
                } else {
                    out[o++] = 0xFE;
                    out[o++] = px[0], out[o++] = px[1], out[o++] = px[2];
                }
            }
        }
        std::memcpy(prev, px, 4);
    }
    if (run) out[o++] = uint8_t(0xC0 | (run - 1));
    static const uint8_t kPad[8] = {0, 0, 0, 0, 0, 0, 0, 1};
    std::memcpy(out + o, kPad, 8);
    return o + 8;
}

// im_bits: BitDecode.c with an IM file's arguments (`bits` of 2-31, bytes
// filled LSB first, values stored LSB first, unsigned, rows padded to a
// byte): rows of width float32 values in file order.  A row's end clears
// the bit count but not the bits left in the buffer, which the next byte
// is ORed onto, as in PIL.  Returns the whole rows written.
int64_t im_bits(const uint8_t* in, int64_t n, float* out, int64_t width, int64_t rows,
                int64_t bits) {
    if (bits < 1 || bits >= 32 || width <= 0) return 0;
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    uint64_t buffer = 0;
    int64_t count = 0, x = 0, y = 0;
    for (int64_t i = 0; i < n && y < rows; ++i) {
        buffer |= uint64_t(in[i]) << count;
        count += 8;
        while (count >= bits && y < rows) {
            out[y * width + x] = static_cast<float>(buffer & mask);
            buffer >>= bits;
            count -= bits;
            if (++x == width) {
                x = 0;
                ++y;
                count = 0;
            }
        }
    }
    return y;
}

// sun_rle: SunRleDecode.c: 0x80 0 is a literal 0x80, 0x80 n v n + 1 bytes
// v (a run goes on across rows), any other byte itself; rows of row_bytes
// bytes in file order, a row left unfinished 0.  Returns the whole rows
// written.
int64_t sun_rle(const uint8_t* in, int64_t n, uint8_t* out, int64_t rows, int64_t row_bytes) {
    if (row_bytes <= 0) return 0;
    const int64_t total = rows * row_bytes;
    int64_t pos = 0, at = 0;
    while (at < total && pos < n) {
        if (in[pos] != 0x80) {
            out[at++] = in[pos++];
        } else if (n - pos < 2) {
            break;
        } else if (in[pos + 1] == 0) {
            out[at++] = 0x80;
            pos += 2;
        } else {
            if (n - pos < 3) break;
            int64_t k = in[pos + 1] + 1;
            if (k > total - at) k = total - at;
            std::memset(out + at, in[pos + 2], static_cast<size_t>(k));
            at += k;
            pos += 3;
        }
    }
    std::memset(out + at / row_bytes * row_bytes, 0, static_cast<size_t>(at % row_bytes));
    return at / row_bytes;
}

namespace {

struct Rgba {
    uint8_t r, g, b, a;
};

Rgba decode_565(uint16_t v) {
    uint8_t r = uint8_t((v & 0xf800) >> 8), g = uint8_t((v & 0x07e0) >> 3);
    uint8_t b = uint8_t((v & 0x001f) << 3);
    r |= r >> 5;
    g |= g >> 6;
    b |= b >> 5;
    return {r, g, b, 255};
}

void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
    const uint16_t c0 = uint16_t(src[0] | src[1] << 8), c1 = uint16_t(src[2] | src[3] << 8);
    const uint32_t lut = uint32_t(src[4]) | uint32_t(src[5]) << 8 | uint32_t(src[6]) << 16 |
                         uint32_t(src[7]) << 24;
    Rgba p[4];
    p[0] = decode_565(c0);
    p[1] = decode_565(c1);
    const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
    if (c0 > c1 || separate_alpha) {
        p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
                uint8_t((2 * b0 + b1) / 3), 255};
        p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
                uint8_t((b0 + 2 * b1) / 3), 255};
    } else {
        p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
        p[3] = {0, 0, 0, 0};
    }
    for (int i = 0; i < 16; ++i) dst[i] = p[3 & (lut >> (2 * i))];
}

// a BC3 alpha block (BC4, BC5: a channel) into byte `o` of 16 pixels of
// `stride` bytes; `sign` reads the end points as int8 + 128 (BC5S)
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
    int a0, a1;
    if (sign) {
        a0 = int8_t(src[0]) + 128;
        a1 = int8_t(src[1]) + 128;
    } else {
        a0 = src[0];
        a1 = src[1];
    }
    const uint32_t lut1 = uint32_t(src[2]) | uint32_t(src[3]) << 8 | uint32_t(src[4]) << 16;
    const uint32_t lut2 = uint32_t(src[5]) | uint32_t(src[6]) << 8 | uint32_t(src[7]) << 16;
    uint8_t a[8];
    a[0] = uint8_t(a0);
    a[1] = uint8_t(a1);
    if (a0 > a1) {
        for (int i = 2; i < 8; ++i) a[i] = uint8_t(((8 - i) * a0 + (i - 1) * a1) / 7);
    } else {
        for (int i = 2; i < 6; ++i) a[i] = uint8_t(((6 - i) * a0 + (i - 1) * a1) / 5);
        a[6] = 0;
        a[7] = 255;
    }
    for (int i = 0; i < 8; ++i) dst[stride * i + o] = a[7 & (lut1 >> (3 * i))];
    for (int i = 0; i < 8; ++i) dst[stride * (8 + i) + o] = a[7 & (lut2 >> (3 * i))];
}

// BC7 and BC6H: the format's partition tables (bit n of a two-subset entry,
// bits 2n and 2n + 1 of a three-subset one, the subset of pixel n), the
// anchor pixels of subsets 1 and 2 and the interpolation weights
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8,  2,  2,  8,
    8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,
    2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,  3,  3,  8,  15, 3,  3,
    6,  10, 5,  8,  8,  6,  8,  5,  15, 15, 8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,
    15, 15, 15, 15, 3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8,  15, 3,  15, 8,
    15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15,
    3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
    return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int subsets, int partition, int n) {
    if (subsets == 2) return 1 & (kPartition2[partition] >> n);
    if (subsets == 3) return 3 & (kPartition3[partition] >> (2 * n));
    return 0;
}

// the pixel whose index is one bit short: 0 and each later subset's anchor
bool is_anchor(int subsets, int partition, int n) {
    if (n == 0) return true;
    if (subsets == 2) return n == kAnchor2[partition];
    if (subsets == 3) return n == kAnchor3a[partition] || n == kAnchor3b[partition];
    return false;
}

// `count` (at most 16) bits of the block from bit `at`, the low bit first
uint32_t bits_at(const uint8_t* src, int at, int count) {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i) v |= uint32_t((src[(at + i) >> 3] >> ((at + i) & 7)) & 1) << i;
    return v;
}

// BC7 modes 0-7: subsets, partition bits, rotation bits, index selection
// bit, colour bits, alpha bits, p-bit an end point, p-bit a subset, index
// bits, second index bits
struct Bc7Mode {
    int subsets, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

uint8_t bc7_expand(int v, int bits) {
    v <<= 8 - bits;
    return uint8_t(v | (v >> bits));
}

void bc7_block(Rgba* col, const uint8_t* src) {
    if (src[0] == 0) {  // no mode bit: a reserved block, opaque black
        for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
        return;
    }
    int mode = 0;
    while (!(src[0] & (1 << mode))) ++mode;
    const Bc7Mode& m = kBc7Modes[mode];
    int at = mode + 1;
    const int partition = int(bits_at(src, at, m.pb));
    at += m.pb;
    const int rotation = int(bits_at(src, at, m.rb));
    at += m.rb;
    const int index_sel = int(bits_at(src, at, m.isb));
    at += m.isb;
    const int ends = 2 * m.subsets;
    int ep[6][4];
    for (int c = 0; c < 3; ++c) {
        for (int e = 0; e < ends; ++e, at += m.cb) ep[e][c] = int(bits_at(src, at, m.cb));
    }
    for (int e = 0; e < ends; ++e) {
        ep[e][3] = m.ab ? int(bits_at(src, at, m.ab)) : 255;
        at += m.ab;
    }
    int cb = m.cb, ab = m.ab;
    if (m.epb || m.spb) {
        ++cb;
        if (ab) ++ab;
        for (int e = 0; e < ends; ++e) {
            if (m.spb && e % 2) continue;
            const int p = int(bits_at(src, at++, 1));
            for (int k = e; k < (m.spb ? e + 2 : e + 1); ++k) {
                for (int c = 0; c < (ab ? 4 : 3); ++c) ep[k][c] = ep[k][c] << 1 | p;
            }
        }
    }
    for (int e = 0; e < ends; ++e) {
        for (int c = 0; c < 3; ++c) ep[e][c] = bc7_expand(ep[e][c], cb);
        if (ab) ep[e][3] = bc7_expand(ep[e][3], ab);
    }
    const int* cw = weights(m.ib);
    const int* aw = weights(m.ab && m.ib2 ? m.ib2 : m.ib);
    int ci = at, ai = at + 16 * m.ib - m.subsets;
    for (int i = 0; i < 16; ++i) {
        const int s = 2 * subset_of(m.subsets, partition, i);
        const int ib = m.ib - (is_anchor(m.subsets, partition, i) ? 1 : 0);
        const int i0 = int(bits_at(src, ci, ib));
        ci += ib;
        int wc = cw[i0], wa = cw[i0];
        if (m.ab && m.ib2) {
            const int ib2 = m.ib2 - (i == 0 ? 1 : 0);
            const int i1 = int(bits_at(src, ai, ib2));
            ai += ib2;
            wc = index_sel ? aw[i1] : cw[i0];
            wa = index_sel ? cw[i0] : aw[i1];
        }
        int px[4];
        for (int c = 0; c < 4; ++c) {
            const int w = c == 3 ? wa : wc;
            px[c] = ((64 - w) * ep[s][c] + w * ep[s + 1][c] + 32) >> 6;
        }
        if (rotation) std::swap(px[rotation - 1], px[3]);
        col[i] = {uint8_t(px[0]), uint8_t(px[1]), uint8_t(px[2]), uint8_t(px[3])};
    }
}

// BC6H modes in the order of their mode bits ("00", "01", "00010" ...
// "11110", "00011" ... "01111"): subsets, transformed (delta) end points,
// the base end point's bits and the bits of the other end points' red,
// green and blue
struct Bc6Mode {
    int subsets, transformed, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, 5, 5, 5}, {2, 1, 7, 6, 6, 6},   {2, 1, 11, 5, 4, 4},   {2, 1, 11, 4, 5, 4},
    {2, 1, 11, 4, 4, 5}, {2, 1, 9, 5, 5, 5},   {2, 1, 8, 6, 5, 5},    {2, 1, 8, 5, 6, 5},
    {2, 1, 8, 5, 5, 6},  {2, 0, 6, 6, 6, 6},   {1, 0, 10, 10, 10, 10}, {1, 1, 11, 9, 9, 9},
    {1, 1, 12, 8, 8, 8}, {1, 1, 16, 4, 4, 4}};
// the end point bits after the mode bits, in stream order, each as
// (end point value 0-11: r, g, b of end points 0-3) << 4 | bit
const uint8_t kBc6Layout[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}
};

int sign_extend(int v, int bits) {
    v &= (1 << bits) - 1;
    return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
    if (!sign) {
        if (bits >= 15 || v == 0) return v;
        if (v == (1 << bits) - 1) return 0xffff;
        return ((v << 15) + 0x4000) >> (bits - 1);
    }
    v = int16_t(uint16_t(v));  // PIL keeps the end points in 16 bits
    if (bits >= 16) return v;
    const bool neg = v < 0;
    int x = neg ? -v : v;
    if (x != 0) x = x >= (1 << (bits - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (bits - 1);
    return neg ? -x : x;
}

// the 16-bit half float of an interpolated value, to float as PIL widens it
float bc6_float(int v, bool sign) {
    uint16_t h;
    if (sign) {
        h = v < 0 ? uint16_t(0x8000 | ((-v) * 31 / 32)) : uint16_t(v * 31 / 32);
    } else {
        h = uint16_t(v * 31 / 64);
    }
    const int exponent = (h >> 10) & 31, mantissa = h & 1023;
    float f;
    if (exponent == 0) {
        f = std::ldexp(float(mantissa), -24);
    } else if (exponent == 31) {
        f = mantissa ? NAN : INFINITY;
    } else {
        f = std::ldexp(float(1024 + mantissa), exponent - 25);
    }
    return (h & 0x8000) ? -f : f;
}

uint8_t bc6_byte(float f) {
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
    int mode = src[0] & 0x1f, at;
    if ((mode & 3) < 2) {
        mode &= 3;
        at = 2;
    } else {
        mode = ((mode & 3) == 2 ? 2 : 10) + (mode >> 2);
        at = 5;
    }
    if (mode >= 14) {  // a reserved mode: black
        for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
        return;
    }
    const Bc6Mode& m = kBc6Modes[mode];
    const int count = m.subsets == 1 ? 60 : mode < 2 ? 75 : 72, ends = 6 * m.subsets;
    int ep[12] = {};
    for (int i = 0; i < count; ++i) {
        const int d = kBc6Layout[mode][i];
        ep[d >> 4] |= int(bits_at(src, at + i, 1)) << (d & 15);
    }
    at += count;
    const int partition = m.subsets == 2 ? int(bits_at(src, at, 5)) : 0;
    at += m.subsets == 2 ? 5 : 0;
    const int widths[3] = {m.rb, m.gb, m.bb};
    if (sign) {
        for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
    }
    if (sign || m.transformed) {
        for (int i = 3; i < ends; ++i) ep[i] = sign_extend(ep[i], widths[i % 3]);
    }
    if (m.transformed) {  // as PIL: the sums are not sign-extended again
        for (int i = 3; i < ends; ++i) ep[i] = (ep[i] + ep[i % 3]) & ((1 << m.epb) - 1);
    }
    int un[12];
    for (int i = 0; i < ends; ++i) un[i] = bc6_unquantize(ep[i], m.epb, sign);
    const int ib = m.subsets == 2 ? 3 : 4;
    const int* w = weights(ib);
    for (int i = 0; i < 16; ++i) {
        const int s = 6 * subset_of(m.subsets, partition, i);
        const int bits = ib - (is_anchor(m.subsets, partition, i) ? 1 : 0);
        const int k = w[bits_at(src, at, bits)];
        at += bits;
        uint8_t px[3];
        for (int c = 0; c < 3; ++c) {  // PIL's interpolation truncates
            px[c] = bc6_byte(bc6_float((un[s + c] * (64 - k) + un[s + 3 + c] * k) >> 6, sign));
        }
        col[i] = {px[0], px[1], px[2], 255};
    }
}

}  // namespace

// bcn: the 4 x 4 blocks of format `kind` (1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5,
// -5 BC5 signed, 6 BC6H unsigned, -6 BC6H signed, 7 BC7) from in[0..n), left to right and top to bottom, into
// `out`: height rows of width RGBA pixels (BC4 in R, BC5 in R and G, the
// other channels 0, a signed BC5's blue 128).  Returns the whole blocks decoded.
int64_t bcn(const uint8_t* in, int64_t n, uint8_t* out, int64_t width, int64_t height,
            int64_t kind) {
    const int64_t size = (kind == 1 || kind == 4) ? 8 : 16;
    const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
    int64_t blocks = n / size;
    if (blocks > bw * bh) blocks = bw * bh;
    for (int64_t k = 0; k < blocks; ++k) {
        const uint8_t* src = in + k * size;
        Rgba col[16];
        std::memset(col, 0, sizeof(col));
        uint8_t* bytes = reinterpret_cast<uint8_t*>(col);
        switch (kind) {
            case 1:
                bc1_color(col, src, false);
                break;
            case 2:
                bc1_color(col, src + 8, true);
                for (int i = 0; i < 16; ++i) {
                    const int bits = (src[i / 2] >> (4 * (i & 1))) & 15;
                    col[i].a = uint8_t(bits | bits << 4);
                }
                break;
            case 3:
                bc1_color(col, src + 8, true);
                bc3_alpha(bytes, src, 4, 3, false);
                break;
            case 4:
                bc3_alpha(bytes, src, 4, 0, false);
                break;
            case 6:
            case -6:
                bc6_block(col, src, kind < 0);
                break;
            case 7:
                bc7_block(col, src);
                break;
            default:
                bc3_alpha(bytes, src, 4, 0, kind < 0);
                bc3_alpha(bytes, src + 8, 4, 1, kind < 0);
                if (kind < 0) {
                    for (int i = 0; i < 16; ++i) col[i].b = 128;  // signed: a zero blue
                }
                break;
        }
        const int64_t x0 = (k % bw) * 4, y0 = (k / bw) * 4;
        for (int y = 0; y < 4 && y0 + y < height; ++y) {
            const int64_t w = width - x0 < 4 ? width - x0 : 4;
            std::memcpy(out + ((y0 + y) * width + x0) * 4, col + 4 * y, static_cast<size_t>(4 * w));
        }
    }
    return blocks;
}

}  // extern "C"
