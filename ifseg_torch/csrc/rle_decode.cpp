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
//   im_bits  BitDecode.c: the 2- to 31-bit samples of an IM file's "L*n" types
//   bcn      BcnDecode.c: BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 and BC5
//            (unsigned and signed) 4 x 4 blocks, whole blocks only
//
// Built with the host C++ compiler at first use (`ifseg_torch/ops/build.py`)
// and called through ctypes.

#include <cstdint>
#include <cstring>

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

}  // namespace

// bcn: the 4 x 4 blocks of format `kind` (1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5,
// -5 BC5 signed) from in[0..n), left to right and top to bottom, into
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
