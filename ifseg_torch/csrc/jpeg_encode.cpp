// JPEG encoding on the host, writing the bytes PIL writes with the
// libjpeg-turbo it links (`Image.save(buf, "JPEG", quality=q, subsampling=s)`).
//
// `cli.infer` of the JAX package saves its overlay with PIL; the port writes
// the same file here (`ifseg_torch/data/jpeg.py:encode_jpeg`). A baseline
// JFIF file, each piece as libjpeg-turbo makes it:
//
//   markers            SOI, the JFIF APP0 of jpeg_set_defaults, one DQT a
//                      table, SOF0, one DHT a table before the scan, SOS, EOI
//                      (jcmarker.c)
//   quantization       the standard tables scaled by jpeg_quality_scaling and
//                      clamped to 1..255 (jcparam.c, force_baseline)
//   colour             RGB -> YCbCr in fixed point (jccolor.c rgb_ycc_convert)
//   downsampling       h2v1_downsample (bias 0, 1, ...), h2v2_downsample
//                      (bias 1, 2, ...), edges expanded to whole blocks and
//                      MCUs by replicating the last column and row (jcsample.c,
//                      jcprepct.c)
//   FDCT               the accurate integer FDCT (jfdctint.c jpeg_fdct_islow)
//   quantizer          division by reciprocals with libjpeg-turbo's correction
//                      term (jcdctmgr.c compute_reciprocal, quantize)
//   entropy coding     the standard Huffman tables (jstdhuff.c), dummy blocks
//                      of the last MCUs as jccoefct.c compress_data makes them,
//                      0xFF stuffing and padding with 1 bits (jchuff.c)
//
// Built with the host C++ compiler at first use (`ifseg_torch/ops/build.py`)
// and called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "jpeg_tables.h"

namespace {

using namespace jpeg_tables;

struct HuffCodes {
    uint16_t code[256];
    uint8_t size[256];

    void build(const uint8_t* bits, const uint8_t* vals) {
        std::memset(size, 0, sizeof(size));
        int c = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
                code[vals[k]] = static_cast<uint16_t>(c);
                size[vals[k]] = static_cast<uint8_t>(l);
            }
            c <<= 1;
        }
    }
};

class BitWriter {
   public:
    explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

    void put(uint32_t value, int n) {
        acc_ = (acc_ << n) | (value & ((1u << n) - 1));
        bits_ += n;
        while (bits_ >= 8) {
            bits_ -= 8;
            emit(static_cast<uint8_t>(acc_ >> bits_));
        }
    }

    void flush() {  // pad the last byte with 1 bits
        if (bits_) put(0x7F, 8 - bits_);
    }

   private:
    void emit(uint8_t b) {
        out_.push_back(b);
        if (b == 0xFF) out_.push_back(0x00);
    }

    std::vector<uint8_t>& out_;
    uint64_t acc_ = 0;
    int bits_ = 0;
};

int nbits(int v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM (libjpeg-turbo's SIMD
// builds): reciprocal, correction, shift of one divisor
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t divisor) {
    if (divisor == 1) return {1, 0, 0};
    const int b = nbits(static_cast<int>(divisor)) - 1;
    int r = 16 + b;
    uint64_t fq = (uint64_t{1} << r) / divisor;
    const uint64_t fr = (uint64_t{1} << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2U) {
        ++c;
    } else {
        ++fq;
    }
    return {static_cast<uint32_t>(fq), c, r};
}

// jfdctint.c jpeg_fdct_islow, in place on 64 samples already shifted by -128
void fdct_islow(int* data) {
    for (int r = 0; r < 8; ++r) {
        int* d = data + 8 * r;
        const int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
        const int64_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
        const int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
        const int64_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        d[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int sh = kConstBits - kPass1Bits;
        d[2] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
        d[6] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
        const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560 + z5;
        z4 = z4 * -FIX_0_390180644 + z5;
        d[7] = static_cast<int>(descale(t4 + z1 + z3, sh));
        d[5] = static_cast<int>(descale(t5 + z2 + z4, sh));
        d[3] = static_cast<int>(descale(t6 + z2 + z3, sh));
        d[1] = static_cast<int>(descale(t7 + z1 + z4, sh));
    }
    for (int c = 0; c < 8; ++c) {
        int* d = data + c;
        const int64_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
        const int64_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
        const int64_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
        const int64_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        d[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
        d[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int sh = kConstBits + kPass1Bits;
        d[16] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
        d[48] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
        const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560 + z5;
        z4 = z4 * -FIX_0_390180644 + z5;
        d[56] = static_cast<int>(descale(t4 + z1 + z3, sh));
        d[40] = static_cast<int>(descale(t5 + z2 + z4, sh));
        d[24] = static_cast<int>(descale(t6 + z2 + z3, sh));
        d[8] = static_cast<int>(descale(t7 + z1 + z4, sh));
    }
}

struct Plane {
    int h, v;              // sampling factors
    int wib, hib;          // width and height in blocks
    int cols, rows;        // samples held: whole MCUs, edges expanded
    std::vector<uint8_t> s;
    int tbl;               // its quantization and Huffman tables: 0 luma, 1 chroma
    Divisor div[64];       // natural order
};

class Encoder {
   public:
    Encoder(const uint8_t* px, int H, int W, int C, int quality, int hs, int vs)
        : px_(px), H_(H), W_(W), C_(C) {
        // jcparam.c jpeg_quality_scaling, jpeg_add_quant_table(force_baseline)
        if (quality <= 0) quality = 1;
        if (quality > 100) quality = 100;
        const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
        for (int t = 0; t < 2; ++t)
            for (int i = 0; i < 64; ++i) {
                long q = ((t ? kChromaQuant : kLumaQuant)[i] * static_cast<long>(scale) + 50L) / 100L;
                if (q <= 0L) q = 1L;
                if (q > 255L) q = 255L;
                quant_[t][i] = static_cast<int>(q);
            }
        dc_[0].build(kDcLumaBits, kDcValues);
        dc_[1].build(kDcChromaBits, kDcValues);
        ac_[0].build(kAcLumaBits, kAcLumaValues);
        ac_[1].build(kAcChromaBits, kAcChromaValues);
        planes_.resize(static_cast<size_t>(C));
        for (int c = 0; c < C; ++c) {
            planes_[c].h = c == 0 ? hs : 1;
            planes_[c].v = c == 0 ? vs : 1;
            planes_[c].tbl = c == 0 ? 0 : 1;
        }
        hmax_ = hs;  // the chroma components are 1 x 1, the first one is the largest
        vmax_ = vs;
        mcux_ = (W + 8 * hmax_ - 1) / (8 * hmax_);
        mcuy_ = (H + 8 * vmax_ - 1) / (8 * vmax_);
        for (Plane& p : planes_) {
            p.wib = (W * p.h + 8 * hmax_ - 1) / (8 * hmax_);
            p.hib = (H * p.v + 8 * vmax_ - 1) / (8 * vmax_);
            for (int i = 0; i < 64; ++i) p.div[i] = reciprocal(static_cast<uint32_t>(quant_[p.tbl][i]) << 3);
        }
    }

    std::vector<uint8_t> run() {
        prepare();
        std::vector<uint8_t> out;
        out.reserve(static_cast<size_t>(H_) * W_ * C_ / 4 + 1024);
        headers(out);
        entropy(out);
        out.push_back(0xFF);
        out.push_back(0xD9);
        return out;
    }

   private:
    // colour conversion, downsampling and edge expansion to whole MCUs
    void prepare() {
        const int groups = (H_ + vmax_ - 1) / vmax_;  // row groups of vmax_ input rows
        const int rows_in = groups * vmax_;            // input rows, the last replicated
        std::vector<std::vector<uint8_t>> full(static_cast<size_t>(C_));
        const size_t n = static_cast<size_t>(rows_in) * W_;
        for (auto& f : full) f.resize(n);
        if (C_ == 1) {
            std::memcpy(full[0].data(), px_, static_cast<size_t>(H_) * W_);
        } else {
            // jccolor.c rgb_ycc_start, SCALEBITS 16
            auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
            const int64_t one_half = int64_t{1} << 15, cbcr_offset = int64_t{128} << 16;
            int64_t tab[8 * 256];
            for (int i = 0; i < 256; ++i) {
                tab[i] = fix(0.29900) * i;
                tab[256 + i] = fix(0.58700) * i;
                tab[512 + i] = fix(0.11400) * i + one_half;
                tab[768 + i] = -fix(0.16874) * i;
                tab[1024 + i] = -fix(0.33126) * i;
                tab[1280 + i] = fix(0.50000) * i + cbcr_offset + one_half - 1;
                tab[1536 + i] = -fix(0.41869) * i;
                tab[1792 + i] = -fix(0.08131) * i;
            }
            for (size_t i = 0; i < static_cast<size_t>(H_) * W_; ++i) {
                const int r = px_[3 * i], g = px_[3 * i + 1], b = px_[3 * i + 2];
                full[0][i] = static_cast<uint8_t>((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
                full[1][i] = static_cast<uint8_t>((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
                full[2][i] = static_cast<uint8_t>((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
            }
        }
        for (int c = 0; c < C_; ++c) {
            uint8_t* f = full[c].data();
            for (int y = H_; y < rows_in; ++y)  // jcprepct.c: expand_bottom_edge
                std::memcpy(f + static_cast<size_t>(y) * W_, f + static_cast<size_t>(H_ - 1) * W_,
                            static_cast<size_t>(W_));
            Plane& p = planes_[c];
            const int hx = hmax_ / p.h, vx = vmax_ / p.v;
            const int out_cols = p.wib * 8;
            const int out_rows = groups * p.v;  // downsampled rows before the iMCU padding
            p.cols = mcux_ * p.h * 8;
            p.rows = mcuy_ * p.v * 8;
            p.s.assign(static_cast<size_t>(p.rows) * p.cols, 0);
            // jcsample.c expand_right_edge: the input to out_cols * hx columns
            const int wide = out_cols * hx;
            std::vector<uint8_t> row0(static_cast<size_t>(std::max(wide, W_))), row1(row0.size());
            for (int y = 0; y < out_rows; ++y) {
                uint8_t* o = p.s.data() + static_cast<size_t>(y) * p.cols;
                auto load = [&](int iy, std::vector<uint8_t>& r) {
                    std::memcpy(r.data(), f + static_cast<size_t>(iy) * W_, static_cast<size_t>(W_));
                    for (int x = W_; x < wide; ++x) r[x] = r[W_ - 1];
                };
                if (hx == 1 && vx == 1) {  // fullsize_downsample
                    load(y, row0);
                    std::memcpy(o, row0.data(), static_cast<size_t>(out_cols));
                } else if (hx == 2 && vx == 1) {  // h2v1_downsample
                    load(y, row0);
                    int bias = 0;
                    for (int x = 0; x < out_cols; ++x) {
                        o[x] = static_cast<uint8_t>((row0[2 * x] + row0[2 * x + 1] + bias) >> 1);
                        bias ^= 1;
                    }
                } else {  // h2v2_downsample
                    load(2 * y, row0);
                    load(2 * y + 1, row1);
                    int bias = 1;
                    for (int x = 0; x < out_cols; ++x) {
                        o[x] = static_cast<uint8_t>(
                            (row0[2 * x] + row0[2 * x + 1] + row1[2 * x] + row1[2 * x + 1] + bias) >> 2);
                        bias ^= 3;
                    }
                }
            }
            // jcprepct.c: the last downsampled row to a whole iMCU row
            for (int y = out_rows; y < p.rows; ++y)
                std::memcpy(p.s.data() + static_cast<size_t>(y) * p.cols,
                            p.s.data() + static_cast<size_t>(out_rows - 1) * p.cols,
                            static_cast<size_t>(out_cols));
        }
    }

    // forward DCT and quantization of the block at (bx, by) of plane p, in natural order
    void block(const Plane& p, int bx, int by, int* coef) const {
        int ws[64];
        for (int r = 0; r < 8; ++r) {
            const uint8_t* s = p.s.data() + static_cast<size_t>(by * 8 + r) * p.cols + bx * 8;
            for (int c = 0; c < 8; ++c) ws[8 * r + c] = s[c] - 128;
        }
        fdct_islow(ws);
        for (int i = 0; i < 64; ++i) {  // jcdctmgr.c quantize
            const Divisor& d = p.div[i];
            const int t = ws[i];
            const uint64_t a = static_cast<uint64_t>(t < 0 ? -t : t);
            const int q = static_cast<int>(((a + d.corr) * d.recip) >> d.shift);
            coef[i] = t < 0 ? -q : q;
        }
    }

    void headers(std::vector<uint8_t>& o) const {
        auto u16 = [&](int v) {
            o.push_back(static_cast<uint8_t>(v >> 8));
            o.push_back(static_cast<uint8_t>(v & 0xFF));
        };
        auto marker = [&](uint8_t m) {
            o.push_back(0xFF);
            o.push_back(m);
        };
        marker(0xD8);
        marker(0xE0);  // JFIF 1.01, no units, density 1 x 1, no thumbnail
        u16(16);
        for (uint8_t b : {'J', 'F', 'I', 'F', '\0'}) o.push_back(b);
        o.push_back(1);
        o.push_back(1);
        o.push_back(0);
        u16(1);
        u16(1);
        o.push_back(0);
        o.push_back(0);
        for (int t = 0; t < (C_ == 1 ? 1 : 2); ++t) {
            marker(0xDB);
            u16(67);
            o.push_back(static_cast<uint8_t>(t));
            for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(quant_[t][kNaturalOrder[k]]));
        }
        marker(0xC0);
        u16(8 + 3 * C_);
        o.push_back(8);
        u16(H_);
        u16(W_);
        o.push_back(static_cast<uint8_t>(C_));
        for (int c = 0; c < C_; ++c) {
            o.push_back(static_cast<uint8_t>(c + 1));
            o.push_back(static_cast<uint8_t>((planes_[c].h << 4) | planes_[c].v));
            o.push_back(static_cast<uint8_t>(planes_[c].tbl));
        }
        auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
            int n = 0;
            for (int l = 0; l < 16; ++l) n += bits[l];
            marker(0xC4);
            u16(19 + n);
            o.push_back(static_cast<uint8_t>((cls << 4) | id));
            o.insert(o.end(), bits, bits + 16);
            o.insert(o.end(), vals, vals + n);
        };
        dht(0, 0, kDcLumaBits, kDcValues);
        dht(1, 0, kAcLumaBits, kAcLumaValues);
        if (C_ == 3) {
            dht(0, 1, kDcChromaBits, kDcValues);
            dht(1, 1, kAcChromaBits, kAcChromaValues);
        }
        marker(0xDA);
        u16(6 + 2 * C_);
        o.push_back(static_cast<uint8_t>(C_));
        for (int c = 0; c < C_; ++c) {
            o.push_back(static_cast<uint8_t>(c + 1));
            o.push_back(static_cast<uint8_t>((planes_[c].tbl << 4) | planes_[c].tbl));
        }
        o.push_back(0);
        o.push_back(63);
        o.push_back(0);
    }

    void encode_block(BitWriter& bw, const int* coef, int& last_dc, int tbl) const {
        const HuffCodes& dc = dc_[tbl];
        const HuffCodes& ac = ac_[tbl];
        int diff = coef[0] - last_dc;
        last_dc = coef[0];
        int mag = diff < 0 ? -diff : diff;
        int n = nbits(mag);
        bw.put(dc.code[n], dc.size[n]);
        if (n) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
        int run = 0;
        for (int k = 1; k < 64; ++k) {
            const int v = coef[kNaturalOrder[k]];
            if (v == 0) {
                ++run;
                continue;
            }
            while (run > 15) {
                bw.put(ac.code[0xF0], ac.size[0xF0]);
                run -= 16;
            }
            mag = v < 0 ? -v : v;
            n = nbits(mag);
            const int sym = (run << 4) + n;
            bw.put(ac.code[sym], ac.size[sym]);
            bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
            run = 0;
        }
        if (run > 0) bw.put(ac.code[0], ac.size[0]);
    }

    // jccoefct.c compress_data and jchuff.c encode_mcu_huff
    void entropy(std::vector<uint8_t>& out) const {
        BitWriter bw(out);
        int last_dc[3] = {0, 0, 0};
        int coef[64];
        if (C_ == 1) {  // one component: a non-interleaved scan of its own blocks
            const Plane& p = planes_[0];
            for (int by = 0; by < p.hib; ++by)
                for (int bx = 0; bx < p.wib; ++bx) {
                    block(p, bx, by, coef);
                    encode_block(bw, coef, last_dc[0], p.tbl);
                }
            bw.flush();
            return;
        }
        std::vector<int> mcu;
        for (int my = 0; my < mcuy_; ++my) {
            for (int mx = 0; mx < mcux_; ++mx) {
                for (int c = 0; c < C_; ++c) {
                    const Plane& p = planes_[c];
                    const int blocks = p.h * p.v;
                    mcu.assign(static_cast<size_t>(blocks) * 64, 0);
                    const int last_col = mx < mcux_ - 1 ? p.h : (p.wib % p.h ? p.wib % p.h : p.h);
                    const int last_row = p.hib % p.v ? p.hib % p.v : p.v;
                    for (int yi = 0; yi < p.v; ++yi) {
                        int* row = mcu.data() + static_cast<size_t>(yi) * p.h * 64;
                        if (my < mcuy_ - 1 || yi < last_row) {
                            for (int xi = 0; xi < last_col; ++xi)
                                block(p, mx * p.h + xi, my * p.v + yi, row + 64 * xi);
                            for (int xi = last_col; xi < p.h; ++xi)  // dummy blocks at the right edge
                                row[64 * xi] = row[64 * (xi - 1)];
                        } else {  // a row of dummy blocks at the bottom
                            const int dc = row[-64];
                            for (int xi = 0; xi < p.h; ++xi) row[64 * xi] = dc;
                        }
                    }
                    for (int b = 0; b < blocks; ++b)
                        encode_block(bw, mcu.data() + 64 * b, last_dc[c], p.tbl);
                }
            }
        }
        bw.flush();
    }

    const uint8_t* px_;
    int H_, W_, C_;
    int quant_[2][64];  // natural order
    HuffCodes dc_[2], ac_[2];
    std::vector<Plane> planes_;
    int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
};

}  // namespace

// Encode height x width x channels (1 gray, 3 RGB) uint8 pixels at `quality`
// with the first component sampled h_samp x v_samp (1 x 1, 2 x 1 or 2 x 2).
// Returns the file's size with the file in *out (free it with jpeg_free), or
// -1 with a message in err.
extern "C" int64_t jpeg_encode(const uint8_t* pixels, int64_t height, int64_t width,
                               int64_t channels, int64_t quality, int64_t h_samp, int64_t v_samp,
                               uint8_t** out, char* err, int64_t err_cap) {
    try {
        if ((channels != 1 && channels != 3) || height < 1 || width < 1 || height > 65535 ||
            width > 65535 || h_samp < 1 || h_samp > 2 || v_samp < 1 || v_samp > h_samp)
            throw std::invalid_argument("bad image shape or sampling factors");
        std::vector<uint8_t> file =
            Encoder(pixels, static_cast<int>(height), static_cast<int>(width),
                    static_cast<int>(channels), static_cast<int>(quality), static_cast<int>(h_samp),
                    static_cast<int>(v_samp))
                .run();
        *out = static_cast<uint8_t*>(std::malloc(file.size()));
        if (*out == nullptr) throw std::bad_alloc();
        std::memcpy(*out, file.data(), file.size());
        return static_cast<int64_t>(file.size());
    } catch (const std::exception& e) {
        if (err_cap > 0) {
            std::strncpy(err, e.what(), static_cast<size_t>(err_cap - 1));
            err[err_cap - 1] = '\0';
        }
        return -1;
    }
}

extern "C" void jpeg_free(uint8_t* p) { std::free(p); }
