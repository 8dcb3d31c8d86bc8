// JPEG decoding on the host, equal bit for bit to the libjpeg-turbo that PIL
// links, with its default decompression settings.
//
// `np.asarray(PIL.Image.open(...))` decodes the JPEG originals of the JAX
// package's CLIs; the port decodes them here (`ifseg_torch/data/jpeg.py`), so
// that it depends on no image library. Every rounding rule is libjpeg-turbo's:
//
//   entropy decoding   sequential Huffman scans (jdhuff.c), interleaved or one
//                      component a scan, and progressive ones (jdphuff.c): DC
//                      first and refinement, AC first with EOB runs and AC
//                      refinement; restart intervals, 0xFF fill bytes and
//                      0xFF00 stuffing; DQT/DHT/DRI between scans; the
//                      standard Huffman tables where a file defines none
//   IDCT               the accurate integer IDCT (jidctint.c jpeg_idct_islow)
//                      with its range-limit table (jdmaster.c)
//   upsampling         "fancy" upsampling (jdsample.c): h2v1 and h2v2 where the
//                      component's downsampled width is above 2, h1v2 always,
//                      replication otherwise; edges replicate the last sample
//   colour             YCbCr -> RGB with the tables of jdcolor.c; the colour
//                      space chosen as jdapimin.c default_decompress_parms does
//
// A cut file decodes as PIL decodes it with ImageFile.LOAD_TRUNCATED_IMAGES
// (which the JAX package sets): PIL appends an EOI marker where the data ends,
// and libjpeg-turbo, as at any marker inside entropy-coded data, reads zero
// bits past it; once an MCU has read one, the scan's later MCUs are left as
// they were (jdhuff.c, jdphuff.c: insufficient_data), the scans not reached
// are absent, and a component no scan reached is mid-gray. A file cut before
// the end of its first scan header raises, as PIL's Image.open does; one cut
// inside a later marker segment gives PIL's all-zero image where libjpeg
// buffers the whole image (progressive or multi-scan), since no output pass
// ever starts, and the decoded image otherwise.
//
// A progressive file whose scans leave one of the first nine AC coefficients
// unrefined would be block-smoothed by libjpeg-turbo (jdcoefct.c); it is
// refused, as are arithmetic coding, lossless and hierarchical files,
// precisions other than 8 bits, DNL and 4-component (CMYK/YCCK) files. Built
// with the host C++ compiler at first use (`ifseg_torch/ops/build.py`) and
// called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "jpeg_tables.h"

namespace {

using namespace jpeg_tables;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

struct Huffman {
    bool defined = false;
    int maxcode[17];   // the largest code of each length, -1 if none
    int valptr[17];    // index into values of each length's first code
    int mincode[17];
    uint8_t values[256];
    uint16_t lookup[1 << 9];  // (length << 8) | symbol for codes of up to 9 bits, 0 if longer

    void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
        int total = 0;
        for (int l = 0; l < 16; ++l) total += bits[l];
        if (total > 256 || total != nvals) throw Error("broken JPEG: bad Huffman table");
        std::memcpy(values, vals, static_cast<size_t>(nvals));
        std::memset(lookup, 0, sizeof(lookup));
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            const int n = bits[l - 1];
            if (n) {
                valptr[l] = k;
                mincode[l] = code;
                for (int i = 0; i < n; ++i, ++code, ++k) {
                    if (l <= 9) {
                        const int shift = 9 - l;
                        for (int j = 0; j < (1 << shift); ++j)
                            lookup[(code << shift) | j] = static_cast<uint16_t>((l << 8) | values[k]);
                    }
                }
                maxcode[l] = code - 1;
                if (code - 1 >= (1 << l)) throw Error("broken JPEG: bad Huffman table");
            } else {
                maxcode[l] = -1;
            }
            code <<= 1;
        }
        defined = true;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;         // the tables of the current scan
    int wib = 0, hib = 0;       // width and height in blocks
    int bw = 0, bh = 0;         // blocks held: padded to whole MCUs
    int dw = 0, dh = 0;         // downsampled width and height
    std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
    int dc_pred = 0;
    bool latched = false;       // quantization table copied at its first scan
    uint16_t quant[64];         // natural order
    int coef_bits[64];          // Al of the last scan that coded each coefficient, -1 if none
    std::vector<uint8_t> plane; // IDCT output: (hib * 8) x (wib * 8)
};

// the natural position of zig-zag index k; a run past the block (bad data,
// or zero bits read past a cut) lands on 63, as libjpeg's natural-order
// table extended by 16 entries makes it
inline int natural(int k) { return kNaturalOrder[k < 64 ? k : 63]; }

class BitReader {
   public:
    BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

    size_t pos() const { return pos_; }

    // whether an MCU has read a bit past the data (a marker or the end of a
    // cut file): libjpeg leaves the segment's later MCUs untouched then
    bool insufficient() const { return insufficient_; }

    // Drop the buffered bits and step over the restart marker RSTn that must
    // come next (after any bytes left in the segment). Where the data has
    // ended (PIL's EOI), libjpeg keeps the marker unread and its flag as it
    // was (jdmarker.c read_restart_marker, jdhuff.c process_restart).
    void restart(int n) {
        buf_ = 0;
        bits_ = 0;
        fake_ = 0;
        const size_t at = next_marker(d_, n_, pos_);
        if (at + 1 >= n_) {
            marker_ = true;
            pos_ = n_;
            return;
        }
        if (d_[at + 1] != 0xD0 + n)
            throw Error("broken JPEG: restart marker RST" + std::to_string(n) + " missing");
        marker_ = false;
        insufficient_ = false;
        pos_ = at + 2;
    }

    int bits(int k) {  // the next k bits (k <= 16), MSB first
        if (k == 0) return 0;
        ensure(k);
        const int v = static_cast<int>((buf_ >> (bits_ - k)) & ((1u << k) - 1));
        consume(k);
        return v;
    }

    int bit() { return bits(1); }

    int decode(const Huffman& t) {
        ensure(16);
        const int look = static_cast<int>((buf_ >> (bits_ - 9)) & 0x1FF);
        const int e = t.lookup[look];
        if (e) {
            consume(e >> 8);
            return e & 0xFF;
        }
        const int code16 = static_cast<int>((buf_ >> (bits_ - 16)) & 0xFFFF);
        for (int l = 10; l <= 16; ++l) {
            const int code = code16 >> (16 - l);
            if (code <= t.maxcode[l]) {
                consume(l);
                return t.values[t.valptr[l] + code - t.mincode[l]];
            }
        }
        throw Error("broken JPEG: bad Huffman code");
    }

    // the value of s extra bits (HUFF_EXTEND)
    int receive_extend(int s) {
        if (s == 0) return 0;
        const int v = bits(s);
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }

    // the byte offset of the next marker at or after `pos`: an 0xFF byte
    // followed by neither 0x00 nor 0xFF; n if there is none
    static size_t next_marker(const uint8_t* d, size_t n, size_t pos) {
        while (pos + 1 < n) {
            if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) return pos;
            ++pos;
        }
        return n;
    }

   private:
    // libjpeg supplies zero bits once a marker, or the end of the data
    // (where PIL appends EOI), ends the entropy-coded data; a trailing 0xFF
    // is a fill byte before that EOI
    void ensure(int k) {
        while (bits_ < k) {
            uint8_t c = 0;
            if (marker_ || pos_ >= n_) {
                fake_ += 8;
                pos_ = std::min(pos_, n_);
            } else if (d_[pos_] == 0xFF) {
                size_t p = pos_ + 1;
                while (p < n_ && d_[p] == 0xFF) ++p;
                if (p >= n_) {
                    fake_ += 8;
                    pos_ = n_;
                } else if (d_[p] == 0x00) {
                    c = 0xFF;
                    pos_ = p + 1;
                } else {
                    fake_ += 8;
                    marker_ = true;  // pos_ stays on the marker
                    pos_ = p - 1;
                }
            } else {
                c = d_[pos_++];
            }
            buf_ = (buf_ << 8) | c;
            bits_ += 8;
        }
    }

    void consume(int k) {
        bits_ -= k;
        if (bits_ < fake_) {  // a supplied zero bit was read
            insufficient_ = true;
            fake_ = bits_;
        }
    }

    const uint8_t* d_;
    size_t n_, pos_;
    uint64_t buf_ = 0;
    int bits_ = 0, fake_ = 0;
    bool marker_ = false, insufficient_ = false;
};

// The IDCT's output range limit (jdmaster.c prepare_range_limit_table): the
// table libjpeg indexes with (x & 1023) for a sample x before its +128 shift.
struct RangeLimit {
    uint8_t idct[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            if (i < 128) idct[i] = static_cast<uint8_t>(i + 128);
            else if (i < 512) idct[i] = 255;
            else if (i < 896) idct[i] = 0;
            else idct[i] = static_cast<uint8_t>(i - 896);
        }
    }
};

const RangeLimit kRange;

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// jidctint.c jpeg_idct_islow: one block of dequantized coefficients to 8 x 8
// samples at out (row pitch `stride`)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
            ip[48] == 0 && ip[56] == 0) {
            const int dc = static_cast<int>(int64_t{ip[0]} * qp[0] * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
        int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits - kPass1Bits;
        wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
        wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
        wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
        wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
        wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
        wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
        wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
        wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + static_cast<size_t>(r) * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
            wp[7] == 0) {
            const uint8_t dc = kRange.idct[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
            std::memset(op, dc, 8);
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t{wp[0]} + wp[4]) * (int64_t{1} << kConstBits);
        int64_t tmp1 = (int64_t{wp[0]} - wp[4]) * (int64_t{1} << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits + kPass1Bits + 3;
        op[0] = kRange.idct[static_cast<int>(descale(tmp10 + tmp3, sh)) & 1023];
        op[7] = kRange.idct[static_cast<int>(descale(tmp10 - tmp3, sh)) & 1023];
        op[1] = kRange.idct[static_cast<int>(descale(tmp11 + tmp2, sh)) & 1023];
        op[6] = kRange.idct[static_cast<int>(descale(tmp11 - tmp2, sh)) & 1023];
        op[2] = kRange.idct[static_cast<int>(descale(tmp12 + tmp1, sh)) & 1023];
        op[5] = kRange.idct[static_cast<int>(descale(tmp12 - tmp1, sh)) & 1023];
        op[3] = kRange.idct[static_cast<int>(descale(tmp13 + tmp0, sh)) & 1023];
        op[4] = kRange.idct[static_cast<int>(descale(tmp13 - tmp0, sh)) & 1023];
    }
}

class Decoder {
   public:
    Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {
        dc_[0].build(kDcLumaBits, kDcValues, 12);
        dc_[1].build(kDcChromaBits, kDcValues, 12);
        ac_[0].build(kAcLumaBits, kAcLumaValues, 162);
        ac_[1].build(kAcChromaBits, kAcChromaValues, 162);
    }

    // parse up to the first scan: width, height, output channels. PIL's
    // Image.open reads as far as the end of the first scan header and raises
    // on a file cut before it
    void header(int64_t* info) {
        size_t pos = start();
        while (true) {
            const size_t at = BitReader::next_marker(d_, n_, pos);
            if (at + 1 >= n_) throw Error("truncated JPEG: image file is truncated (no scan)");
            if (d_[at + 1] == 0xDA && sof_seen_) {
                if (cut_off(at)) throw Error("truncated JPEG: the first scan header is cut off");
                break;
            }
            pos = segment(at, false);
        }
        info[0] = height_;
        info[1] = width_;
        info[2] = channels();
    }

    void decode(uint8_t* out) {
        size_t pos = start();
        while (true) {
            const size_t at = BitReader::next_marker(d_, n_, pos);
            if (at + 1 >= n_ || d_[at + 1] == 0xD9) break;  // EOI, or PIL's after a cut
            if (scans_ && cut_off(at)) {  // libjpeg waits for the rest of the segment
                if (buffered_) {
                    std::memset(out, 0, static_cast<size_t>(width_) * height_ * channels());
                    return;
                }
                break;
            }
            pos = segment(at, true);
        }
        if (!scans_) throw Error("broken JPEG: no scan before EOI");
        if (progressive_) check_smoothing();
        output(out);
    }

   private:
    size_t start() {
        if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error("not a JPEG file (no SOI marker)");
        return 2;
    }

    int channels() const {
        if (comps_.size() == 1) return 1;
        if (comps_.size() == 3) return 3;
        if (comps_.size() == 4)
            throw Error("4-component (CMYK/YCCK) JPEG files are not supported");
        throw Error("JPEG files of " + std::to_string(comps_.size()) +
                    " components are not supported");
    }

    // jdapimin.c default_decompress_parms, for 3 components: YCbCr or RGB
    bool ycc() const {
        if (saw_jfif_) return true;
        if (saw_adobe_) return adobe_transform_ != 0;
        return !(comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B');
    }

    // whether the marker segment at `at` (one with a length) ends past the data
    bool cut_off(size_t at) const {
        const int code = d_[at + 1];
        if ((code >= 0xD0 && code <= 0xD7) || code == 0x01) return false;
        return at + 4 > n_ || at + 2 + static_cast<size_t>((d_[at + 2] << 8) | d_[at + 3]) > n_;
    }

    int u16(size_t p) const {
        if (p + 2 > n_) throw Error("truncated JPEG: a marker segment is cut off");
        return (d_[p] << 8) | d_[p + 1];
    }

    // one marker segment at `at` (0xFF, code); returns the position after it
    // (after the scan's entropy-coded data too when `decoding`)
    size_t segment(size_t at, bool decoding) {
        const int code = d_[at + 1];
        size_t p = at + 2;
        if (code == 0xD8) throw Error("broken JPEG: a second SOI marker");
        if (code >= 0xD0 && code <= 0xD7) return p;  // a stray RSTn: ignored, as libjpeg does
        if (code == 0x01) return p;                  // TEM
        const int len = u16(p);
        if (len < 2 || p + len > n_) throw Error("truncated JPEG: a marker segment is cut off");
        const uint8_t* b = d_ + p + 2;
        const int blen = len - 2;
        const size_t end = p + len;
        switch (code) {
            case 0xC0:
            case 0xC1:
            case 0xC2:
                frame(b, blen, code == 0xC2);
                return end;
            case 0xC3:
            case 0xC7:
            case 0xCB:
            case 0xCF:
                throw Error("lossless JPEG files are not supported");
            case 0xC9:
            case 0xCA:
            case 0xCC:
            case 0xCD:
            case 0xCE:
                throw Error("arithmetic-coded JPEG files are not supported");
            case 0xC5:
            case 0xC6:
            case 0xDE:
            case 0xDF:
                throw Error("hierarchical JPEG files are not supported");
            case 0xC4:
                dht(b, blen);
                return end;
            case 0xDB:
                dqt(b, blen);
                return end;
            case 0xDD:
                if (blen < 2) throw Error("broken JPEG: bad DRI segment");
                restart_interval_ = (b[0] << 8) | b[1];
                return end;
            case 0xDC:
                throw Error("JPEG files with a DNL marker are not supported");
            case 0xE0:
                if (blen >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) saw_jfif_ = true;
                return end;
            case 0xEE:
                if (blen >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
                    saw_adobe_ = true;
                    adobe_transform_ = b[11];
                }
                return end;
            case 0xDA:
                return decoding ? scan(b, blen, end) : end;
            default:
                return end;  // APPn, COM and the rest: skipped
        }
    }

    void frame(const uint8_t* b, int blen, bool progressive) {
        if (sof_seen_) throw Error("broken JPEG: a second frame header");
        if (blen < 6) throw Error("broken JPEG: bad SOF segment");
        if (b[0] != 8)
            throw Error(std::to_string(b[0]) + "-bit JPEG files are not supported (8-bit only)");
        height_ = (b[1] << 8) | b[2];
        width_ = (b[3] << 8) | b[4];
        const int nc = b[5];
        if (height_ == 0) throw Error("JPEG files with a DNL marker are not supported (height 0)");
        if (width_ == 0 || nc == 0 || blen < 6 + 3 * nc) throw Error("broken JPEG: bad SOF segment");
        progressive_ = progressive;
        comps_.resize(static_cast<size_t>(nc));
        for (int i = 0; i < nc; ++i) {
            Component& c = comps_[i];
            c.id = b[6 + 3 * i];
            c.h = b[7 + 3 * i] >> 4;
            c.v = b[7 + 3 * i] & 15;
            c.tq = b[8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                throw Error("broken JPEG: bad sampling factors or table in SOF");
            hmax_ = std::max(hmax_, c.h);
            vmax_ = std::max(vmax_, c.v);
        }
        sof_seen_ = true;
        channels();  // refuse CMYK and odd component counts before any data
        mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
        mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
        for (Component& c : comps_) {
            c.wib = (width_ * c.h + 8 * hmax_ - 1) / (8 * hmax_);
            c.hib = (height_ * c.v + 8 * vmax_ - 1) / (8 * vmax_);
            c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
            c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
            c.bw = mcux_ * c.h;
            c.bh = mcuy_ * c.v;
            c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
            for (int& bits : c.coef_bits) bits = -1;
        }
    }

    void dht(const uint8_t* b, int blen) {
        int p = 0;
        while (p < blen) {
            if (p + 17 > blen) throw Error("broken JPEG: bad DHT segment");
            const int tc = b[p] >> 4, th = b[p] & 15;
            if (tc > 1 || th > 3) throw Error("broken JPEG: bad DHT table id");
            int total = 0;
            for (int l = 0; l < 16; ++l) total += b[p + 1 + l];
            if (total > 256 || p + 17 + total > blen) throw Error("broken JPEG: bad DHT segment");
            (tc ? ac_ : dc_)[th].build(b + p + 1, b + p + 17, total);
            p += 17 + total;
        }
    }

    void dqt(const uint8_t* b, int blen) {
        int p = 0;
        while (p < blen) {
            const int pq = b[p] >> 4, tq = b[p] & 15;
            if (tq > 3 || pq > 1) throw Error("broken JPEG: bad DQT segment");
            const int size = pq ? 128 : 64;
            if (p + 1 + size > blen) throw Error("broken JPEG: bad DQT segment");
            for (int k = 0; k < 64; ++k) {
                const int v = pq ? ((b[p + 1 + 2 * k] << 8) | b[p + 2 + 2 * k]) : b[p + 1 + k];
                quant_[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
            }
            quant_set_[tq] = true;
            p += 1 + size;
        }
    }

    size_t scan(const uint8_t* b, int blen, size_t data) {
        if (!sof_seen_) throw Error("broken JPEG: a scan before the frame header");
        const int ns = blen >= 1 ? b[0] : 0;
        if (ns < 1 || ns > 4 || blen < 1 + 2 * ns + 3) throw Error("broken JPEG: bad SOS segment");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; ++i) {
            Component* c = nullptr;
            for (Component& x : comps_)
                if (x.id == b[1 + 2 * i]) c = &x;
            if (c == nullptr) throw Error("broken JPEG: a scan names an unknown component");
            c->td = b[2 + 2 * i] >> 4;
            c->ta = b[2 + 2 * i] & 15;
            if (c->td > 3 || c->ta > 3) throw Error("broken JPEG: bad table id in SOS");
            sc.push_back(c);
        }
        const int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
        const int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
        for (Component* c : sc) {  // latch_quant_tables
            if (c->latched) continue;
            if (!quant_set_[c->tq]) throw Error("broken JPEG: a component's quantization table is undefined");
            std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
            c->latched = true;
        }
        if (progressive_) {
            if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1) || al > 13 || (ah && ah - 1 != al))
                throw Error("broken JPEG: bad progression parameters");
            for (Component* c : sc)
                for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        }
        for (Component* c : sc) {
            c->dc_pred = 0;
            if (!progressive_ || (ss == 0 && ah == 0))
                if (!dc_[c->td].defined) throw Error("broken JPEG: a scan's DC table is undefined");
            if (!progressive_ || ss > 0)
                if (!ac_[c->ta].defined) throw Error("broken JPEG: a scan's AC table is undefined");
        }
        // jdinput.c initial_setup: libjpeg buffers the whole image, and outputs
        // it only at EOI, when the first scan leaves a component out or the
        // file is progressive
        if (!scans_) buffered_ = progressive_ || ns < static_cast<int>(comps_.size());
        BitReader br(d_, n_, data);
        eobrun_ = 0;
        const bool single = ns == 1;
        const int mx = single ? sc[0]->wib : mcux_;
        const int my = single ? sc[0]->hib : mcuy_;
        int to_go = restart_interval_, next_rst = 0;
        for (int y = 0; y < my; ++y) {
            for (int x = 0; x < mx; ++x) {
                if (restart_interval_) {
                    if (to_go == 0) {
                        br.restart(next_rst);
                        next_rst = (next_rst + 1) & 7;
                        to_go = restart_interval_;
                        for (Component* c : sc) c->dc_pred = 0;
                        eobrun_ = 0;
                    }
                    --to_go;
                }
                if (br.insufficient()) continue;  // the MCU is left as it was
                if (single) {
                    block(br, *sc[0], x, y, ss, se, ah, al);
                } else {
                    for (Component* c : sc)
                        for (int v = 0; v < c->v; ++v)
                            for (int h = 0; h < c->h; ++h)
                                block(br, *c, x * c->h + h, y * c->v + v, ss, se, ah, al);
                }
            }
        }
        ++scans_;
        return br.pos();
    }

    void block(BitReader& br, Component& c, int bx, int by, int ss, int se, int ah, int al) {
        int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
        if (!progressive_) {
            const int s = br.decode(dc_[c.td]);
            c.dc_pred += br.receive_extend(s);
            blk[0] = static_cast<int16_t>(c.dc_pred);
            const Huffman& ac = ac_[c.ta];
            for (int k = 1; k < 64; ++k) {
                const int rs = br.decode(ac);
                const int r = rs >> 4, sz = rs & 15;
                if (sz) {
                    k += r;
                    blk[natural(k)] = static_cast<int16_t>(br.receive_extend(sz));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (ss == 0) {  // DC scans
            if (ah == 0) {
                const int s = br.decode(dc_[c.td]);
                c.dc_pred += br.receive_extend(s);
                blk[0] = static_cast<int16_t>(c.dc_pred * (1 << al));
            } else if (br.bit()) {
                blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
            }
            return;
        }
        const Huffman& ac = ac_[c.ta];
        if (ah == 0) {  // AC first
            if (eobrun_ > 0) {
                --eobrun_;
                return;
            }
            for (int k = ss; k <= se; ++k) {
                const int rs = br.decode(ac);
                const int r = rs >> 4, sz = rs & 15;
                if (sz) {
                    k += r;
                    blk[natural(k)] = static_cast<int16_t>(br.receive_extend(sz) * (1 << al));
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun_ = 1 << r;
                    if (r) eobrun_ += br.bits(r);
                    --eobrun_;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun_ == 0) {
            for (; k <= se; ++k) {
                const int rs = br.decode(ac);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun_ = 1 << r;
                    if (r) eobrun_ += br.bits(r);
                    break;
                }
                do {
                    int16_t& coef = blk[kNaturalOrder[k]];
                    if (coef != 0) {
                        if (br.bit() && (coef & p1) == 0)
                            coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) {
                    blk[natural(k)] = static_cast<int16_t>(s);
                }
            }
        }
        if (eobrun_ > 0) {
            for (; k <= se; ++k) {
                int16_t& coef = blk[kNaturalOrder[k]];
                if (coef != 0 && br.bit() && (coef & p1) == 0)
                    coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
            }
            --eobrun_;
        }
    }

    // jdcoefct.c smoothing_ok: libjpeg-turbo smooths a progressive image whose
    // DC is known and whose first nine AC coefficients are not all refined to
    // bit 0; this decoder does not, so it refuses such a file
    void check_smoothing() const {
        bool useful = false;
        for (const Component& c : comps_) {
            if (!c.latched) return;
            for (int k = 0; k < 10; ++k)
                if (c.quant[kNaturalOrder[k]] == 0) return;
            if (c.coef_bits[0] < 0) return;
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0) useful = true;
        }
        if (useful)
            throw Error("progressive JPEG files whose scans leave coefficients unrefined are not "
                        "supported (libjpeg would block-smooth them)");
    }

    void output(uint8_t* out) {
        for (Component& c : comps_) {
            if (!c.latched) std::memset(c.quant, 0, sizeof(c.quant));  // jddctmgr.c: all zero, mid-gray
            const int stride = c.wib * 8;
            c.plane.assign(static_cast<size_t>(c.hib) * 8 * stride, 0);
            for (int by = 0; by < c.hib; ++by)
                for (int bx = 0; bx < c.wib; ++bx)
                    idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                               c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
        }
        const size_t npix = static_cast<size_t>(width_) * height_;
        if (comps_.size() == 1) {
            upsample(comps_[0], out);
            return;
        }
        std::vector<uint8_t> full(3 * npix);
        for (int i = 0; i < 3; ++i) upsample(comps_[i], full.data() + i * npix);
        const uint8_t* p0 = full.data();
        const uint8_t* p1 = p0 + npix;
        const uint8_t* p2 = p1 + npix;
        if (!ycc()) {
            for (size_t i = 0; i < npix; ++i) {
                out[3 * i] = p0[i];
                out[3 * i + 1] = p1[i];
                out[3 * i + 2] = p2[i];
            }
            return;
        }
        // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        const int64_t one_half = int64_t{1} << 15;
        auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
        for (size_t i = 0; i < npix; ++i) {
            const int y = p0[i], cb = p1[i], cr = p2[i];
            out[3 * i] = clamp255(y + cr_r[cr]);
            out[3 * i + 1] = clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
            out[3 * i + 2] = clamp255(y + cb_b[cb]);
        }
    }

    // one component to full size (jdsample.c), into width_ x height_ samples
    void upsample(const Component& c, uint8_t* out) const {
        const int stride = c.wib * 8;
        const uint8_t* in = c.plane.data();
        const int W = width_, H = height_;
        auto row = [&](int y) { return in + static_cast<size_t>(y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y)) * stride; };
        const int hx = hmax_ / c.h, vx = vmax_ / c.v;
        if (hmax_ % c.h || vmax_ % c.v) throw Error("JPEG files with fractional sampling ratios are not supported");
        std::vector<uint8_t> tmp(static_cast<size_t>(2) * c.dw + 2);
        for (int y = 0; y < H; ++y) {
            uint8_t* o = out + static_cast<size_t>(y) * W;
            if (hx == 1 && vx == 1) {
                std::memcpy(o, row(y), static_cast<size_t>(W));
            } else if (hx == 2 && vx == 1 && c.dw > 2) {  // h2v1_fancy_upsample
                const uint8_t* ip = row(y);
                uint8_t* t = tmp.data();
                t[0] = ip[0];
                t[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
                for (int i = 1; i < c.dw - 1; ++i) {
                    const int v = ip[i] * 3;
                    t[2 * i] = static_cast<uint8_t>((v + ip[i - 1] + 1) >> 2);
                    t[2 * i + 1] = static_cast<uint8_t>((v + ip[i + 1] + 2) >> 2);
                }
                const int last = c.dw - 1;
                t[2 * last] = static_cast<uint8_t>((ip[last] * 3 + ip[last - 1] + 1) >> 2);
                t[2 * last + 1] = ip[last];
                std::memcpy(o, t, static_cast<size_t>(W));
            } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
                const int i = y / 2;
                const uint8_t* p0 = row(i);
                const uint8_t* p1 = row(y % 2 ? i + 1 : i - 1);
                const int bias = y % 2 ? 2 : 1;
                for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
            } else if (hx == 2 && vx == 2 && c.dw > 2) {  // h2v2_fancy_upsample
                const int i = y / 2;
                const uint8_t* p0 = row(i);
                const uint8_t* p1 = row(y % 2 ? i + 1 : i - 1);
                uint8_t* t = tmp.data();
                int this_sum = p0[0] * 3 + p1[0];
                int next_sum = p0[1] * 3 + p1[1];
                t[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
                t[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
                int last_sum = this_sum;
                this_sum = next_sum;
                for (int col = 2; col < c.dw; ++col) {
                    next_sum = p0[col] * 3 + p1[col];
                    t[2 * col - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
                    t[2 * col - 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
                    last_sum = this_sum;
                    this_sum = next_sum;
                }
                const int last = c.dw - 1;
                t[2 * last] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
                t[2 * last + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
                std::memcpy(o, t, static_cast<size_t>(W));
            } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
                const uint8_t* ip = in + static_cast<size_t>(y / vx) * stride;
                for (int x = 0; x < W; ++x) o[x] = ip[x / hx];
            }
        }
    }

    const uint8_t* d_;
    size_t n_;
    Huffman dc_[4], ac_[4];
    uint16_t quant_[4][64] = {};
    bool quant_set_[4] = {false, false, false, false};
    std::vector<Component> comps_;
    bool sof_seen_ = false, progressive_ = false;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    int restart_interval_ = 0, eobrun_ = 0, scans_ = 0;
    bool buffered_ = false;
};

void copy_error(const char* what, char* err, int64_t cap) {
    if (cap <= 0) return;
    std::strncpy(err, what, static_cast<size_t>(cap - 1));
    err[cap - 1] = '\0';
}

}  // namespace

// info[0..2] = height, width, output channels (1 gray, 3 RGB) of the JPEG file
// data[0..size). Returns 0, or 1 with a message in err.
extern "C" int64_t jpeg_header(const uint8_t* data, int64_t size, int64_t* info, char* err,
                               int64_t err_cap) {
    try {
        Decoder(data, static_cast<size_t>(size)).header(info);
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, err_cap);
        return 1;
    }
}

// The pixels of the JPEG file into out: height * width * channels bytes as
// jpeg_header gave them. Returns 0, or 1 with a message in err.
extern "C" int64_t jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, char* err,
                               int64_t err_cap) {
    try {
        Decoder(data, static_cast<size_t>(size)).decode(out);
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, err_cap);
        return 1;
    }
}
