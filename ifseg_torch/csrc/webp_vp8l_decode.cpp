// WebP lossless (VP8L) image data and WebP alpha planes on the host, as
// libwebp 1.6's decoder reads them (`ifseg_torch/data/webp.py` parses the
// RIFF container around them).
//
// A VP8L stream: the 0x2f signature, 14-bit width - 1 and height - 1, the
// alpha hint and a 3-bit version that must be 0 (ReadImageInfo); then the
// transforms, each type at most once (predictor with its 14 modes, 14 and 15
// reading black; cross-colour; subtract-green; colour indexing with pixel
// bundling at <= 16, 4 and 2 colours and a delta-coded palette); an optional
// colour cache of 1 to 11 bits; the prefix codes, one group or an entropy
// image of groups; the LZ77-coded ARGB pixels with the 120-entry distance map.
// The transforms are undone in the reverse order of their reading.
//
// libwebp's refusals are kept: a code whose lengths are all 0, or that is not
// complete (more than one symbol whose Kraft sum is not 1); a run of repeated
// code lengths past the alphabet; a backward copy from before the first pixel
// or past the last; a colour cache symbol where there is no cache; and any
// read past the end of the data. The bit reader is libwebp's: least
// significant bit first, and the end of the stream comes once more bits were
// consumed than the data holds (or than 64, for data of fewer than 8 bytes,
// whose 64-bit window reads zeros past its end).
//
// An alpha plane (`ALPH`) is raw or a VP8L stream without its header whose
// green channel is the alpha; libwebp decodes the latter 8 bits a pixel when
// its only transform is colour indexing, it has no colour cache and its red,
// blue and alpha codes have one symbol each, and then refuses a read past the
// end only before the last pixel. The plane is then unfiltered (horizontal,
// vertical or gradient, with libwebp's first-row and first-column rules).
//
// Every read of the input and every write of the output is bounds-checked:
// the decoders run inside a serving process. Built with the host C++ compiler
// at first use (`ifseg_torch/ops/build.py`) and called through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <utility>
#include <vector>

namespace {

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kMaxCodeLength = 15;
constexpr int kNumCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kNumCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256,
                                  kNumDistanceCodes};
// (y << 4) | (8 - x) of each of the 120 (x, y) neighbours of the distance map
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

enum Status : int64_t { kOk = 0, kBitstream = -1, kEndOfStream = -2 };

// libwebp's VP8LBitReader, reduced to what decides the bits and the end.
struct BitReader {
    const uint8_t* data;
    uint64_t nbits;  // bits of data
    uint64_t limit;  // consumed beyond this is the end of the stream
    uint64_t pos = 0;
    bool eos = false;

    BitReader(const uint8_t* d, int64_t n)
        : data(d), nbits(static_cast<uint64_t>(n) * 8),
          limit(static_cast<uint64_t>(n) * 8 > 64 ? static_cast<uint64_t>(n) * 8 : 64) {}

    // the next `n` (<= 24) bits without consuming them: zeros past the data,
    // and, with every bit consumed, libwebp's 64-bit window read from its
    // start again (its bit position wraps at 64)
    uint32_t peek(int n) const {
        uint64_t p = pos == limit ? pos - 64 : pos;
        const uint64_t byte = p >> 3, nbytes = nbits >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 8 && byte + i < nbytes; ++i)
            v |= static_cast<uint64_t>(data[byte + i]) << (8 * i);
        return static_cast<uint32_t>(v >> (p & 7)) & ((1u << n) - 1);
    }
    void skip(int n) { pos += n; }
    bool at_end() const { return eos || pos > limit; }
    // VP8LReadBits: 0 once the stream has ended
    uint32_t read(int n) {
        if (eos) return 0;
        const uint32_t v = peek(n);
        pos += n;
        if (pos > limit) eos = true;
        return v;
    }
};

// A canonical prefix code as libwebp builds it (BuildHuffmanTable): a code of
// one symbol reads no bits; otherwise the lengths must make a complete code.
// Decoded through a table of the next 8 bits (codes are sent first bit first,
// so the table is indexed by the bit-reversed code) and second-level tables
// for longer codes.
struct Code {
    int single = -1;  // the symbol of a one-symbol code
    // an entry: symbol | length << 16, or, in the root, a link: offset |
    // (sub-table bits) << 16 | 1 << 31
    std::vector<uint32_t> table;

    bool build(const int* lengths, int n) {
        int cnt[kMaxCodeLength + 1] = {};
        for (int s = 0; s < n; ++s) {
            if (lengths[s] > kMaxCodeLength) return false;
            ++cnt[lengths[s]];
        }
        if (cnt[0] == n) return false;
        for (int len = 1; len < kMaxCodeLength; ++len)
            if (cnt[len] > (1 << len)) return false;
        const int total = n - cnt[0];
        if (total == 1) {
            for (int s = 0; s < n; ++s)
                if (lengths[s] > 0) single = s;
            return true;
        }
        int num_nodes = 1, num_open = 1;
        for (int len = 1; len <= kMaxCodeLength; ++len) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= cnt[len];
            if (num_open < 0) return false;
        }
        if (num_nodes != 2 * total - 1) return false;
        // canonical codes, then their reversed bits
        int next[kMaxCodeLength + 1] = {};
        for (int len = 2; len <= kMaxCodeLength; ++len) next[len] = (next[len - 1] + cnt[len - 1]) << 1;
        std::vector<uint32_t> rev(n, 0);
        for (int s = 0; s < n; ++s) {
            const int len = lengths[s];
            if (!len) continue;
            const uint32_t code = next[len]++;
            uint32_t r = 0;
            for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
            rev[s] = r;
        }
        int sub_bits[256] = {};
        for (int s = 0; s < n; ++s)
            if (lengths[s] > 8 && lengths[s] - 8 > sub_bits[rev[s] & 255])
                sub_bits[rev[s] & 255] = lengths[s] - 8;
        size_t size = 256;
        uint32_t offset[256] = {};
        for (int r = 0; r < 256; ++r)
            if (sub_bits[r]) {
                offset[r] = static_cast<uint32_t>(size);
                size += size_t(1) << sub_bits[r];
            }
        table.assign(size, 0);
        for (int r = 0; r < 256; ++r)
            if (sub_bits[r]) table[r] = offset[r] | (static_cast<uint32_t>(sub_bits[r]) << 16) | (1u << 31);
        for (int s = 0; s < n; ++s) {
            const int len = lengths[s];
            if (!len) continue;
            if (len <= 8) {
                for (uint32_t k = rev[s]; k < 256; k += 1u << len)
                    table[k] = static_cast<uint32_t>(s) | (static_cast<uint32_t>(len) << 16);
            } else {
                const uint32_t root = rev[s] & 255, bits = sub_bits[root];
                for (uint32_t k = rev[s] >> 8; k < (1u << bits); k += 1u << (len - 8))
                    table[offset[root] + k] = static_cast<uint32_t>(s) | (static_cast<uint32_t>(len - 8) << 16);
            }
        }
        return true;
    }

    int read(BitReader& br) const {
        if (single >= 0) return single;
        uint32_t e = table[br.peek(8)];
        if (e & (1u << 31)) {
            br.skip(8);
            e = table[(e & 0xffff) + br.peek((e >> 16) & 0xff)];
        }
        br.skip((e >> 16) & 0xff);
        return static_cast<int>(e & 0xffff);
    }
};

struct Group {
    Code codes[5];  // green (+ length + cache), red, blue, alpha, distance
};

bool read_code_lengths(BitReader& br, const int* cl_lengths, int num_symbols, int* lengths) {
    Code cl;
    if (!cl.build(cl_lengths, kNumCodeLengthCodes)) return false;
    int max_symbol;
    if (br.read(1)) {
        const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
        max_symbol = 2 + static_cast<int>(br.read(length_nbits));
        if (max_symbol > num_symbols) return false;
    } else {
        max_symbol = num_symbols;
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        const int code_len = cl.read(br);
        if (code_len < 16) {
            lengths[symbol++] = code_len;
            if (code_len != 0) prev = code_len;
        } else {
            const int slot = code_len - 16;
            static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
            int repeat = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
            if (symbol + repeat > num_symbols) return false;
            const int length = slot == 0 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = length;
        }
    }
    return true;
}

// ReadHuffmanCode: false for libwebp's bitstream errors
bool read_code(BitReader& br, int alphabet, Code& out) {
    std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
    bool ok;
    if (br.read(1)) {  // simple code: one or two symbols of length 1
        const int num_symbols = static_cast<int>(br.read(1)) + 1;
        const int first_bits = br.read(1) ? 8 : 1;
        lengths[br.read(first_bits)] = 1;
        if (num_symbols == 2) lengths[br.read(8)] = 1;
        ok = true;
    } else {
        int cl[kNumCodeLengthCodes] = {};
        const int num_codes = static_cast<int>(br.read(4)) + 4;
        for (int i = 0; i < num_codes; ++i) cl[kCodeLengthCodeOrder[i]] = br.read(3);
        ok = read_code_lengths(br, cl, alphabet, lengths.data());
    }
    ok = ok && !br.eos;
    return ok && out.build(lengths.data(), alphabet);
}

inline int copy_length(int symbol, BitReader& br) {  // GetCopyDistance
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int64_t plane_distance(int64_t xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kCodeToPlane[code - 1];
    const int64_t dist = (dist_code >> 4) * xsize + (8 - (dist_code & 0xf));
    return dist >= 1 ? dist : 1;
}

inline int64_t subsample(int64_t size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// A vector that leaves its elements uninitialised: a large image buffer is
// then only committed where the decoder writes it.
template <typename T>
struct NoInit : std::allocator<T> {
    template <typename U>
    struct rebind {
        using other = NoInit<U>;
    };
    NoInit() = default;
    template <typename U>
    NoInit(const NoInit<U>&) {}
    template <typename U>
    void construct(U* p) noexcept {
        ::new (static_cast<void*>(p)) U;
    }
    template <typename U, typename... A>
    void construct(U* p, A&&... a) {
        ::new (static_cast<void*>(p)) U(std::forward<A>(a)...);
    }
};
using Pixels = std::vector<uint32_t, NoInit<uint32_t>>;

struct Transform {
    int type;
    int bits = 0;
    int64_t xsize, ysize;
    Pixels data;
};

constexpr int64_t kMaxPixels = int64_t(1) << 28;  // 16,384 x 16,384

struct Decoder {
    BitReader br;
    std::vector<Transform> transforms;
    unsigned seen = 0;

    explicit Decoder(const uint8_t* d, int64_t n) : br(d, n) {}

    Status image_stream(int64_t xsize, int64_t ysize, bool level0, Pixels& out,
                        bool alpha8 = false);
    Status read_transform(int64_t& xsize, int64_t ysize);
};

uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
    const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                            sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                            sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                            sub3(a & 0xff, b & 0xff, c & 0xff);
    return pa_minus_pb <= 0 ? a : b;
}

uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 24; s >= 0; s -= 8) {
        const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                      static_cast<int>((c2 >> s) & 0xff);
        out |= clip255(static_cast<uint32_t>(v)) << s;
    }
    return out;
}

uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 24; s >= 0; s -= 8) {
        const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
        out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
    }
    return out;
}

uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
    switch (mode) {
        case 1: return *left;
        case 2: return top[0];
        case 3: return top[1];
        case 4: return top[-1];
        case 5: return average2(average2(*left, top[1]), top[0]);
        case 6: return average2(*left, top[-1]);
        case 7: return average2(*left, top[0]);
        case 8: return average2(top[-1], top[0]);
        case 9: return average2(top[0], top[1]);
        case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
        case 11: return select_pred(top[0], *left, top[-1]);
        case 12: return clamped_full(*left, top[0], top[-1]);
        case 13: return clamped_half(*left, top[0], top[-1]);
        default: return 0xff000000u;  // 0, and 14 and 15
    }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

// One inverse transform over the whole image: `in` of (width after it) x
// ysize pixels -> `out` of xsize x ysize.
void inverse(const Transform& t, const Pixels& in, Pixels& out) {
    const int64_t w = t.xsize, h = t.ysize;
    switch (t.type) {
        case 0: {  // predictor
            out.resize(w * h);
            const int64_t tiles = subsample(w, t.bits);
            for (int64_t y = 0; y < h; ++y) {
                uint32_t* row = out.data() + y * w;
                const uint32_t* src = in.data() + y * w;
                if (y == 0) {
                    row[0] = add_pixels(src[0], 0xff000000u);
                    for (int64_t x = 1; x < w; ++x) row[x] = add_pixels(src[x], row[x - 1]);
                    continue;
                }
                const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
                row[0] = add_pixels(src[0], row[-w]);
                for (int64_t x = 1; x < w; ++x) {
                    const int mode = (modes[x >> t.bits] >> 8) & 0xf;
                    // the top-right of the last pixel is the row's first
                    row[x] = add_pixels(src[x], predict(mode, &row[x - 1], &row[x - w]));
                }
            }
            break;
        }
        case 1: {  // cross-colour
            out.resize(w * h);
            const int64_t tiles = subsample(w, t.bits);
            for (int64_t y = 0; y < h; ++y) {
                const uint32_t* codes = t.data.data() + (y >> t.bits) * tiles;
                for (int64_t x = 0; x < w; ++x) {
                    const uint32_t code = codes[x >> t.bits];
                    const int g2r = static_cast<int8_t>(code & 0xff);
                    const int g2b = static_cast<int8_t>((code >> 8) & 0xff);
                    const int r2b = static_cast<int8_t>((code >> 16) & 0xff);
                    const uint32_t argb = in[y * w + x];
                    const int green = static_cast<int8_t>(argb >> 8);
                    int red = (argb >> 16) & 0xff, blue = argb & 0xff;
                    red = (red + ((g2r * green) >> 5)) & 0xff;
                    blue += (g2b * green) >> 5;
                    blue += (r2b * static_cast<int8_t>(red)) >> 5;
                    blue &= 0xff;
                    out[y * w + x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                                     static_cast<uint32_t>(blue);
                }
            }
            break;
        }
        case 2: {  // subtract green
            out.resize(w * h);
            for (int64_t i = 0; i < w * h; ++i) {
                const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
                const uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
                out[i] = (argb & 0xff00ff00u) | rb;
            }
            break;
        }
        default: {  // colour indexing
            out.resize(w * h);
            const int bits_per_pixel = 8 >> t.bits;
            const int count_mask = (1 << t.bits) - 1;
            const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
            const int64_t in_w = subsample(w, t.bits);
            for (int64_t y = 0; y < h; ++y) {
                const uint32_t* src = in.data() + y * in_w;
                uint32_t packed = 0;
                for (int64_t x = 0; x < w; ++x) {
                    if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
                    out[y * w + x] = t.data[packed & bit_mask];
                    packed >>= bits_per_pixel;
                }
            }
            break;
        }
    }
}

Status Decoder::read_transform(int64_t& xsize, int64_t ysize) {
    const int type = static_cast<int>(br.read(2));
    if (seen & (1u << type)) return kBitstream;
    seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == 0 || type == 1) {
        t.bits = 2 + static_cast<int>(br.read(3));
        Status s = image_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false, t.data);
        if (s != kOk) return s;
    } else if (type == 3) {
        const int num_colors = static_cast<int>(br.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        xsize = subsample(xsize, t.bits);
        Pixels palette;
        Status s = image_stream(num_colors, 1, false, palette);
        if (s != kOk) return s;
        // ExpandColorMap: the palette is delta-coded byte by byte; 1 << (8 >> bits)
        // entries, zero past the colours given
        t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0u);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(palette.data());
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        for (int i = 0; i < 4; ++i) dst[i] = src[i];
        for (int i = 4; i < 4 * num_colors; ++i) dst[i] = static_cast<uint8_t>(src[i] + dst[i - 4]);
    }
    transforms.push_back(std::move(t));
    return kOk;
}

// DecodeImageStream + DecodeImageData (or DecodeAlphaData for `alpha8`):
// the entropy-coded pixels of one (sub-)image, transforms not undone.
Status Decoder::image_stream(int64_t xsize, int64_t ysize, bool level0, Pixels& out,
                             bool alpha8) {
    int64_t tx = xsize, ty = ysize;
    if (level0) {
        while (br.read(1)) {
            Status s = read_transform(tx, ty);
            if (s != kOk) return s;
        }
    }
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = static_cast<int>(br.read(4));
        if (cache_bits < 1 || cache_bits > kMaxCacheBits) return kBitstream;
    }
    // the prefix codes, with an entropy image at level 0
    int huff_bits = 0;
    int64_t huff_xsize = 0;
    Pixels huff_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
        huff_bits = 2 + static_cast<int>(br.read(3));
        huff_xsize = subsample(tx, huff_bits);
        Status s = image_stream(huff_xsize, subsample(ty, huff_bits), false, huff_image);
        if (s != kOk) return s;
        for (auto& g : huff_image) {
            g = (g >> 8) & 0xffff;
            if (static_cast<int>(g) >= num_groups) num_groups = static_cast<int>(g) + 1;
        }
    }
    if (br.eos) return kEndOfStream;
    std::vector<Group> groups(num_groups);
    for (auto& g : groups) {
        for (int j = 0; j < 5; ++j) {
            int alphabet = kAlphabetSize[j];
            if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
            if (!read_code(br, alphabet, g.codes[j])) return br.eos ? kEndOfStream : kBitstream;
        }
    }
    if (level0 && alpha8) {
        // DecodeAlphaData applies when the only transform is colour indexing
        // and nothing but green is coded
        bool ok8 = transforms.size() == 1 && transforms[0].type == 3 && cache_bits == 0;
        for (const auto& g : groups)
            ok8 = ok8 && g.codes[1].single >= 0 && g.codes[2].single >= 0 && g.codes[3].single >= 0;
        alpha8 = ok8;
    } else {
        alpha8 = false;
    }
    out.resize(tx * ty);  // at most the image's size: sub-images are smaller
    const int64_t total = tx * ty;
    std::vector<uint32_t> cache(cache_bits ? (size_t(1) << cache_bits) : 0, 0);
    int64_t cached = 0;
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_limit + (cache_bits ? (1 << cache_bits) : 0);
    auto insert_until = [&](int64_t end) {
        for (; cached < end; ++cached)
            cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
    };
    int64_t pos = 0;
    // DecodeImageData checks the end of the stream within each symbol;
    // DecodeAlphaData only after it
    while (pos < total && !(alpha8 && br.at_end())) {
        const Group* g = &groups[0];
        if (huff_bits) {
            const int64_t col = pos % tx, row = pos / tx;
            g = &groups[huff_image[(row >> huff_bits) * huff_xsize + (col >> huff_bits)]];
        }
        const int code = g->codes[0].read(br);
        if (!alpha8 && br.at_end()) break;
        if (code < kNumLiteralCodes) {
            const int red = g->codes[1].read(br);
            const int blue = g->codes[2].read(br);
            const int alpha = g->codes[3].read(br);
            if (!alpha8 && br.at_end()) break;
            out[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        } else if (code < len_limit) {
            const int length = copy_length(code - kNumLiteralCodes, br);
            const int dist_symbol = g->codes[4].read(br);
            const int64_t dist = plane_distance(tx, copy_length(dist_symbol, br));
            if (!alpha8 && br.at_end()) break;
            if (pos < dist || total - pos < length) return kBitstream;
            for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
        } else if (code < cache_limit) {
            insert_until(pos);
            out[pos++] = cache[code - len_limit];
        } else {
            return kBitstream;
        }
        if (cache_bits) insert_until(pos);
    }
    if (br.at_end() && (!alpha8 || pos < total)) return kEndOfStream;
    return kOk;
}

// the transforms undone, last read first: ARGB of the image
Status finish(Decoder& dec, Pixels& pixels) {
    Pixels tmp;
    for (auto it = dec.transforms.rbegin(); it != dec.transforms.rend(); ++it) {
        inverse(*it, pixels, tmp);
        pixels.swap(tmp);
    }
    return kOk;
}

}  // namespace

// Decode the VP8L chunk payload `data` (n bytes, its 5-byte header first)
// of a w x h image into `argb` (w * h ARGB words). Returns 0, or a negative
// code: -1 a bitstream error, -2 a read past the end.
extern "C" int64_t webp_vp8l_decode(const uint8_t* data, int64_t n, int64_t w, int64_t h,
                                    uint32_t* argb) {
    if (n < 5 || w <= 0 || h <= 0 || w * h > kMaxPixels) return kBitstream;
    Decoder dec(data, n);
    if (dec.br.read(8) != 0x2f) return kBitstream;
    const int64_t width = dec.br.read(14) + 1, height = dec.br.read(14) + 1;
    dec.br.read(1);
    if (dec.br.read(3) != 0 || dec.br.eos) return kBitstream;
    if (width != w || height != h) return kBitstream;
    Pixels pixels;
    Status s = dec.image_stream(w, h, true, pixels);
    if (s != kOk) return s;
    finish(dec, pixels);
    std::memcpy(argb, pixels.data(), sizeof(uint32_t) * w * h);
    return kOk;
}

// The w x h alpha plane of an ALPH chunk payload (`data`, n bytes, its header
// byte first) into `alpha`. Returns 0 or a negative code as above.
extern "C" int64_t webp_alpha_decode(const uint8_t* data, int64_t n, int64_t w, int64_t h,
                                     uint8_t* alpha) {
    if (n <= 1 || w <= 0 || h <= 0 || w * h > kMaxPixels) return kBitstream;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
    if (method > 1 || pre > 1 || reserved != 0) return kBitstream;
    const int64_t total = w * h;
    if (method == 0) {
        if (n - 1 < total) return kBitstream;
        std::memcpy(alpha, data + 1, total);
    } else {
        Decoder dec(data + 1, n - 1);
        Pixels pixels;
        Status s = dec.image_stream(w, h, true, pixels, true);
        if (s != kOk) return s;
        finish(dec, pixels);
        for (int64_t i = 0; i < total; ++i) alpha[i] = (pixels[i] >> 8) & 0xff;
    }
    // WebPUnfilters: horizontal, vertical, gradient; the first row is
    // predicted from the left (its first pixel from 0)
    if (filter != 0) {
        for (int64_t y = 0; y < h; ++y) {
            uint8_t* row = alpha + y * w;
            const uint8_t* prev = y ? row - w : nullptr;
            if (prev == nullptr || filter == 1) {
                uint8_t pred = prev ? prev[0] : 0;
                for (int64_t x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
            } else if (filter == 2) {
                for (int64_t x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
            } else {
                int top_left = prev[0], left = prev[0];
                for (int64_t x = 0; x < w; ++x) {
                    const int top = prev[x];
                    const int g = left + top - top_left;
                    const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
                    left = static_cast<uint8_t>(row[x] + pred);
                    top_left = top;
                    row[x] = static_cast<uint8_t>(left);
                }
            }
        }
    }
    return kOk;
}
