// The LZW and PackBits strips and tiles of TIFF files on the host, as the
// libtiff that PIL links decodes them (`ifseg_torch/data/tiff.py` parses the
// file around them and inflates Deflate data with zlib).
//
//   LZW       tif_lzw.c LZWDecode: codes MSB first, 9 bits wide after each
//             clear code (256) up to 12, one code early (the width grows once
//             the next free entry reaches 2^width - 1); the end code (257)
//             stops; a code above the next free entry is broken
//   PackBits  tif_packbits.c PackBitsDecode: n in 0..127 copies n + 1 bytes,
//             -127..-1 repeats the next byte 1 - n times, -128 is skipped
//
// Each returns the bytes it wrote (at most `cap`), or -1 for broken data;
// tiff.py raises where a strip or tile comes out short, as libtiff does
// ("Not enough data"). Built with the host C++ compiler at first use
// (`ifseg_torch/ops/build.py`) and called through ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256, kEnd = 257, kFirst = 258, kMaxBits = 12, kTable = 1 << kMaxBits;

}  // namespace

extern "C" int64_t tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    // on the stack: thread_local tables in a shared library cost a TLS
    // lookup an access, three times the decode's time
    uint16_t prefix[kTable] = {}, length[kTable] = {};
    uint8_t suffix[kTable] = {}, first[kTable] = {};
    for (int i = 0; i < 256; ++i) {
        suffix[i] = first[i] = static_cast<uint8_t>(i);
        length[i] = 1;
    }
    int nbits = 9, next = kFirst, prev = -1;
    uint64_t buf = 0;
    int have = 0;
    int64_t pos = 0, o = 0;
    while (o < cap) {
        while (have < nbits) {
            if (pos >= n) return o;  // the data ended: short
            buf = (buf << 8) | in[pos++];
            have += 8;
        }
        const int code = static_cast<int>((buf >> (have - nbits)) & ((1u << nbits) - 1));
        have -= nbits;
        if (code == kEnd) return o;
        if (code == kClear) {
            nbits = 9;
            next = kFirst;
            prev = -1;
            continue;
        }
        int emit;  // the code whose string is written
        if (prev < 0) {
            if (code >= 256) return -1;
            emit = code;
        } else {
            if (code > next || next >= kTable) return -1;
            // the new entry: prev's string and the first byte of code's (or
            // of prev's, for the code being defined)
            prefix[next] = static_cast<uint16_t>(prev);
            first[next] = first[prev];
            suffix[next] = code == next ? first[prev] : first[code];
            length[next] = static_cast<uint16_t>(length[prev] + 1);
            ++next;
            if (next >= (1 << nbits) - 1 && nbits < kMaxBits) ++nbits;
            emit = code;
        }
        // write emit's string backwards, cut at cap
        const int64_t len = length[emit];
        int64_t end = o + len;
        int c = emit;
        for (int64_t i = end - 1; i >= o; --i) {
            if (i < cap) out[i] = suffix[c];
            c = prefix[c];
        }
        o = end < cap ? end : cap;
        prev = code;
    }
    return o;
}

extern "C" int64_t tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0, o = 0;
    while (pos < n && o < cap) {
        const int b = static_cast<int8_t>(in[pos++]);
        if (b >= 0) {
            int64_t k = b + 1;
            if (pos + k > n) k = n - pos;
            if (o + k > cap) k = cap - o;
            std::memcpy(out + o, in + pos, static_cast<size_t>(k));
            pos += b + 1;
            o += k;
        } else if (b != -128) {
            if (pos >= n) break;
            int64_t k = 1 - b;
            if (o + k > cap) k = cap - o;
            std::memset(out + o, in[pos++], static_cast<size_t>(k));
            o += k;
        }
    }
    return o;
}
