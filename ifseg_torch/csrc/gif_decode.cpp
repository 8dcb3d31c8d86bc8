// The LZW image data of one GIF frame on the host, as Pillow's GifDecode.c
// decodes it (`ifseg_torch/data/gif.py` parses the file around it).
//
// The codes are read LSB first from the frame's sub-blocks, joined; the code
// size starts at the minimum code size + 1 and grows to at most 12 bits when
// the table's next free entry reaches the code mask; a full table of 4,096
// entries stops growing and keeps decoding (no clear code is needed); a clear
// code right after a clear is ignored. Interlaced frames fill rows 0, 8, ...,
// then 4, 12, ..., then 2, 6, ..., then 1, 3, .... Decoding stops at the end
// code, when the frame is full, where the data ends, and at a broken code (a
// first code after a clear above the clear code, or a code above the next
// free entry): what was decoded before stays, as Pillow leaves it under
// ImageFile.LOAD_TRUNCATED_IMAGES, which the JAX package sets. Frame 0 takes
// no transparency: every index is written. Built with the host C++ compiler
// at first use (`ifseg_torch/ops/build.py`) and called through ctypes.

#include <cstdint>

namespace {

constexpr int kTable = 4096;  // GIFTABLE
constexpr int kMaxBits = 12;  // GIFBITS

// the frame's rows in the order the data gives them
struct Rows {
    int64_t y = 0, step, h;
    int pass;
    Rows(int64_t height, bool interlace) : step(interlace ? 8 : 1), h(height), pass(interlace ? 1 : 0) {}

    // the next row; false once the frame is done
    bool next() {
        y += step;
        while (y >= h) {
            if (pass == 1) {
                y = 4;
                pass = 2;
            } else if (pass == 2) {
                step = 4;
                y = 2;
                pass = 3;
            } else if (pass == 3) {
                step = 2;
                y = 1;
                pass = 4;
            } else {
                return false;
            }
        }
        return true;
    }
};

}  // namespace

// Decode `n` bytes of joined sub-block data with LZW minimum code size `bits`
// into the (fh, fw) frame whose top-left pixel is canvas[0] (row pitch
// `pitch`). Returns the number of pixels written.
extern "C" int64_t gif_lzw(const uint8_t* data, int64_t n, int64_t bits, uint8_t* canvas,
                           int64_t pitch, int64_t fw, int64_t fh, int64_t interlace) {
    if (fw <= 0 || fh <= 0) return 0;
    uint8_t suffix[kTable] = {};  // on the stack: thread_local costs a TLS lookup an access
    uint16_t link[kTable] = {};
    uint8_t stack[kTable + 1];
    const int clear = 1 << bits, end = clear + 1;
    int next = clear + 2, codesize = static_cast<int>(bits) + 1, codemask = (1 << codesize) - 1;
    int state = 2;  // 2: just after a clear, 3: decoding
    int lastcode = 0, lastdata = 0;
    uint32_t bitbuf = 0;
    int bitcount = 0;
    int64_t pos = 0, x = 0, written = 0;
    Rows rows(fh, interlace != 0);
    uint8_t* out = canvas;
    while (true) {
        while (bitcount < codesize) {
            if (pos >= n) return written;
            bitbuf |= static_cast<uint32_t>(data[pos++]) << bitcount;
            bitcount += 8;
        }
        int c = static_cast<int>(bitbuf & static_cast<uint32_t>(codemask));
        bitbuf >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
            if (state != 2) {
                next = clear + 2;
                codesize = static_cast<int>(bits) + 1;
                codemask = (1 << codesize) - 1;
                state = 2;
            }
            continue;
        }
        if (c == end) return written;
        int top = kTable + 1;  // the string is built from the right
        if (state == 2) {
            if (c > clear) return written;  // broken
            lastdata = lastcode = c;
            stack[--top] = static_cast<uint8_t>(c);
            state = 3;
        } else {
            const int thiscode = c;
            if (c > next) return written;  // broken
            if (c == next) {
                stack[--top] = static_cast<uint8_t>(lastdata);
                c = lastcode;
            }
            while (c >= clear) {
                if (top <= 0 || c >= kTable) return written;
                stack[--top] = suffix[c];
                c = link[c];
            }
            stack[--top] = static_cast<uint8_t>(c);
            lastdata = c;
            if (next < kTable) {
                suffix[next] = static_cast<uint8_t>(c);
                link[next] = static_cast<uint16_t>(lastcode);
                if (next == codemask && codesize < kMaxBits) {
                    ++codesize;
                    codemask = (1 << codesize) - 1;
                }
                ++next;
            }
            lastcode = thiscode;
        }
        for (int i = top; i <= kTable; ++i) {
            out[x] = stack[i];
            ++written;
            if (++x >= fw) {
                x = 0;
                if (!rows.next()) return written;
                out = canvas + rows.y * pitch;
            }
        }
    }
}
