// The RLE8 and RLE4 pixel data of a BMP file on the host, as Pillow's
// BmpImagePlugin `BmpRleDecoder` reads it (`ifseg_torch/data/bmp.py` parses
// the headers around it).
//
// A pair (count, byte) is a run of `count` pixels of `byte` (RLE4: its two
// nibbles in turn), clipped at the row's end; (0, 0) ends the row (its rest
// stays 0), (0, 1) ends the bitmap, (0, 2) is a delta (Pillow reads two
// bytes more, then the two it uses: right, up), and (0, n) for n >= 3 is an
// absolute run of n bytes (RLE4: n / 2 bytes of two nibbles each), after
// which the file's position moves to an even offset. Decoding stops where
// the data ends. The pixels are counted as Pillow counts them, past the
// image's end too; only the first width * height are kept. A Python loop
// costs hundreds of ms for a 1,024 x 1,366 file. Built with the host C++
// compiler at first use (`ifseg_torch/ops/build.py`) and called through
// ctypes, which releases the interpreter lock for the call.

#include <cstdint>

// data: the whole file (n bytes); pos: the offset of the pixel data; out:
// width * height bytes, zeroed by the caller, filled in file order (the
// bottom row first unless the file is top-down). Returns the number of
// pixels the stream gave (at least width * height when it was whole), or -1
// where a delta's two bytes are cut off.
extern "C" int64_t bmp_rle(const uint8_t* data, int64_t n, int64_t pos, int64_t width,
                           int64_t height, int64_t rle4, uint8_t* out) {
    const int64_t need = width * height;
    int64_t len = 0, x = 0;
    auto put = [&](uint8_t v) {
        if (len < need) out[len] = v;
        ++len;
    };
    while (len < need) {
        if (pos + 2 > n) break;
        int64_t count = data[pos];
        const uint8_t byte = data[pos + 1];
        pos += 2;
        if (count) {  // a run
            if (x + count > width) count = width - x > 0 ? width - x : 0;
            if (rle4) {
                const uint8_t pair[2] = {static_cast<uint8_t>(byte >> 4),
                                         static_cast<uint8_t>(byte & 15)};
                for (int64_t i = 0; i < count; ++i) put(pair[i & 1]);
            } else {
                for (int64_t i = 0; i < count; ++i) put(byte);
            }
            x += count;
        } else if (byte == 0) {  // end of line: the rest of the row stays 0
            if (width) len += (width - len % width) % width;
            x = 0;
        } else if (byte == 1) {  // end of bitmap
            break;
        } else if (byte == 2) {  // delta
            if (pos + 2 > n) break;
            if (pos + 4 > n) return -1;
            len += data[pos + 2] + static_cast<int64_t>(data[pos + 3]) * width;
            pos += 4;
            x = len % width;
        } else {  // an absolute run
            const int64_t take = rle4 ? byte / 2 : byte;
            const int64_t got = pos + take <= n ? take : n - pos;
            for (int64_t i = 0; i < got; ++i) {
                const uint8_t c = data[pos + i];
                if (rle4) {
                    put(c >> 4);
                    put(c & 15);
                } else {
                    put(c);
                }
            }
            pos += got;
            if (got < take) break;
            x += byte;
            pos += pos % 2;  // to a 16-bit boundary of the file
        }
    }
    return len;
}
