// WebP lossy (VP8 key frame) image data on the host, as libwebp 1.6's
// decoder reads it (`ifseg_torch/data/webp.py` parses the RIFF container
// around it), to RGBA with libwebp's "fancy" chroma upsampler, which
// WebPAnimDecoder (and so PIL) uses.
//
// The frame (RFC 6386): the 3-byte frame tag (a key frame of profile 0 to 3
// that is shown; the first partition's size), the start code 9d 01 2a and
// 14-bit sizes (the scale bits are ignored); in the first partition the
// segment header (map probabilities, quantizer and filter levels, absolute or
// relative), the filter header (simple or normal, level, sharpness, mode and
// reference deltas), the token partition count (1, 2, 4 or 8; the sizes of
// all but the last are 3 bytes each, clamped to what is left), the
// quantizer indices and deltas, the coefficient probability updates and the
// skip probability; then, a macroblock row at a time, the segment, skip flag
// and intra modes (16 x 16, or B_PRED with the above/left context of each 4 x
// 4 block; chroma) from the first partition, and the tokens of row y from
// partition y mod count, with their non-zero contexts.
//
// Dequantization: kDcTable / kAcTable at the clamped indices, the Y2 DC
// doubled, the Y2 AC times 155 / 100 and at least 8, the chroma DC index at
// most 117; each coefficient is stored as int16, wrapping, as libwebp's are.
// The inverse WHT of the Y2 block, then per 4 x 4 block the transform libwebp
// picks from the last non-zero coefficient: none, DC only, the "AC3" one
// (coefficients 0, 1 and 4) or the full IDCT, which on x86 is libwebp's SSE2
// code, computed here in its 16-bit wrapping arithmetic; chroma takes the
// full transform for all four blocks of a plane when any has an AC
// coefficient. These agree on every legal stream; they differ only where a
// damaged one overflows 16 bits, and there the port takes libwebp's choice.
//
// Prediction uses the unfiltered reconstruction with libwebp's borders: 127
// above the image (the corner too), 129 left of it (the corner below the top
// row too), the top-right of a B_PRED macroblock's right column taken from
// the row above (the last pixel of the row above, repeated, on the right
// edge; 127 on the top row). The loop filter then runs over the frame, a
// macroblock at a time in raster order: the left edge, the inner vertical
// edges, the top edge, the inner horizontal edges (the inner ones only for a
// B_PRED macroblock or one with coefficients); simple (luma only) or normal,
// with the per-segment and per-mode levels, sharpness, interior limit and
// high-edge-variance threshold of libwebp's PrecomputeFilterStrengths. No
// filter runs at all when the frame's level is 0.
//
// The boolean decoder is libwebp's VP8BitReader, whose end rule decides
// between a picture and "premature end of file": past the last byte it reads
// one zero byte and marks the end, and a macroblock row whose modes, or a
// macroblock whose tokens, reached that mark fails the whole picture. Its
// 56-bit loads and its sign bit (VP8GetSigned) are kept too: on a damaged
// partition whose value outgrows its range they decide other bits than a
// byte-wise reader and a plain bit of probability 1/2 would.
//
// YUV -> RGB: the fancy upsampler (each chroma sample of a pair of rows from
// the two nearest chroma rows and columns, (9, 3, 3, 1) weights in libwebp's
// two-step rounding; the first row and an even height's last row from one
// chroma row) and libwebp's 14-bit VP8YUVToR/G/B. Alpha is 255; the caller
// writes an ALPH plane over it.
//
// Every read of the input and every write of the output is bounds-checked:
// the decoder runs inside a serving process. Built with the host C++ compiler
// at first use (`ifseg_torch/ops/build.py`) and called through ctypes.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {{{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
   {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
   {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
   {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
   {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
   {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
   {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
   {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
const uint8_t kCoeffsProba0[4][8][3][11] = {{{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
   {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
   {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
  {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
   {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
   {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
  {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
   {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
   {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
  {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
   {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
   {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
  {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
   {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
   {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
  {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
   {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
   {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
   {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
   {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
  {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
   {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
   {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
  {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
   {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
   {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
  {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
   {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
   {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
  {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
   {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
   {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
  {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
   {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
   {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
  {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
   {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
   {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
  {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
   {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
   {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
   {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
  {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
   {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
   {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
  {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
   {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
   {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
  {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
   {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
   {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
  {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
   {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
   {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
   {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
   {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
   {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
   {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
   {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
  {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
   {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
   {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
  {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
   {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
   {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
  {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
   {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
   {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
  {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
   {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
   {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
  {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
   {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
   {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
  {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
   {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
   {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
   {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
const uint8_t kBModesProba[10][10][9] = {{{231, 120, 48, 89, 115, 113, 120, 152, 112},
  {152, 179, 64, 126, 170, 118, 46, 70, 95},
  {175, 69, 143, 80, 85, 82, 72, 155, 103},
  {56, 58, 10, 171, 218, 189, 17, 13, 152},
  {114, 26, 17, 163, 44, 195, 21, 10, 173},
  {121, 24, 80, 195, 26, 62, 44, 64, 85},
  {144, 71, 10, 38, 171, 213, 144, 34, 26},
  {170, 46, 55, 19, 136, 160, 33, 206, 71},
  {63, 20, 8, 114, 114, 208, 12, 9, 226},
  {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {{134, 183, 89, 137, 98, 101, 106, 165, 148},
  {72, 187, 100, 130, 157, 111, 32, 75, 80},
  {66, 102, 167, 99, 74, 62, 40, 234, 128},
  {41, 53, 9, 178, 241, 141, 26, 8, 107},
  {74, 43, 26, 146, 73, 166, 49, 23, 157},
  {65, 38, 105, 160, 51, 52, 31, 115, 128},
  {104, 79, 12, 27, 217, 255, 87, 17, 7},
  {87, 68, 71, 44, 114, 51, 15, 186, 23},
  {47, 41, 14, 110, 182, 183, 21, 17, 194},
  {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {{88, 88, 147, 150, 42, 46, 45, 196, 205},
  {43, 97, 183, 117, 85, 38, 35, 179, 61},
  {39, 53, 200, 87, 26, 21, 43, 232, 171},
  {56, 34, 51, 104, 114, 102, 29, 93, 77},
  {39, 28, 85, 171, 58, 165, 90, 98, 64},
  {34, 22, 116, 206, 23, 34, 43, 166, 73},
  {107, 54, 32, 26, 51, 1, 81, 43, 31},
  {68, 25, 106, 22, 64, 171, 36, 225, 114},
  {34, 19, 21, 102, 132, 188, 16, 76, 124},
  {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {{193, 101, 35, 159, 215, 111, 89, 46, 111},
  {60, 148, 31, 172, 219, 228, 21, 18, 111},
  {112, 113, 77, 85, 179, 255, 38, 120, 114},
  {40, 42, 1, 196, 245, 209, 10, 25, 109},
  {88, 43, 29, 140, 166, 213, 37, 43, 154},
  {61, 63, 30, 155, 67, 45, 68, 1, 209},
  {100, 80, 8, 43, 154, 1, 51, 26, 71},
  {142, 78, 78, 16, 255, 128, 34, 197, 171},
  {41, 40, 5, 102, 211, 183, 4, 1, 221},
  {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {{138, 31, 36, 171, 27, 166, 38, 44, 229},
  {67, 87, 58, 169, 82, 115, 26, 59, 179},
  {63, 59, 90, 180, 59, 166, 93, 73, 154},
  {40, 40, 21, 116, 143, 209, 34, 39, 175},
  {47, 15, 16, 183, 34, 223, 49, 45, 183},
  {46, 17, 33, 183, 6, 98, 15, 32, 183},
  {57, 46, 22, 24, 128, 1, 54, 17, 37},
  {65, 32, 73, 115, 28, 128, 23, 128, 205},
  {40, 3, 9, 115, 51, 192, 18, 6, 223},
  {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {{104, 55, 44, 218, 9, 54, 53, 130, 226},
  {64, 90, 70, 205, 40, 41, 23, 26, 57},
  {54, 57, 112, 184, 5, 41, 38, 166, 213},
  {30, 34, 26, 133, 152, 116, 10, 32, 134},
  {39, 19, 53, 221, 26, 114, 32, 73, 255},
  {31, 9, 65, 234, 2, 15, 1, 118, 73},
  {75, 32, 12, 51, 192, 255, 160, 43, 51},
  {88, 31, 35, 67, 102, 85, 55, 186, 85},
  {56, 21, 23, 111, 59, 205, 45, 37, 192},
  {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {{125, 98, 42, 88, 104, 85, 117, 175, 82},
  {95, 84, 53, 89, 128, 100, 113, 101, 45},
  {75, 79, 123, 47, 51, 128, 81, 171, 1},
  {57, 17, 5, 71, 102, 57, 53, 41, 49},
  {38, 33, 13, 121, 57, 73, 26, 1, 85},
  {41, 10, 67, 138, 77, 110, 90, 47, 114},
  {115, 21, 2, 10, 102, 255, 166, 23, 6},
  {101, 29, 16, 10, 85, 128, 101, 196, 26},
  {57, 18, 10, 102, 102, 213, 34, 20, 43},
  {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {{102, 61, 71, 37, 34, 53, 31, 243, 192},
  {69, 60, 71, 38, 73, 119, 28, 222, 37},
  {68, 45, 128, 34, 1, 47, 11, 245, 171},
  {62, 17, 19, 70, 146, 85, 55, 62, 70},
  {37, 43, 37, 154, 100, 163, 85, 160, 1},
  {63, 9, 92, 136, 28, 64, 32, 201, 85},
  {75, 15, 9, 9, 64, 255, 184, 119, 16},
  {86, 6, 28, 5, 64, 255, 25, 248, 1},
  {56, 8, 17, 132, 137, 255, 55, 116, 128},
  {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {{164, 50, 31, 137, 154, 133, 25, 35, 218},
  {51, 103, 44, 131, 131, 123, 31, 6, 158},
  {86, 40, 64, 135, 148, 224, 45, 183, 128},
  {22, 26, 17, 131, 240, 154, 14, 1, 209},
  {45, 16, 21, 91, 64, 222, 7, 1, 197},
  {56, 21, 39, 155, 60, 138, 23, 102, 213},
  {83, 12, 13, 54, 192, 255, 68, 47, 28},
  {85, 26, 85, 85, 128, 128, 32, 146, 171},
  {18, 11, 7, 63, 144, 171, 4, 4, 246},
  {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {{190, 80, 35, 99, 180, 80, 126, 54, 45},
  {85, 126, 47, 87, 176, 51, 41, 20, 32},
  {101, 75, 128, 139, 118, 146, 116, 128, 85},
  {56, 41, 15, 176, 236, 85, 37, 9, 62},
  {71, 30, 17, 119, 118, 255, 17, 18, 138},
  {101, 38, 60, 138, 55, 70, 43, 26, 142},
  {146, 36, 19, 30, 171, 255, 97, 27, 20},
  {138, 45, 61, 62, 219, 1, 81, 188, 64},
  {32, 41, 20, 117, 151, 142, 20, 21, 163},
  {112, 19, 12, 61, 195, 128, 48, 4, 24}}};
const uint8_t kDcTable[128] = {4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

constexpr int kNumParts = 8;
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// the intra modes, in libwebp's order
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

enum Status : int64_t { kOk = 0, kBitstream = -1, kNotEnoughData = -2, kUnsupported = -3 };

// libwebp's VP8BitReader (range kept minus one, as there), with its loads: 56
// bits at a time while 8 bytes are left, then a byte at a time; its 64-bit
// value can drop high bits on a damaged stream, and the port keeps that too
struct BoolDecoder {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    int bits = -8;
    uint32_t range = 254;
    bool eof = false;

    void init(const uint8_t* start, size_t size) {
        buf = start;
        end = start + size;
        value = 0;
        bits = -8;
        range = 254;
        eof = false;
        load();
    }
    void load() {
        if (end - buf >= 8) {  // VP8LoadNewBytes: 7 bytes, read big-endian
            uint64_t in = 0;
            for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
            buf += 7;
            value = in | (value << 56);
            bits += 56;
        } else if (buf < end) {  // VP8LoadFinalBytes
            bits += 8;
            value = static_cast<uint64_t>(*buf++) | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t v = static_cast<uint32_t>(value >> pos);
        int bit;
        if (v > split) {
            r -= split;
            value -= static_cast<uint64_t>(split + 1) << pos;
            bit = 1;
        } else {
            r = split + 1;
            bit = 0;
        }
        int shift = 0;
        while ((r << shift) < 128) ++shift;
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    // VP8GetSigned: +v or -v, a bit of probability 1/2 decided as libwebp
    // decides it (the sign of a 32-bit difference), which a damaged stream
    // whose value has outgrown its range can tell apart from get(0x80)
    int get_signed(int v) {
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = range >> 1;
        const uint32_t val = static_cast<uint32_t>(value >> pos);
        const int32_t mask = static_cast<int32_t>(split - val) >> 31;
        bits -= 1;
        range += static_cast<uint32_t>(mask);
        range |= 1;
        value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
        return (v ^ mask) - mask;
    }
    uint32_t value_bits(int n) {  // VP8GetValue: most significant bit first
        uint32_t v = 0;
        while (n-- > 0) v |= static_cast<uint32_t>(get(0x80)) << n;
        return v;
    }
    int signed_value(int n) {  // VP8GetSignedValue
        const int v = static_cast<int>(value_bits(n));
        return get(0x80) ? -v : v;
    }
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

struct FilterInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBInfo {  // the non-zero contexts of a macroblock column (top) or the left one
    uint8_t nz = 0, nz_dc = 0;
};

inline uint8_t clip8(int v) { return (v & ~0xff) == 0 ? static_cast<uint8_t>(v) : v < 0 ? 0 : 255; }
inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

// the IDCT as libwebp's C code computes it (the DC-only and AC3 cases)
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_dc(const int16_t* in, uint8_t* dst, int stride) {
    const int dc = in[0] + 4;
    for (int j = 0; j < 4; ++j)
        for (int i = 0; i < 4; ++i) dst[i + j * stride] = clip8(dst[i + j * stride] + (dc >> 3));
}

void transform_ac3(const int16_t* in, uint8_t* dst, int stride) {
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]);
    const int c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; ++y) {
        uint8_t* d = dst + y * stride;
        d[0] = clip8(d[0] + ((rows[y] + d1) >> 3));
        d[1] = clip8(d[1] + ((rows[y] + c1) >> 3));
        d[2] = clip8(d[2] + ((rows[y] - c1) >> 3));
        d[3] = clip8(d[3] + ((rows[y] - d1) >> 3));
    }
}

// The full IDCT as libwebp's SSE2 code computes it: 16-bit lanes that wrap,
// products taken as the high half of a signed 16 x 16-bit product with the
// constants 20091 and 35468 - 65536, a saturating add to the prediction.
inline int16_t w16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int16_t mulhi(int16_t a, int k) { return static_cast<int16_t>((a * k) >> 16); }
inline int16_t mul_k1(int16_t a) { return w16(mulhi(a, 20091) + a); }
inline int16_t mul_k2(int16_t a) { return w16(mulhi(a, -30068) + a); }

void transform_full(const int16_t* in, uint8_t* dst, int stride) {
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {  // vertical pass
        const int16_t a = w16(in[i] + in[8 + i]);
        const int16_t b = w16(in[i] - in[8 + i]);
        const int16_t c = w16(mul_k2(in[4 + i]) - mul_k1(in[12 + i]));
        const int16_t d = w16(mul_k1(in[4 + i]) + mul_k2(in[12 + i]));
        tmp[i * 4 + 0] = w16(a + d);
        tmp[i * 4 + 1] = w16(b + c);
        tmp[i * 4 + 2] = w16(b - c);
        tmp[i * 4 + 3] = w16(a - d);
    }
    for (int i = 0; i < 4; ++i) {  // horizontal pass, one output row each
        const int16_t dc = w16(tmp[i] + 4);
        const int16_t a = w16(dc + tmp[8 + i]);
        const int16_t b = w16(dc - tmp[8 + i]);
        const int16_t c = w16(mul_k2(tmp[4 + i]) - mul_k1(tmp[12 + i]));
        const int16_t d = w16(mul_k1(tmp[4 + i]) + mul_k2(tmp[12 + i]));
        const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
        uint8_t* row = dst + i * stride;
        for (int x = 0; x < 4; ++x) {
            int v = row[x] + (out[x] >> 3);
            v = v < -32768 ? -32768 : v > 32767 ? 32767 : v;
            row[x] = clip8(v);
        }
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = w16((a0 + a1) >> 3);
        out[16] = w16((a3 + a2) >> 3);
        out[32] = w16((a0 - a1) >> 3);
        out[48] = w16((a3 - a2) >> 3);
        out += 64;
    }
}

// ---------------------------------------------------------------- prediction
// `dst` points into a plane with its borders filled (see reconstruct)

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int stride, int size) {
    const uint8_t* top = dst - stride;
    for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x)
            dst[y * stride + x] = clip8(top[x] + dst[y * stride - 1] - top[-1]);
}

void predict4(int mode, uint8_t* dst, int s) {
    const uint8_t* top = dst - s;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[s - 1], K = dst[2 * s - 1], L = dst[3 * s - 1];
#define DST(x, y) dst[(x) + (y) * s]
    switch (mode) {
        case B_DC: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * s - 1];
            for (int y = 0; y < 4; ++y) std::memset(dst + y * s, dc >> 3, 4);
            break;
        }
        case B_TM: true_motion(dst, s, 4); break;
        case B_VE: {
            const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int y = 0; y < 4; ++y) std::memcpy(dst + y * s, v, 4);
            break;
        }
        case B_HE: {
            const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
            for (int y = 0; y < 4; ++y) std::memset(dst + y * s, v[y], 4);
            break;
        }
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
    }
#undef DST
}

// a 16 x 16 luma or 8 x 8 chroma prediction; DC at the image's top and left
// edges averages what it has (128 with neither)
void predict_block(int mode, uint8_t* dst, int s, int size, bool has_top, bool has_left) {
    const uint8_t* top = dst - s;
    switch (mode) {
        case B_DC: {
            const int shift = size == 16 ? 4 : 3;
            int dc;
            if (has_top && has_left) {
                dc = size;
                for (int i = 0; i < size; ++i) dc += top[i] + dst[i * s - 1];
                dc >>= shift + 1;
            } else if (has_left) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += dst[i * s - 1];
                dc >>= shift;
            } else if (has_top) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += top[i];
                dc >>= shift;
            } else {
                dc = 0x80;
            }
            for (int y = 0; y < size; ++y) std::memset(dst + y * s, dc, size);
            break;
        }
        case B_TM: true_motion(dst, s, size); break;
        case B_VE:
            for (int y = 0; y < size; ++y) std::memcpy(dst + y * s, top, size);
            break;
        default:  // B_HE
            for (int y = 0; y < size; ++y) std::memset(dst + y * s, dst[y * s - 1], size);
            break;
    }
}

// ---------------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline uint8_t uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }
inline int iabs(int v) { return v < 0 ? -v : v; }

inline void filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = uclip(p1 + a3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = uclip(p2 + a3);
    p[-2 * step] = uclip(p1 + a2);
    p[-step] = uclip(p0 + a1);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a2);
    p[2 * step] = uclip(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    return iabs(p[-2 * step] - p[-step]) > thresh || iabs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    return 4 * iabs(p[-step] - p[0]) + iabs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
    return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
           iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) filter2(p, hstride);
        else if (mb_edge) filter6(p, hstride);
        else filter4(p, hstride);
    }
}

// ---------------------------------------------------------------- decoder

struct Decoder {
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    BoolDecoder br;
    BoolDecoder parts[kNumParts];
    int num_parts_minus_one = 0;
    // segment header
    bool use_segment = false, update_map = false, absolute_delta = true;
    int quantizer[4] = {}, filter_strength[4] = {};
    uint8_t segment_probs[3] = {255, 255, 255};
    // filter header
    bool simple = false;
    int level = 0, sharpness = 0;
    bool use_lf_delta = false;
    int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
    int filter_type = 0;
    QuantMatrix dqm[4];
    uint8_t probas[4][8][3][11];
    bool use_skip_proba = false;
    int skip_p = 0;
    FilterInfo fstrengths[4][2];
    // the macroblock-aligned planes, left uninitialised (a damaged header's
    // size commits no memory before the rows are decoded)
    int ystride = 0, uvstride = 0;
    std::unique_ptr<uint8_t[]> ybuf, ubuf, vbuf;
    uint8_t* y0 = nullptr;
    uint8_t* u0 = nullptr;
    uint8_t* v0 = nullptr;

    Status headers(const uint8_t* data, size_t size);
    Status decode(uint8_t* rgba, int64_t stride);
    void parse_quant();
    void parse_proba();
    void filter_strengths();
};

Status Decoder::headers(const uint8_t* buf, size_t size) {
    if (size < 4) return kNotEnoughData;
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) return kBitstream;
    if (!show) return kUnsupported;
    buf += 3;
    size -= 3;
    if (!key_frame) return kUnsupported;
    if (size < 7) return kNotEnoughData;
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return kBitstream;
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) return kNotEnoughData;
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type
    // segment header
    use_segment = br.get(0x80);
    if (use_segment) {
        update_map = br.get(0x80);
        if (br.get(0x80)) {
            absolute_delta = br.get(0x80);
            for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
            for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s) segment_probs[s] = br.get(0x80) ? br.value_bits(8) : 255;
    }
    if (br.eof) return kBitstream;
    // filter header
    simple = br.get(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
        for (int i = 0; i < 4; ++i)
            if (br.get(0x80)) ref_lf_delta[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.get(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) return kBitstream;
    // token partitions
    num_parts_minus_one = (1 << br.value_bits(2)) - 1;
    const size_t last_part = num_parts_minus_one;
    if (size < 3 * last_part) return kNotEnoughData;
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > size_left) psize = size_left;
        parts[p].init(part_start, psize);
        part_start += psize;
        size_left -= psize;
        sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf + size) return kNotEnoughData;
    parse_quant();
    br.get(0x80);  // update_proba, ignored
    parse_proba();
    return kOk;
}

void Decoder::parse_quant() {
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
        int q;
        if (use_segment) {
            q = quantizer[i];
            if (!absolute_delta) q += base_q0;
        } else {
            if (i > 0) {
                dqm[i] = dqm[0];
                continue;
            }
            q = base_q0;
        }
        QuantMatrix& m = dqm[i];
        m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clip(q, 127)];
        m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x 155 / 100
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
}

void Decoder::parse_proba() {
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    probas[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                             ? br.value_bits(8)
                                             : kCoeffsProba0[t][b][c][p];
    use_skip_proba = br.get(0x80);
    if (use_skip_proba) skip_p = br.value_bits(8);
}

void Decoder::filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
        int base_level;
        if (use_segment) {
            base_level = filter_strength[s];
            if (!absolute_delta) base_level += level;
        } else {
            base_level = level;
        }
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
            FilterInfo& info = fstrengths[s][i4x4];
            int lvl = base_level;
            if (use_lf_delta) {
                lvl += ref_lf_delta[0];
                if (i4x4) lvl += mode_lf_delta[0];
            }
            lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
            if (lvl > 0) {
                int ilevel = lvl;
                if (sharpness > 0) {
                    ilevel >>= sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                info.ilevel = ilevel;
                info.limit = 2 * lvl + ilevel;
                info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
            } else {
                info.limit = 0;
            }
            info.inner = i4x4;
        }
    }
}

// GetCoeffs: the tokens of one 4 x 4 block from position `n`, dequantized
// into `out` (int16, wrapping); the position after the last non-zero one
int get_coeffs(BoolDecoder& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get(p[0])) return n;
        while (!br.get(p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
        int v;
        if (!br.get(p[2])) {
            v = 1;
            p = p_ctx[1];
        } else {
            if (!br.get(p[3])) {
                v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
            } else if (!br.get(p[6])) {
                if (!br.get(p[7])) {
                    v = 5 + br.get(159);
                } else {
                    v = 7 + 2 * br.get(165);
                    v += br.get(145);
                }
            } else {
                const int bit1 = br.get(p[8]);
                const int bit0 = br.get(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
                v += 3 + (8 << cat);
            }
            p = p_ctx[2];
        }
        out[kZigzag[n]] = w16(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
}

// DoTransform: the transform libwebp picks from a block's code
inline void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst, int stride) {
    switch (bits >> 30) {
        case 3: transform_full(src, dst, stride); break;
        case 2: transform_ac3(src, dst, stride); break;
        case 1: transform_dc(src, dst, stride); break;
        default: break;
    }
}

inline void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst, int stride) {
    if (!(bits & 0xff)) return;
    for (int k = 0; k < 4; ++k) {
        const int16_t* in = src + 16 * k;
        uint8_t* d = dst + (k >> 1) * 4 * stride + (k & 1) * 4;
        if (bits & 0xaa) transform_full(in, d, stride);
        else if (in[0]) transform_dc(in, d, stride);
    }
}

Status Decoder::decode(uint8_t* rgba, int64_t out_stride) {
    filter_strengths();
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    ybuf.reset(new uint8_t[static_cast<size_t>(ystride) * mb_h * 16]);
    ubuf.reset(new uint8_t[static_cast<size_t>(uvstride) * mb_h * 8]);
    vbuf.reset(new uint8_t[static_cast<size_t>(uvstride) * mb_h * 8]);
    y0 = ybuf.get();
    u0 = ubuf.get();
    v0 = vbuf.get();

    std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
    std::vector<MBInfo> top_nz(mb_w);
    std::vector<FilterInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    // the row's parsed modes
    struct Block {
        uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
        uint8_t imodes[16];
    };
    std::vector<Block> blocks(mb_w);
    // unfiltered reconstruction of the row above, for prediction
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    // a macroblock's work area: luma 16 x 16 at (1, 1) of a 21 x 17 grid,
    // chroma 8 x 8 at (1, 1) of 9 x 9 grids
    constexpr int BY = 21, BC = 9;
    uint8_t ywork[BY * 17], uwork[BC * 9], vwork[BC * 9];
    int16_t coeffs[384];

    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        // intra modes of the row, from the first partition
        uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            Block& b = blocks[mb_x];
            uint8_t* top = &intra_t[4 * mb_x];
            b.segment = !update_map ? 0
                        : !br.get(segment_probs[0]) ? br.get(segment_probs[1])
                                                     : br.get(segment_probs[2]) + 2;
            b.skip = use_skip_proba ? br.get(skip_p) : 0;
            b.is_i4x4 = !br.get(145);
            if (!b.is_i4x4) {
                const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                                              : (br.get(163) ? B_VE : B_DC);
                b.imodes[0] = static_cast<uint8_t>(ymode);
                std::memset(top, ymode, 4);
                std::memset(intra_l, ymode, 4);
            } else {
                uint8_t* modes = b.imodes;
                for (int y = 0; y < 4; ++y) {
                    int ymode = intra_l[y];
                    for (int x = 0; x < 4; ++x) {
                        const uint8_t* prob = kBModesProba[top[x]][ymode];
                        ymode = !br.get(prob[0]) ? B_DC
                                : !br.get(prob[1]) ? B_TM
                                : !br.get(prob[2]) ? B_VE
                                : !br.get(prob[3])
                                    ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                                    : (!br.get(prob[6]) ? B_LD
                                       : (!br.get(prob[7]) ? B_VL
                                          : (!br.get(prob[8]) ? B_HD : B_HU)));
                        top[x] = static_cast<uint8_t>(ymode);
                    }
                    std::memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[y] = static_cast<uint8_t>(ymode);
                }
            }
            b.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
        }
        if (br.eof) return kNotEnoughData;  // premature end of the first partition

        BoolDecoder& tbr = parts[mb_y & num_parts_minus_one];
        MBInfo left_nz;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            Block& b = blocks[mb_x];
            MBInfo& mb = top_nz[mb_x];
            uint32_t non_zero_y = 0, non_zero_uv = 0;
            int skip = use_skip_proba ? b.skip : 0;
            if (!skip) {
                // ParseResiduals
                const QuantMatrix& q = dqm[b.segment];
                int16_t* dst = coeffs;
                std::memset(coeffs, 0, sizeof(coeffs));
                int first;
                const uint8_t (*ac)[3][11];
                if (!b.is_i4x4) {
                    int16_t dc[16] = {};
                    const int ctx = mb.nz_dc + left_nz.nz_dc;
                    const int nz = get_coeffs(tbr, probas[1], ctx, q.y2, 0, dc);
                    mb.nz_dc = left_nz.nz_dc = nz > 0;
                    if (nz > 1) {
                        transform_wht(dc, dst);
                    } else {
                        const int dc0 = (dc[0] + 3) >> 3;
                        for (int i = 0; i < 256; i += 16) dst[i] = w16(dc0);
                    }
                    first = 1;
                    ac = probas[0];
                } else {
                    first = 0;
                    ac = probas[3];
                }
                uint32_t tnz = mb.nz & 0x0f, lnz = left_nz.nz & 0x0f;
                for (int y = 0; y < 4; ++y) {
                    int l = lnz & 1;
                    uint32_t nz_coeffs = 0;
                    for (int x = 0; x < 4; ++x) {
                        const int ctx = l + (tnz & 1);
                        const int nz = get_coeffs(tbr, ac, ctx, q.y1, first, dst);
                        l = nz > first;
                        tnz = (tnz >> 1) | (l << 7);
                        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                        dst += 16;
                    }
                    tnz >>= 4;
                    lnz = (lnz >> 1) | (l << 7);
                    non_zero_y = (non_zero_y << 8) | nz_coeffs;
                }
                uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
                for (int ch = 0; ch < 4; ch += 2) {
                    uint32_t nz_coeffs = 0;
                    tnz = mb.nz >> (4 + ch);
                    lnz = left_nz.nz >> (4 + ch);
                    for (int y = 0; y < 2; ++y) {
                        int l = lnz & 1;
                        for (int x = 0; x < 2; ++x) {
                            const int ctx = l + (tnz & 1);
                            const int nz = get_coeffs(tbr, probas[2], ctx, q.uv, 0, dst);
                            l = nz > 0;
                            tnz = (tnz >> 1) | (l << 3);
                            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                            dst += 16;
                        }
                        tnz >>= 2;
                        lnz = (lnz >> 1) | (l << 5);
                    }
                    non_zero_uv |= nz_coeffs << (4 * ch);
                    out_t_nz |= (tnz << 4) << ch;
                    out_l_nz |= (lnz & 0xf0) << ch;
                }
                mb.nz = static_cast<uint8_t>(out_t_nz);
                left_nz.nz = static_cast<uint8_t>(out_l_nz);
                skip = !(non_zero_y | non_zero_uv);
            } else {
                left_nz.nz = mb.nz = 0;
                if (!b.is_i4x4) left_nz.nz_dc = mb.nz_dc = 0;
            }
            if (filter_type > 0) {
                FilterInfo f = fstrengths[b.segment][b.is_i4x4];
                f.inner |= !skip;
                finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
            }
            if (tbr.eof) return kNotEnoughData;  // premature end of file

            // ReconstructRow, one macroblock: the work area's borders
            uint8_t* yd = ywork + BY + 1;
            uint8_t* ud = uwork + BC + 1;
            uint8_t* vd = vwork + BC + 1;
            if (mb_x == 0) {
                for (int j = 0; j < 16; ++j) yd[j * BY - 1] = 129;
                for (int j = 0; j < 8; ++j) ud[j * BC - 1] = vd[j * BC - 1] = 129;
                if (mb_y > 0) {
                    yd[-1 - BY] = ud[-1 - BC] = vd[-1 - BC] = 129;
                } else {
                    std::memset(yd - BY - 1, 127, 16 + 4 + 1);
                    std::memset(ud - BC - 1, 127, 8 + 1);
                    std::memset(vd - BC - 1, 127, 8 + 1);
                }
            } else {  // the left samples (and the corner) from the last macroblock
                for (int j = -1; j < 16; ++j) yd[j * BY - 1] = yd[j * BY + 15];
                for (int j = -1; j < 8; ++j) {
                    ud[j * BC - 1] = ud[j * BC + 7];
                    vd[j * BC - 1] = vd[j * BC + 7];
                }
            }
            if (mb_y > 0) {
                std::memcpy(yd - BY, &top_y[16 * mb_x], 16);
                std::memcpy(ud - BC, &top_u[8 * mb_x], 8);
                std::memcpy(vd - BC, &top_v[8 * mb_x], 8);
            }
            uint32_t bits = non_zero_y;
            if (use_skip_proba && b.skip) bits = 0;
            if (b.is_i4x4) {
                uint8_t* top_right = yd - BY + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1) std::memset(top_right, top_y[16 * mb_x + 15], 4);
                    else std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
                }
                for (int k = 1; k < 4; ++k) std::memcpy(top_right + 4 * k * BY, top_right, 4);
                for (int n = 0; n < 16; ++n, bits <<= 2) {
                    uint8_t* d = yd + (n >> 2) * 4 * BY + (n & 3) * 4;
                    predict4(b.imodes[n], d, BY);
                    do_transform(bits, coeffs + n * 16, d, BY);
                }
            } else {
                predict_block(b.imodes[0], yd, BY, 16, mb_y > 0, mb_x > 0);
                if (bits)
                    for (int n = 0; n < 16; ++n, bits <<= 2)
                        do_transform(bits, coeffs + n * 16, yd + (n >> 2) * 4 * BY + (n & 3) * 4, BY);
            }
            const uint32_t bits_uv = (use_skip_proba && b.skip) ? 0 : non_zero_uv;
            predict_block(b.uvmode, ud, BC, 8, mb_y > 0, mb_x > 0);
            predict_block(b.uvmode, vd, BC, 8, mb_y > 0, mb_x > 0);
            do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, ud, BC);
            do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, vd, BC);
            if (mb_y < mb_h - 1) {
                std::memcpy(&top_y[16 * mb_x], yd + 15 * BY, 16);
                std::memcpy(&top_u[8 * mb_x], ud + 7 * BC, 8);
                std::memcpy(&top_v[8 * mb_x], vd + 7 * BC, 8);
            }
            for (int j = 0; j < 16; ++j)
                std::memcpy(y0 + (mb_y * 16 + j) * ystride + mb_x * 16, yd + j * BY, 16);
            for (int j = 0; j < 8; ++j) {
                std::memcpy(u0 + (mb_y * 8 + j) * uvstride + mb_x * 8, ud + j * BC, 8);
                std::memcpy(v0 + (mb_y * 8 + j) * uvstride + mb_x * 8, vd + j * BC, 8);
            }
        }
    }

    // the loop filter, a macroblock at a time in raster order
    if (filter_type > 0) {
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
                const int limit = f.limit;
                if (limit == 0) continue;
                uint8_t* yd = y0 + mb_y * 16 * ystride + mb_x * 16;
                if (filter_type == 1) {
                    if (mb_x > 0) simple_edge(yd, 1, ystride, limit + 4);
                    if (f.inner)
                        for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, ystride, limit);
                    if (mb_y > 0) simple_edge(yd, ystride, 1, limit + 4);
                    if (f.inner)
                        for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k * ystride, ystride, 1, limit);
                } else {
                    uint8_t* ud = u0 + mb_y * 8 * uvstride + mb_x * 8;
                    uint8_t* vd = v0 + mb_y * 8 * uvstride + mb_x * 8;
                    const int il = f.ilevel, ht = f.hev_thresh;
                    if (mb_x > 0) {
                        normal_edge(yd, 1, ystride, 16, limit + 4, il, ht, true);
                        normal_edge(ud, 1, uvstride, 8, limit + 4, il, ht, true);
                        normal_edge(vd, 1, uvstride, 8, limit + 4, il, ht, true);
                    }
                    if (f.inner) {
                        for (int k = 1; k < 4; ++k) normal_edge(yd + 4 * k, 1, ystride, 16, limit, il, ht, false);
                        normal_edge(ud + 4, 1, uvstride, 8, limit, il, ht, false);
                        normal_edge(vd + 4, 1, uvstride, 8, limit, il, ht, false);
                    }
                    if (mb_y > 0) {
                        normal_edge(yd, ystride, 1, 16, limit + 4, il, ht, true);
                        normal_edge(ud, uvstride, 1, 8, limit + 4, il, ht, true);
                        normal_edge(vd, uvstride, 1, 8, limit + 4, il, ht, true);
                    }
                    if (f.inner) {
                        for (int k = 1; k < 4; ++k)
                            normal_edge(yd + 4 * k * ystride, ystride, 1, 16, limit, il, ht, false);
                        normal_edge(ud + 4 * uvstride, uvstride, 1, 8, limit, il, ht, false);
                        normal_edge(vd + 4 * uvstride, uvstride, 1, 8, limit, il, ht, false);
                    }
                }
            }
        }
    }

    // YUV -> RGBA with the fancy upsampler
    auto put = [](int y, int u, int v, uint8_t* d) {
        auto mh = [](int a, int k) { return (a * k) >> 8; };
        auto c8 = [](int a) { return (a & ~16383) == 0 ? a >> 6 : a < 0 ? 0 : 255; };
        d[0] = static_cast<uint8_t>(c8(mh(y, 19077) + mh(v, 26149) - 14234));
        d[1] = static_cast<uint8_t>(c8(mh(y, 19077) - mh(u, 6419) - mh(v, 13320) + 8708));
        d[2] = static_cast<uint8_t>(c8(mh(y, 19077) + mh(u, 33050) - 17685));
        d[3] = 255;
    };
    const int len = width;
    auto upsample = [&](const uint8_t* ty, const uint8_t* by, const uint8_t* tu, const uint8_t* tv,
                        const uint8_t* cu, const uint8_t* cv, uint8_t* td, uint8_t* bd) {
        auto load = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
        const int last_pair = (len - 1) >> 1;
        uint32_t tl_uv = load(tu[0], tv[0]), l_uv = load(cu[0], cv[0]);
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            put(ty[0], uv0 & 0xff, uv0 >> 16, td);
        }
        if (by) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            put(by[0], uv0 & 0xff, uv0 >> 16, bd);
        }
        for (int x = 1; x <= last_pair; ++x) {
            const uint32_t t_uv = load(tu[x], tv[x]), uv = load(cu[x], cv[x]);
            const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
            const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
            const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
            {
                const uint32_t uv0 = (diag_12 + tl_uv) >> 1, uv1 = (diag_03 + t_uv) >> 1;
                put(ty[2 * x - 1], uv0 & 0xff, uv0 >> 16, td + (2 * x - 1) * 4);
                put(ty[2 * x], uv1 & 0xff, uv1 >> 16, td + 2 * x * 4);
            }
            if (by) {
                const uint32_t uv0 = (diag_03 + l_uv) >> 1, uv1 = (diag_12 + uv) >> 1;
                put(by[2 * x - 1], uv0 & 0xff, uv0 >> 16, bd + (2 * x - 1) * 4);
                put(by[2 * x], uv1 & 0xff, uv1 >> 16, bd + 2 * x * 4);
            }
            tl_uv = t_uv;
            l_uv = uv;
        }
        if (!(len & 1)) {
            {
                const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
                put(ty[len - 1], uv0 & 0xff, uv0 >> 16, td + (len - 1) * 4);
            }
            if (by) {
                const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
                put(by[len - 1], uv0 & 0xff, uv0 >> 16, bd + (len - 1) * 4);
            }
        }
    };
    auto Y = [&](int r) { return y0 + static_cast<int64_t>(r) * ystride; };
    auto U = [&](int r) { return u0 + static_cast<int64_t>(r) * uvstride; };
    auto V = [&](int r) { return v0 + static_cast<int64_t>(r) * uvstride; };
    auto D = [&](int r) { return rgba + r * out_stride; };
    upsample(Y(0), nullptr, U(0), V(0), U(0), V(0), D(0), nullptr);
    for (int k = 1; 2 * k < height; ++k)
        upsample(Y(2 * k - 1), Y(2 * k), U(k - 1), V(k - 1), U(k), V(k), D(2 * k - 1), D(2 * k));
    if (!(height & 1) && height > 1) {
        const int k = height / 2 - 1;
        upsample(Y(height - 1), nullptr, U(k), V(k), U(k), V(k), D(height - 1), nullptr);
    }
    return kOk;
}

}  // namespace

// The width and height of a VP8 key frame (`data`, n bytes: the chunk
// payload), or a negative code: libwebp's VP8GetInfo.
extern "C" int64_t webp_vp8_info(const uint8_t* data, int64_t n, int64_t chunk_size) {
    if (n < 10) return kNotEnoughData;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBitstream;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const int w = ((data[7] << 8) | data[6]) & 0x3fff;
    const int h = ((data[9] << 8) | data[8]) & 0x3fff;
    if (bits & 1) return kBitstream;  // not a key frame
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= static_cast<uint64_t>(chunk_size))
        return kBitstream;
    if (w == 0 || h == 0) return kBitstream;
    return (static_cast<int64_t>(w) << 16) | h;
}

// Decode the VP8 data `data` (n bytes: the chunk payload and its pad byte,
// as libwebp is given them) of a w x h key frame into `rgba` (rows of
// `stride` bytes, alpha 255). Returns 0, or -1 a bitstream error, -2 the data
// ended early, -3 an unsupported frame.
extern "C" int64_t webp_vp8_decode(const uint8_t* data, int64_t n, int64_t w, int64_t h,
                                   uint8_t* rgba, int64_t stride) {
    if (n < 0 || w <= 0 || h <= 0) return kBitstream;
    std::unique_ptr<Decoder> dec(new Decoder());
    std::memcpy(dec->probas, kCoeffsProba0, sizeof(dec->probas));
    Status s = dec->headers(data, static_cast<size_t>(n));
    if (s != kOk) return s;
    if (dec->width != w || dec->height != h) return kBitstream;
    return dec->decode(rgba, stride);
}
