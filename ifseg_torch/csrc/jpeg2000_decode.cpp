// JPEG 2000 codestreams (ISO 15444-1) on the host, decoded as OpenJPEG 2.5
// decodes them through PIL's tile-by-tile reader (`ifseg_torch/data/jpeg2000.py`
// reads the JP2 boxes around a codestream and PIL's mode).
//
// Main and tile-part headers: SIZ, COD, COC, QCD, QCC, COM, TLM, PLM, PLT, CRG,
// SOT, SOD and EOC, with tiles, tile-parts and tile and image offsets; each
// COD/COC/QCD/QCC applied in the order read, a COD or QCD to every component
// (OpenJPEG's rule; the standard's precedence for headers in the usual order).
// Tier 2: tag trees, inclusion, zero bit-planes, pass counts, Lblock and
// code-word lengths (a new segment after 109 passes), empty packets, the five
// progression orders as OpenJPEG's packet iterator visits them, precincts and
// code-block sizes. Tier 1: the MQ decoder and EBCOT's three passes with the
// standard's contexts. Dequantization: none, scalar derived and scalar
// expounded, each coefficient reconstructed at the middle of its interval as
// OpenJPEG does (2|v| + 1 halves, also where quality layers leave a block's
// lower bit-planes out). The inverse 5/3 (integer) and 9/7 (float32, OpenJPEG's
// K and 2/K scalings) wavelets, the inverse RCT and ICT, the DC level shift
// with OpenJPEG's lrintf and the clamp.
//
// OpenJPEG's float operations are kept in their order and never contracted
// into fused multiply-adds (the pragma below), so the 9/7 path is equal to
// PIL's bit for bit.
//
// What PIL's encoder cannot write is refused (return -2 and a message naming
// it): code-block style flags, SOP and EPH markers, RGN, POC, PPM, PPT, HTJ2K
// (Rsiz bit 14, CAP, CPF, HT code-blocks), Part 2 (Rsiz bit 15, MCT, MCC,
// MCO, CBD), subsampled components, precisions above 16 bits, and a multiple
// component transform over components that differ in their wavelet.
//
// A codestream that is cut or broken decodes as PIL decodes it with
// LOAD_TRUNCATED_IMAGES: OpenJPEG's strict reader hands the tiles over one by
// one, and its first error ends the image (return 1 and the error; the tiles
// handed over stay). Every read of the input and every write of the output is
// bounds-checked. Built with the host C++ compiler at first use
// (`ifseg_torch/ops/build.py`) and called through ctypes.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Refused {
  std::string why;
};
struct Broken {
  std::string why;
};

[[noreturn]] void refuse(const std::string& why) { throw Refused{why}; }
[[noreturn]] void broken(const std::string& why) { throw Broken{why}; }

uint32_t rd16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }  // a >= 0, b > 0
int64_t ceildivpow2(int64_t a, int n) { return (a + (int64_t(1) << n) - 1) >> n; }
int64_t floordivpow2(int64_t a, int n) { return a >> n; }

// ---------------------------------------------------------------- parameters

constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;

// One component's coding parameters (COD/COC and QCD/QCC fields), as
// OpenJPEG keeps them: a marker writes them in the order it is read, a COD
// or QCD to every component, a COC or QCC to its own.
struct Tccp {
  int csty = 0, numres = 0, cbw = 0, cbh = 0, cblksty = 0, qmfbid = 0;
  int prcw[kMaxRes] = {}, prch[kMaxRes] = {};
  int qntsty = 0, numgbits = 0;
  int expn[kMaxBands] = {}, mant[kMaxBands] = {};
};

struct Tcp {
  int csty = 0, prog = 0, layers = 0, mct = 0;  // prog -1: unknown, no packets
  bool cod = false;
  std::vector<Tccp> tccps;
};

struct CompInfo {
  int prec = 8, sgnd = 0;
};

struct Image {
  uint32_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
  int ncomp;
  std::vector<CompInfo> comps;
  uint32_t tw, th;
};

void parse_siz(const uint8_t* p, uint32_t len, Image& im) {
  if (len < 36 || len % 3) broken("Error with SIZ marker size");
  uint32_t rsiz = rd16(p);
  im.x1 = rd32(p + 2);
  im.y1 = rd32(p + 6);
  im.x0 = rd32(p + 10);
  im.y0 = rd32(p + 14);
  im.tdx = rd32(p + 18);
  im.tdy = rd32(p + 22);
  im.tx0 = rd32(p + 26);
  im.ty0 = rd32(p + 30);
  uint32_t csiz = rd16(p + 34);
  if (csiz >= 16385) broken("SIZ: number of components is illegal");
  if (csiz != (len - 36) / 3) broken("SIZ: component count does not match the length");
  if (im.x0 >= im.x1 || im.y0 >= im.y1) broken("SIZ: negative or zero image size");
  if (im.tdx == 0 || im.tdy == 0) broken("SIZ: invalid tile size");
  uint64_t tx1 = uint64_t(im.tx0) + im.tdx, ty1 = uint64_t(im.ty0) + im.tdy;
  if (im.tx0 > im.x0 || im.ty0 > im.y0 || tx1 <= im.x0 || ty1 <= im.y0)
    broken("SIZ: illegal tile offset");
  im.ncomp = int(csiz);
  im.comps.resize(csiz);
  bool subsampled = false;
  for (uint32_t c = 0; c < csiz; ++c) {
    const uint8_t* q = p + 36 + 3 * c;
    im.comps[c].prec = (q[0] & 0x7f) + 1;
    im.comps[c].sgnd = q[0] >> 7;
    if (q[1] < 1 || q[2] < 1) broken("SIZ: invalid subsampling");
    if (im.comps[c].prec > 31) broken("SIZ: precision above 31 bits");
    subsampled |= q[1] != 1 || q[2] != 1;
  }
  im.tw = uint32_t(ceildiv(int64_t(im.x1) - im.tx0, im.tdx));
  im.th = uint32_t(ceildiv(int64_t(im.y1) - im.ty0, im.tdy));
  if (im.tw == 0 || im.th == 0 || im.tw > 65535 / im.th) broken("SIZ: invalid number of tiles");
  if (rsiz & 0x4000) refuse("HTJ2K (Part 15) codestreams");
  if (rsiz & 0x8000) refuse("Part 2 extensions");
  if (subsampled) refuse("subsampled components");
  for (const CompInfo& ci : im.comps)
    if (ci.prec > 16) refuse("precisions above 16 bits");
}

// SPcod / SPcoc (OpenJPEG's opj_j2k_read_SPCod_SPCoc) into `t`, whose csty is set.
void read_spcod(const uint8_t*& p, uint32_t& size, Tccp& t) {
  if (size < 5) broken("Error reading SPCod SPCoc element");
  t.numres = p[0] + 1;
  if (t.numres > kMaxRes) broken("invalid number of resolutions");
  t.cbw = p[1] + 2;
  t.cbh = p[2] + 2;
  if (t.cbw > 10 || t.cbh > 10 || t.cbw + t.cbh > 12) broken("invalid code-block size");
  t.cblksty = p[3];
  if (t.cblksty & 0x80) broken("mixed HT code-blocks");
  t.qmfbid = p[4];
  if (t.qmfbid > 1) broken("invalid wavelet");
  p += 5;
  size -= 5;
  if (t.csty & 1) {
    if (size < uint32_t(t.numres)) broken("Error reading SPCod SPCoc element");
    for (int r = 0; r < t.numres; ++r) {
      uint8_t b = p[r];
      if (r && ((b & 0xf) == 0 || (b >> 4) == 0)) broken("invalid precinct size");
      t.prcw[r] = b & 0xf;
      t.prch[r] = b >> 4;
    }
    p += t.numres;
    size -= uint32_t(t.numres);
  } else {
    for (int r = 0; r < t.numres; ++r) t.prcw[r] = t.prch[r] = 15;
  }
}

// SQcd / SQcc (opj_j2k_read_SQcd_SQcc) into `t`.
void read_sqcd(const uint8_t*& p, uint32_t& size, Tccp& t) {
  if (size < 1) broken("Error reading SQcd or SQcc element");
  t.qntsty = p[0] & 0x1f;
  t.numgbits = p[0] >> 5;
  ++p;
  --size;
  uint32_t nb = t.qntsty == 1 ? 1 : t.qntsty == 0 ? size : size / 2;
  if (t.qntsty == 0) {
    for (uint32_t b = 0; b < nb; ++b)
      if (b < uint32_t(kMaxBands)) {
        t.expn[b] = p[b] >> 3;
        t.mant[b] = 0;
      }
  } else {
    if (size < 2 * nb) broken("Error reading SQcd or SQcc element");
    for (uint32_t b = 0; b < nb; ++b)
      if (b < uint32_t(kMaxBands)) {
        uint32_t v = rd16(p + 2 * b);
        t.expn[b] = int(v >> 11);
        t.mant[b] = int(v & 0x7ff);
      }
    nb *= 2;
  }
  p += nb;
  size -= nb;
  if (t.qntsty == 1)
    for (int b = 1; b < kMaxBands; ++b) {
      t.expn[b] = t.expn[0] - (b - 1) / 3 > 0 ? t.expn[0] - (b - 1) / 3 : 0;
      t.mant[b] = t.mant[0];
    }
}

// A COD, COC, QCD or QCC segment (marker `m`, payload `p`) into `tcp`.
void read_coding_marker(uint32_t m, const uint8_t* p, uint32_t size, const Image& im, Tcp& tcp) {
  uint32_t room = im.ncomp <= 256 ? 1 : 2;
  if (m == 0xff52) {  // COD
    if (tcp.cod) broken("a second COD");
    tcp.cod = true;
    if (size < 5) broken("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~0x07) broken("unknown Scod value");
    tcp.prog = p[1] > 4 ? -1 : p[1];
    tcp.layers = int(rd16(p + 2));
    if (tcp.layers < 1) broken("invalid number of layers");
    tcp.mct = p[4];
    if (tcp.mct > 1) broken("invalid multiple component transformation");
    p += 5;
    size -= 5;
    for (Tccp& t : tcp.tccps) t.csty = tcp.csty & 1;
    read_spcod(p, size, tcp.tccps[0]);
    if (size) broken("Error reading COD marker");
    for (Tccp& t : tcp.tccps) {
      const Tccp& r = tcp.tccps[0];
      t.numres = r.numres;
      t.cbw = r.cbw;
      t.cbh = r.cbh;
      t.cblksty = r.cblksty;
      t.qmfbid = r.qmfbid;
      std::memcpy(t.prcw, r.prcw, sizeof t.prcw);
      std::memcpy(t.prch, r.prch, sizeof t.prch);
    }
  } else if (m == 0xff53) {  // COC
    if (size < room + 1) broken("Error reading COC marker");
    uint32_t c = room == 1 ? p[0] : rd16(p);
    if (c >= uint32_t(im.ncomp)) broken("COC: bad component");
    tcp.tccps[c].csty = p[room];
    p += room + 1;
    size -= room + 1;
    read_spcod(p, size, tcp.tccps[c]);
    if (size) broken("Error reading COC marker");
  } else if (m == 0xff5c) {  // QCD
    read_sqcd(p, size, tcp.tccps[0]);
    if (size) broken("Error reading QCD marker");
    for (Tccp& t : tcp.tccps) {
      const Tccp& r = tcp.tccps[0];
      t.qntsty = r.qntsty;
      t.numgbits = r.numgbits;
      std::memcpy(t.expn, r.expn, sizeof t.expn);
      std::memcpy(t.mant, r.mant, sizeof t.mant);
    }
  } else {  // QCC
    if (size < room) broken("Error reading QCC marker");
    uint32_t c = room == 1 ? p[0] : rd16(p);
    if (c >= uint32_t(im.ncomp)) broken("QCC: bad component");
    p += room;
    size -= room;
    read_sqcd(p, size, tcp.tccps[c]);
    if (size) broken("Error reading QCC marker");
  }
}

// The marker segments OpenJPEG knows and the states it reads them in.
enum : int { ST_MHSIZ = 1, ST_MH = 2, ST_TPHSOT = 4, ST_TPH = 8, ST_NEOC = 16, ST_EOC = 32 };
constexpr int kUnknown = -1;

int marker_states(uint32_t m) {
  switch (m) {
    case 0xff90: return ST_MH | ST_TPHSOT;                          // SOT
    case 0xff52: case 0xff53: case 0xff5e: case 0xff5c: case 0xff5d:
    case 0xff5f: case 0xff64: case 0xff74: case 0xff75: case 0xff77:
      return ST_MH | ST_TPH;                                          // COD COC RGN QCD QCC POC COM MCT MCC MCO
    case 0xff51: return ST_MHSIZ;                                     // SIZ
    case 0xff55: case 0xff57: case 0xff60: case 0xff63: case 0xff78:
    case 0xff50: case 0xff59:
      return ST_MH;                                                   // TLM PLM PPM CRG CBD CAP CPF
    case 0xff58: case 0xff61: return ST_TPH;                          // PLT PPT
    case 0xff91: return 0;                                            // SOP
    default: return kUnknown;
  }
}

// ----------------------------------------------------------------- tier 2

struct Bio {  // OpenJPEG's packet-header bit reader: zeros past the end
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh;
    int cw = w, ch = h;
    for (;;) {
      lw.push_back(cw);
      lh.push_back(ch);
      if (cw * ch == 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    int total = 0;
    for (size_t l = 0; l < lw.size(); ++l) total += lw[l] * lh[l];
    nodes.assign(total, Node{-1, 999, 0});
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      int next = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          nodes[base + j * lw[l] + i].parent = next + (j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
  }
  bool decode(Bio& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[n++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low;
      else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low;
        else ++low;
      }
      nd.low = low;
      if (n == 0) break;
      node = stk[--n];
    }
    return nodes[node].value < threshold;
  }
};

// A code-word segment: OpenJPEG starts a new one after 109 passes.
constexpr int kMaxPassesPerSeg = 109;
struct Seg {
  uint32_t len = 0, newlen = 0;
  int numpasses = 0, newpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, newpasses = 0, numsegs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;  // the segments' bytes, one after another
  void init_seg(size_t i) {
    if (segs.size() <= i) segs.resize(i + 1);
    segs[i] = Seg();
  }
};

struct PrecBand {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int64_t x0, y0, x1, y1;
  int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
  int numbps;
  float stepsize;
  std::vector<PrecBand> precs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph, nbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  Tccp cod;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

void build_tilecomp(TileComp& tc, const CompInfo& ci) {
  const Tccp& cod = tc.cod;
  int nres = cod.numres;
  int64_t cblks = 0;
  tc.res.resize(nres);
  for (int r = 0; r < nres; ++r) {
    Res& res = tc.res[r];
    int level = nres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, level);
    res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level);
    res.y1 = ceildivpow2(tc.y1, level);
    res.pdx = cod.prcw[r];
    res.pdy = cod.prch[r];
    int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> res.pdx);
    res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> res.pdy);
    if (int64_t(res.pw) * res.ph > (int64_t(1) << 20)) broken("too many precincts");
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceildivpow2(px0, 1);
      cbgy0 = ceildivpow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    int cbw = cod.cbw < cbgw ? cod.cbw : cbgw;
    int cbh = cod.cbh < cbgh ? cod.cbh : cbgh;
    res.nbands = r == 0 ? 1 : 3;
    for (int b = 0; b < res.nbands; ++b) {
      Band& band = res.bands[b];
      band.bandno = r == 0 ? 0 : b + 1;
      if (r == 0) {
        band.x0 = ceildivpow2(tc.x0, level);
        band.y0 = ceildivpow2(tc.y0, level);
        band.x1 = ceildivpow2(tc.x1, level);
        band.y1 = ceildivpow2(tc.y1, level);
      } else {
        int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (xob << level), level + 1);
        band.y0 = ceildivpow2(tc.y0 - (yob << level), level + 1);
        band.x1 = ceildivpow2(tc.x1 - (xob << level), level + 1);
        band.y1 = ceildivpow2(tc.y1 - (yob << level), level + 1);
      }
      int qi = r == 0 ? 0 : 3 * (r - 1) + b + 1;
      int expn = cod.expn[qi], mant = cod.mant[qi];
      int rb = ci.prec + (cod.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1));
      band.stepsize = float((1.0 + mant / 2048.0) * std::pow(2.0, rb - expn));
      band.numbps = expn + cod.numgbits - 1;
      band.precs.assign(size_t(res.pw) * res.ph, PrecBand());
      if (band.empty()) continue;
      for (int p = 0; p < res.pw * res.ph; ++p) {
        PrecBand& pb = band.precs[p];
        int64_t gx0 = cbgx0 + int64_t(p % res.pw) * (int64_t(1) << cbgw);
        int64_t gy0 = cbgy0 + int64_t(p / res.pw) * (int64_t(1) << cbgh);
        int64_t gx1 = gx0 + (int64_t(1) << cbgw), gy1 = gy0 + (int64_t(1) << cbgh);
        int64_t prx0 = gx0 > band.x0 ? gx0 : band.x0, pry0 = gy0 > band.y0 ? gy0 : band.y0;
        int64_t prx1 = gx1 < band.x1 ? gx1 : band.x1, pry1 = gy1 < band.y1 ? gy1 : band.y1;
        int64_t cx0 = floordivpow2(prx0, cbw) << cbw, cy0 = floordivpow2(pry0, cbh) << cbh;
        int64_t cx1 = ceildivpow2(prx1, cbw) << cbw, cy1 = ceildivpow2(pry1, cbh) << cbh;
        pb.cw = cx1 > cx0 ? int((cx1 - cx0) >> cbw) : 0;
        pb.ch = cy1 > cy0 ? int((cy1 - cy0) >> cbh) : 0;
        if (prx1 <= prx0 || pry1 <= pry0) pb.cw = pb.ch = 0;
        cblks += int64_t(pb.cw) * pb.ch;
        if (cblks > (int64_t(1) << 22)) broken("too many code-blocks in a tile-component");
        pb.cblks.resize(size_t(pb.cw) * pb.ch);
        for (int k = 0; k < pb.cw * pb.ch; ++k) {
          Cblk& cb = pb.cblks[k];
          int64_t bx0 = cx0 + int64_t(k % pb.cw) * (int64_t(1) << cbw);
          int64_t by0 = cy0 + int64_t(k / pb.cw) * (int64_t(1) << cbh);
          cb.x0 = int(bx0 > prx0 ? bx0 : prx0);
          cb.y0 = int(by0 > pry0 ? by0 : pry0);
          int64_t bx1 = bx0 + (int64_t(1) << cbw), by1 = by0 + (int64_t(1) << cbh);
          cb.x1 = int(bx1 < prx1 ? bx1 : prx1);
          cb.y1 = int(by1 < pry1 ? by1 : pry1);
        }
        pb.incl.init(pb.cw, pb.ch);
        pb.imsb.init(pb.cw, pb.ch);
      }
    }
  }
}

uint32_t num_passes(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t floorlog2(uint32_t v) {
  uint32_t l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// One packet from `data[*pos, len)`; Broken where OpenJPEG's strict mode stops.
void read_packet(TileComp& tc, int r, int prec, int layer, const uint8_t* data, size_t len,
                 size_t* pos) {
  Res& res = tc.res[r];
  Bio bio(data + *pos, len - *pos);
  if (!bio.bit()) {  // an empty packet
    bio.inalign();
    *pos += bio.numbytes();
    return;
  }
  for (int b = 0; b < res.nbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    PrecBand& pb = band.precs[prec];
    for (int k = 0; k < pb.cw * pb.ch; ++k) {
      Cblk& cb = pb.cblks[k];
      bool included = cb.numsegs ? bio.bit() : pb.incl.decode(bio, k, layer + 1);
      if (!included) {
        cb.newpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!pb.imsb.decode(bio, k, i)) ++i;
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      cb.newpasses = int(num_passes(bio));
      int inc = 0;
      while (bio.bit()) ++inc;
      cb.numlenbits += inc;
      size_t segno = 0;
      if (!cb.numsegs) {
        cb.init_seg(0);
      } else {
        segno = size_t(cb.numsegs - 1);
        if (cb.segs[segno].numpasses == kMaxPassesPerSeg) cb.init_seg(++segno);
      }
      int n = cb.newpasses;
      for (;;) {
        Seg& sg = cb.segs[segno];
        sg.newpasses = std::min(kMaxPassesPerSeg - sg.numpasses, n);
        uint32_t bits = uint32_t(cb.numlenbits) + floorlog2(uint32_t(sg.newpasses));
        if (bits > 32) broken("code-word length of more than 32 bits");
        sg.newlen = bio.read(int(bits));
        n -= sg.newpasses;
        if (n <= 0) break;
        cb.init_seg(++segno);
      }
    }
  }
  bio.inalign();
  size_t at = *pos + bio.numbytes();
  for (int b = 0; b < res.nbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    for (Cblk& cb : band.precs[prec].cblks) {
      if (!cb.newpasses) continue;
      size_t segno;
      if (!cb.numsegs) {
        segno = 0;
        cb.numsegs = 1;
      } else {
        segno = size_t(cb.numsegs - 1);
        if (cb.segs[segno].numpasses == kMaxPassesPerSeg) {
          ++segno;
          ++cb.numsegs;
        }
      }
      for (;;) {
        Seg& sg = cb.segs[segno];
        if (at > len || sg.newlen > len - at) broken("a code-block's data runs past the tile's data");
        cb.data.insert(cb.data.end(), data + at, data + at + sg.newlen);
        at += sg.newlen;
        sg.numpasses += sg.newpasses;
        cb.newpasses -= sg.newpasses;
        sg.len += sg.newlen;
        if (cb.newpasses <= 0) break;
        ++segno;
        ++cb.numsegs;
      }
      cb.newpasses = 0;
    }
  }
  *pos = at;
}

// Each packet of a tile in OpenJPEG's order: visit(layer, res, comp, precinct).
template <typename Visit>
void packet_order(const std::vector<TileComp>& tcs, int prog, int layers, int64_t tx0, int64_t ty0,
                  int64_t tx1, int64_t ty1, Visit visit_packet) {
  int nc = int(tcs.size());
  int maxres = 0;
  int64_t maxprec = 0;
  for (const TileComp& tc : tcs) {
    if (int(tc.res.size()) > maxres) maxres = int(tc.res.size());
    for (const Res& r : tc.res)
      if (int64_t(r.pw) * r.ph > maxprec) maxprec = int64_t(r.pw) * r.ph;
  }
  if (prog == 0 || prog == 1) {  // LRCP, RLCP
    if (prog == 0) {
      for (int l = 0; l < layers; ++l)
        for (int r = 0; r < maxres; ++r)
          for (int c = 0; c < nc; ++c) {
            if (r >= int(tcs[c].res.size())) continue;
            const Res& res = tcs[c].res[r];
            for (int p = 0; p < res.pw * res.ph; ++p) visit_packet(l, r, c, p);
          }
    } else {
      for (int r = 0; r < maxres; ++r)
        for (int l = 0; l < layers; ++l)
          for (int c = 0; c < nc; ++c) {
            if (r >= int(tcs[c].res.size())) continue;
            const Res& res = tcs[c].res[r];
            for (int p = 0; p < res.pw * res.ph; ++p) visit_packet(l, r, c, p);
          }
    }
    return;
  }
  // RPCL, PCRL, CPRL: positions on the reference grid, as OpenJPEG's
  // iterator, which hands each packet over once
  uint64_t packets = uint64_t(layers) * maxres * nc * (maxprec ? maxprec : 1);
  if (packets > (uint64_t(1) << 31)) broken("too many packets in a tile");
  std::vector<bool> seen(packets, false);
  auto visit = [&](int r, int c, int64_t x, int64_t y) {
    const TileComp& tc = tcs[c];
    if (r >= int(tc.res.size())) return;
    const Res& res = tc.res[r];
    int level = int(tc.res.size()) - 1 - r;
    int64_t trx0 = ceildiv(tx0, int64_t(1) << level), try0 = ceildiv(ty0, int64_t(1) << level);
    int64_t trx1 = ceildiv(tx1, int64_t(1) << level), try1 = ceildiv(ty1, int64_t(1) << level);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 62 || rpy >= 62) return;
    if (!((y % (int64_t(1) << rpy) == 0) ||
          (y == ty0 && ((try0 << level) % (int64_t(1) << rpy)))))
      return;
    if (!((x % (int64_t(1) << rpx) == 0) ||
          (x == tx0 && ((trx0 << level) % (int64_t(1) << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    int64_t prci = floordivpow2(ceildiv(x, int64_t(1) << level), res.pdx) - floordivpow2(trx0, res.pdx);
    int64_t prcj = floordivpow2(ceildiv(y, int64_t(1) << level), res.pdy) - floordivpow2(try0, res.pdy);
    int64_t p = prci + prcj * res.pw;
    if (p < 0 || p >= int64_t(res.pw) * res.ph) return;
    for (int l = 0; l < layers; ++l) {
      size_t idx = ((size_t(l) * maxres + r) * nc + c) * size_t(maxprec) + size_t(p);
      if (!seen[idx]) {
        seen[idx] = true;
        visit_packet(l, r, c, int(p));
      }
    }
  };
  auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      int nres = int(tcs[c].res.size());
      for (int r = 0; r < nres; ++r) {
        int e = tcs[c].res[r].pdx + nres - 1 - r, f = tcs[c].res[r].pdy + nres - 1 - r;
        if (e < 32) dx = dx ? std::min<int64_t>(dx, int64_t(1) << e) : int64_t(1) << e;
        if (f < 32) dy = dy ? std::min<int64_t>(dy, int64_t(1) << f) : int64_t(1) << f;
      }
    }
  };
  int64_t dx, dy;
  if (prog == 2) {  // RPCL
    steps(0, nc, dx, dy);
    if (!dx || !dy) return;
    for (int r = 0; r < maxres; ++r)
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
        for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
          for (int c = 0; c < nc; ++c) visit(r, c, x, y);
  } else if (prog == 3) {  // PCRL
    steps(0, nc, dx, dy);
    if (!dx || !dy) return;
    for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
      for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
        for (int c = 0; c < nc; ++c)
          for (int r = 0; r < int(tcs[c].res.size()); ++r) visit(r, c, x, y);
  } else {  // CPRL
    for (int c = 0; c < nc; ++c) {
      steps(c, c + 1, dx, dy);
      if (!dx || !dy) return;
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
        for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
          for (int r = 0; r < int(tcs[c].res.size()); ++r) visit(r, c, x, y);
    }
  }
}

// ----------------------------------------------------------------- tier 1

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0ac1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0},
    {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

struct Mq {  // OpenJPEG's MQ decoder over data followed by an artificial 0xFF 0xFF
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t idx[19], mps[19];
  void bytein() {
    uint32_t next = bp[1];
    if (bp[0] == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void reset() {
    for (int i = 0; i < 19; ++i) idx[i] = mps[i] = 0;
    idx[18] = 46;  // uniform
    idx[17] = 3;   // run length
    idx[0] = 4;    // zero coding, no significant neighbour
  }
  void init(const uint8_t* p, size_t len) {
    bp = p;
    c = len == 0 ? 0xffu << 16 : uint32_t(p[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[idx[cx]];
    uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        idx[cx] = s.nmps;
      } else {
        d = mps[cx] ^ 1;
        if (s.sw) mps[cx] ^= 1;
        idx[cx] = s.nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = mps[cx] ^ 1;
          if (s.sw) mps[cx] ^= 1;
          idx[cx] = s.nlps;
        } else {
          d = mps[cx];
          idx[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// flag bits of a sample: its neighbours' significance, their signs, its own state
enum : uint32_t {
  F_NW = 1u << 0, F_N = 1u << 1, F_NE = 1u << 2, F_W = 1u << 3, F_E = 1u << 4,
  F_SW = 1u << 5, F_S = 1u << 6, F_SE = 1u << 7,
  F_NNEG = 1u << 8, F_SNEG = 1u << 9, F_WNEG = 1u << 10, F_ENEG = 1u << 11,
  F_SIG = 1u << 12, F_VISIT = 1u << 13, F_REFINED = 1u << 14,
  F_NBR = 0xff,
};

uint8_t kZc[4][256];  // zero-coding context by orientation and neighbours
uint8_t kSc[256];     // sign context (low 4 bits) and xor bit (bit 4) by N, S, W, E
bool kTablesReady = false;

void init_tables() {
  if (kTablesReady) return;
  for (int o = 0; o < 4; ++o)
    for (int f = 0; f < 256; ++f) {
      int h = !!(f & F_W) + !!(f & F_E);
      int v = !!(f & F_N) + !!(f & F_S);
      int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
      int n;
      if (o == 3) {
        int hv = h + v;
        if (d >= 3) n = 8;
        else if (d == 2) n = hv >= 1 ? 7 : 6;
        else if (d == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        else n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
      } else {
        if (o == 1) std::swap(h, v);  // HL: horizontally high-pass
        if (h == 2) n = 8;
        else if (h == 1) n = v >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (v == 2) n = 4;
        else if (v == 1) n = 3;
        else n = d >= 2 ? 2 : d == 1 ? 1 : 0;
      }
      kZc[o][f] = uint8_t(n);
    }
  for (int f = 0; f < 256; ++f) {
    // bits 0-3: N, S, W, E significant; bits 4-7: N, S, W, E negative
    auto contrib = [&](int sig, int neg) { return (f >> sig & 1) ? ((f >> neg & 1) ? -1 : 1) : 0; };
    int hc = contrib(2, 6) + contrib(3, 7), vc = contrib(0, 4) + contrib(1, 5);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    int ctx, x = 0;
    if (hc == 0) {
      ctx = vc == 0 ? 9 : 10;
      x = vc < 0;
    } else if (hc > 0) {
      ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
    } else {
      ctx = vc == 1 ? 11 : vc == 0 ? 12 : 13;
      x = 1;
    }
    kSc[f] = uint8_t((ctx - 9) | (x << 4));
  }
  kTablesReady = true;
}

struct T1 {
  int w, h, stride;
  std::vector<uint32_t> flags;  // (h + 2) x (w + 2)
  std::vector<int32_t> data;    // h x w
  std::vector<uint8_t> seg;     // one segment's bytes and its 0xFF 0xFF
  const uint8_t* zc;
  Mq mq;

  uint32_t& fl(int x, int y) { return flags[size_t(y + 1) * stride + x + 1]; }

  void set_sig(int x, int y, int neg) {
    uint32_t* f = &fl(x, y);
    *f |= F_SIG;
    uint32_t* up = f - stride;
    uint32_t* dn = f + stride;
    up[-1] |= F_SE;
    up[0] |= F_S | (neg ? uint32_t(F_SNEG) : 0u);
    up[1] |= F_SW;
    f[-1] |= F_E | (neg ? uint32_t(F_ENEG) : 0u);
    f[1] |= F_W | (neg ? uint32_t(F_WNEG) : 0u);
    dn[-1] |= F_NE;
    dn[0] |= F_N | (neg ? uint32_t(F_NNEG) : 0u);
    dn[1] |= F_NW;
  }

  void decode_sign(int x, int y, int32_t mag) {
    uint32_t f = fl(x, y);
    // N, S, W, E significant, then N, S, W, E negative (bits 8 to 11)
    uint32_t idx = ((f >> 1) & 1) | ((f >> 5) & 2) | ((f >> 1) & 4) | ((f >> 1) & 8) |
                   ((f >> 4) & 0xf0);
    uint8_t sc = kSc[idx];
    int neg = mq.decode(9 + (sc & 15)) ^ (sc >> 4);
    data[size_t(y) * w + x] = neg ? -mag : mag;
    set_sig(x, y, neg);
  }

  void sigpass(int bpno) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) == 0 && (f & F_NBR)) {
            if (mq.decode(zc[f & F_NBR])) decode_sign(x, y, oneplushalf);
            f |= F_VISIT;
          }
        }
  }

  void refpass(int bpno) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) == F_SIG) {
            int ctx = (f & F_REFINED) ? 16 : (f & F_NBR) ? 15 : 14;
            int v = mq.decode(ctx);
            int32_t& d = data[size_t(y) * w + x];
            d += (v ^ (d < 0)) ? poshalf : -poshalf;
            f |= F_REFINED;
          }
        }
  }

  void clnpass(int bpno) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        if (y0 + 4 <= h) {
          bool run = true;
          for (int k = 0; k < 4; ++k)
            if (fl(x, y0 + k) & (F_SIG | F_VISIT | F_NBR)) run = false;
          if (run) {
            if (!mq.decode(17)) continue;
            int r = mq.decode(18);
            r = (r << 1) | mq.decode(18);
            y = y0 + r;
            decode_sign(x, y, oneplushalf);
            ++y;
          }
        }
        for (; y < y0 + 4 && y < h; ++y) {
          uint32_t f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) == 0 && mq.decode(zc[f & F_NBR]))
            decode_sign(x, y, oneplushalf);
        }
      }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) fl(x, y) &= ~F_VISIT;
  }

  // Decode a code-block into `data` (2|v| + 1 halves, OpenJPEG's scale);
  // each segment ends in an artificial 0xFF 0xFF, the contexts carry over.
  void decode(const Cblk& cb, int orient) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    stride = w + 2;
    flags.assign(size_t(h + 2) * stride, 0);
    data.assign(size_t(w) * h, 0);
    zc = kZc[orient];
    int bpno = cb.numbps;
    if (bpno >= 31) broken("a code-block of 31 or more bit-planes");
    mq.reset();
    int passtype = 2;
    size_t start = 0;
    for (int s = 0; s < cb.numsegs; ++s) {
      const Seg& sg = cb.segs[s];
      seg.assign(cb.data.begin() + long(start), cb.data.begin() + long(start + sg.len));
      start += sg.len;
      seg.push_back(0xff);
      seg.push_back(0xff);
      mq.init(seg.data(), sg.len);
      for (int p = 0; p < sg.numpasses && bpno >= 1; ++p) {
        if (passtype == 0) sigpass(bpno);
        else if (passtype == 1) refpass(bpno);
        else clnpass(bpno);
        if (++passtype == 3) {
          passtype = 0;
          --bpno;
        }
      }
    }
  }
};

// ------------------------------------------------------------- wavelets
//
// A line of n samples holds its sn low-pass samples, then its high-pass ones;
// cas is the parity of its first coordinate (1: it starts with a high-pass
// sample). The inverse interleaves them and lifts, each sample from its two
// neighbours, mirrored at the ends (x[-1] = x[1], x[n] = x[n - 2]). A
// horizontal line is a row's samples; a vertical one is a run of whole rows,
// lifted row by row (the same operations on every column, in the same order).

inline int low_count(int n, int cas) { return cas ? n / 2 : (n + 1) / 2; }
inline int mirror(int i, int n) { return i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i; }

// 5/3: X(low) -= (left + right + 2) >> 2, then X(high) += (left + right) >> 1;
// a single sample at an odd coordinate is halved (C division, as OpenJPEG).
// Interleave a line's low and high samples into t.
template <typename T>
void interleave(const T* x, T* t, int n, int cas, T low_scale, T high_scale) {
  int sn = low_count(n, cas);
  for (int k = 0; k < sn; ++k) t[cas + 2 * k] = x[k] * low_scale;
  for (int k = 0; 1 - cas + 2 * k < n; ++k) t[1 - cas + 2 * k] = x[sn + k] * high_scale;
}

// Apply f(i, left, right) at i = first, first + 2, ... < n, the neighbours
// mirrored at the ends.
template <typename F>
inline void lift_line(int n, int first, F f) {
  int i = first;
  if (i == 0) {
    f(0, 1, 1);
    i = 2;
  }
  for (; i + 1 < n; i += 2) f(i, i - 1, i + 1);
  if (i < n) f(i, i - 1, i - 1);
}

void idwt53_line(int32_t* x, int n, int cas, std::vector<int32_t>& tmp) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  tmp.resize(n);
  int32_t* t = tmp.data();
  interleave<int32_t>(x, t, n, cas, 1, 1);
  lift_line(n, cas, [t](int i, int a, int b) { t[i] -= (t[a] + t[b] + 2) >> 2; });
  lift_line(n, 1 - cas, [t](int i, int a, int b) { t[i] += (t[a] + t[b]) >> 1; });
  std::memcpy(x, t, sizeof(int32_t) * n);
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f;

// 9/7 in float32 as OpenJPEG's opj_v8dwt_decode: low samples times K, high
// ones times 2/K, then x = x + ((left + right) * c) for c = -delta, -gamma,
// -beta, -alpha on the low, high, low and high samples. A single sample is
// left as it is, whatever its parity.
void idwt97_line(float* x, int n, int cas, std::vector<float>& tmp) {
  if (n == 1) return;
  tmp.resize(n);
  float* t = tmp.data();
  interleave<float>(x, t, n, cas, kK, kTwoInvK);
  const float steps[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
  for (int k = 0; k < 4; ++k) {
    float c = steps[k];
    lift_line(n, (k & 1) ? 1 - cas : cas,
              [t, c](int i, int a, int b) { t[i] = t[i] + ((t[a] + t[b]) * c); });
  }
  std::memcpy(x, t, sizeof(float) * n);
}

// The vertical lines of a resolution (rw columns of rh rows, `w` apart), row
// by row: interleaved into `tmp`, lifted, copied back.
void idwt53_columns(int32_t* buf, int64_t w, int rw, int rh, int cas, std::vector<int32_t>& tmp) {
  if (rh == 1) {
    if (cas)
      for (int x = 0; x < rw; ++x) buf[x] /= 2;
    return;
  }
  int sn = low_count(rh, cas);
  tmp.resize(size_t(rh) * rw);
  for (int i = 0; i < rh; ++i)
    std::memcpy(&tmp[size_t(i) * rw], buf + size_t((i & 1) == cas ? i / 2 : sn + i / 2) * w,
                sizeof(int32_t) * rw);
  auto row = [&](int i) { return &tmp[size_t(mirror(i, rh)) * rw]; };
  for (int i = cas; i < rh; i += 2) {
    int32_t *t = row(i), *a = row(i - 1), *b = row(i + 1);
    for (int x = 0; x < rw; ++x) t[x] -= (a[x] + b[x] + 2) >> 2;
  }
  for (int i = 1 - cas; i < rh; i += 2) {
    int32_t *t = row(i), *a = row(i - 1), *b = row(i + 1);
    for (int x = 0; x < rw; ++x) t[x] += (a[x] + b[x]) >> 1;
  }
  for (int i = 0; i < rh; ++i)
    std::memcpy(buf + size_t(i) * w, &tmp[size_t(i) * rw], sizeof(int32_t) * rw);
}

void idwt97_columns(float* buf, int64_t w, int rw, int rh, int cas, std::vector<float>& tmp) {
  if (rh == 1) return;
  int sn = low_count(rh, cas);
  tmp.resize(size_t(rh) * rw);
  for (int i = 0; i < rh; ++i) {
    bool low = (i & 1) == cas;
    const float* src = buf + size_t(low ? i / 2 : sn + i / 2) * w;
    float* dst = &tmp[size_t(i) * rw];
    float scale = low ? kK : kTwoInvK;
    for (int x = 0; x < rw; ++x) dst[x] = src[x] * scale;
  }
  auto row = [&](int i) { return &tmp[size_t(mirror(i, rh)) * rw]; };
  const float steps[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
  for (int k = 0; k < 4; ++k) {
    float c = steps[k];
    for (int i = (k & 1) ? 1 - cas : cas; i < rh; i += 2) {
      float *t = row(i), *a = row(i - 1), *b = row(i + 1);
      for (int x = 0; x < rw; ++x) t[x] = t[x] + ((a[x] + b[x]) * c);
    }
  }
  for (int i = 0; i < rh; ++i)
    std::memcpy(buf + size_t(i) * w, &tmp[size_t(i) * rw], sizeof(float) * rw);
}

// OpenJPEG's order at each resolution: the rows, then the columns.
template <typename T, typename Line, typename Columns>
void idwt2d(TileComp& tc, std::vector<T>& buf, Line line, Columns columns) {
  int64_t w = tc.x1 - tc.x0;
  std::vector<T> tmp;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Res& res = tc.res[r];
    int rw = int(res.x1 - res.x0), rh = int(res.y1 - res.y0);
    if (rw == 0 || rh == 0) continue;
    for (int y = 0; y < rh; ++y) line(&buf[size_t(y) * w], rw, int(res.x0 & 1), tmp);
    columns(buf.data(), w, rw, rh, int(res.y0 & 1), tmp);
  }
}

// ------------------------------------------------------------- the codestream

struct TileState {
  Tcp tcp;  // a copy of the main header's, made at the tile's first SOT
  bool has_tcp = false;
  std::vector<uint8_t> data;
  int part = -1, nparts = 0;
  bool done = false;
};

// The codestream read as OpenJPEG 2.5's strict decoder reads it through
// PIL's loop of opj_read_tile_header / opj_decode_tile_data: each tile is
// handed over when OpenJPEG returns it, and the first failure ends the
// image (the tiles handed over stay, as under LOAD_TRUNCATED_IMAGES).
struct Decoder {
  const uint8_t* d;
  size_t n;
  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}
  Image im{};
  Tcp main;
  size_t pos = 0;
  int state = ST_MHSIZ;
  // the output: ncomp planes of out_h x out_w and the mask of the tiles handed over
  int32_t* out = nullptr;
  uint8_t* written = nullptr;
  int64_t out_w = 0, out_h = 0;
  std::vector<TileState> tiles;
  int cur_tile = 0;
  bool can_decode = false, last_tile_part = false, main_qcd = false;
  uint32_t sot_length = 0;

  size_t left() const { return n - pos; }
  uint32_t next16() {
    if (left() < 2) broken("stream too short");
    uint32_t v = rd16(d + pos);
    pos += 2;
    return v;
  }

  // A marker segment's handler; `m` read, its payload at p.
  void handle(uint32_t m, const uint8_t* p, uint32_t size) {
    Tcp& tcp = state == ST_TPH ? tiles[cur_tile].tcp : main;
    switch (m) {
      case 0xff51:
        parse_siz(p, size, im);
        main.tccps.assign(im.ncomp, Tccp());
        tiles.resize(size_t(im.tw) * im.th);
        state = ST_MH;
        break;
      case 0xff52: case 0xff53: case 0xff5c: case 0xff5d:
        read_coding_marker(m, p, size, im, tcp);
        if (m == 0xff5c && state == ST_MH) main_qcd = true;
        break;
      case 0xff90: read_sot(p, size); break;
      case 0xff5e: refuse("RGN (regions of interest)");
      case 0xff5f: refuse("POC (progression order changes)");
      case 0xff60: refuse("PPM (packed packet headers in the main header)");
      case 0xff61: refuse("PPT (packed packet headers in a tile-part header)");
      case 0xff50: case 0xff59: refuse("HTJ2K (Part 15) codestreams");
      case 0xff74: case 0xff75: case 0xff77: case 0xff78: refuse("Part 2 extensions");
      case 0xff55: {  // TLM
        if (size < 2) broken("Error reading TLM marker");
        uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
        if (st == 3) broken("Error reading TLM marker");
        if ((size - 2) % ((sp + 1) * 2 + st)) broken("Error reading TLM marker");
        break;
      }
      case 0xff57:  // PLM
        if (size < 1) broken("Error reading PLM marker");
        break;
      case 0xff58: {  // PLT
        if (size < 1) broken("Error reading PLT marker");
        uint32_t len = 0;
        for (uint32_t i = 1; i < size; ++i) {
          len |= p[i] & 0x7f;
          len = (p[i] & 0x80) ? len << 7 : 0;
        }
        if (len) broken("Error reading PLT marker");
        break;
      }
      case 0xff63:  // CRG
        if (size != 4u * uint32_t(im.ncomp)) broken("Error reading CRG marker");
        break;
      default: break;  // COM
    }
  }

  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) broken("Error reading SOT marker");
    uint32_t isot = rd16(p), psot = rd32(p + 2), tpsot = p[6], tnsot = p[7];
    if (isot >= tiles.size()) broken("invalid tile number");
    cur_tile = int(isot);
    TileState& ts = tiles[isot];
    if (ts.part + 1 != int(tpsot)) broken("invalid tile-part index");
    if (!ts.has_tcp) {
      ts.tcp = main;
      ts.has_tcp = true;
    }
    ts.part = int(tpsot);
    if (psot != 0 && psot < 14 && psot != 12) broken("Psot value is not correct");
    if (!psot) last_tile_part = true;
    if (ts.nparts && tpsot >= uint32_t(ts.nparts)) broken("TPsot past the tile's parts");
    if (tnsot) {
      if (tpsot >= tnsot) broken("TPsot past TNsot");
      ts.nparts = int(tnsot);
    }
    if (ts.nparts && ts.nparts == int(tpsot) + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : psot - 12;
    state = ST_TPH;
  }

  // Marker segments up to the first SOT (opj_j2k_read_header_procedure).
  void main_header() {
    if (n < 2 || rd16(d) != 0xff4f) broken("no SOC");
    pos = 2;
    uint32_t m = next16();
    while (m != 0xff90) {
      if (m < 0xff00) broken("a marker was expected");
      int st = marker_states(m);
      if (st == kUnknown) {  // opj_j2k_read_unk: two bytes at a time up to a known marker
        for (;;) {
          uint32_t u = next16();
          if (u < 0xff00) continue;
          int ust = marker_states(u);
          if (!(state & (ust == kUnknown ? ST_MH | ST_TPH : ust)))
            broken("a marker not compliant with its position");
          if (ust != kUnknown) {
            m = u;
            break;
          }
        }
        if (m == 0xff90) break;
        st = marker_states(m);
      }
      if (!(state & st)) broken("a marker not compliant with its position");
      uint32_t size = next16();
      if (size < 2) broken("invalid marker size");
      size -= 2;
      if (left() < size) broken("stream too short");
      const uint8_t* p = d + pos;
      pos += size;
      handle(m, p, size);
      m = next16();
    }
    if (state == ST_MHSIZ) broken("no SIZ marker");
    if (!main.cod) broken("no COD marker in the main header");
    if (!main_qcd) broken("no QCD marker in the main header");
    state = ST_TPHSOT;
  }

  // The next tile OpenJPEG hands over (opj_j2k_read_tile_header); -1 at the end.
  int read_tile_header() {
    uint32_t m = 0xff90;
    if (state == ST_EOC) m = 0xffd9;
    else if (state != ST_TPHSOT) broken("the codestream ended");
    while (!can_decode && m != 0xffd9) {
      while (m != 0xff93) {
        if (left() == 0) {
          state = ST_NEOC;
          break;
        }
        uint32_t size = next16();
        if (size < 2) broken("inconsistent marker size");
        if (m == 0x8080 && left() == 0) {
          state = ST_NEOC;
          break;
        }
        if (state & ST_TPH) sot_length -= size + 2;
        size -= 2;
        int st = marker_states(m);
        if (!(state & (st == kUnknown ? ST_MH | ST_TPH : st)))
          broken("a marker not compliant with its position");
        if (left() < size) broken("stream too short");
        if (st == kUnknown) broken("an unknown marker in a tile-part header");
        const uint8_t* p = d + pos;
        pos += size;
        handle(m, p, size);
        m = next16();
      }
      if (left() == 0 && state == ST_NEOC) break;
      // SOD: the tile-part's data (opj_j2k_read_sod)
      if (last_tile_part) sot_length = uint32_t(left() - 2);
      else if (sot_length >= 2) sot_length -= 2;
      if (sot_length) {
        if (sot_length > left()) broken("tile-part length inconsistent with stream length");
        std::vector<uint8_t>& td = tiles[cur_tile].data;
        td.insert(td.end(), d + pos, d + pos + sot_length);
        pos += sot_length;
      }
      state = ST_TPHSOT;
      if (!can_decode) m = next16();
    }
    if (m == 0xffd9 && state != ST_EOC) {
      cur_tile = 0;
      state = ST_EOC;
    }
    if (!can_decode) {
      while (cur_tile < int(tiles.size()) && (tiles[cur_tile].done || tiles[cur_tile].data.empty()))
        ++cur_tile;
      if (cur_tile == int(tiles.size())) return -1;
    }
    return cur_tile;
  }

  // Decode tile t into its components' samples (after the DC shift and clamp).
  std::vector<std::vector<int32_t>> decode_tile(int t, int64_t& tx0, int64_t& ty0, int64_t& tx1,
                                                int64_t& ty1) {
    TileState& ts = tiles[t];
    if (ts.data.empty()) broken("a tile without data");
    uint32_t p = uint32_t(t) % im.tw, q = uint32_t(t) / im.tw;
    tx0 = std::max<int64_t>(int64_t(im.tx0) + int64_t(p) * im.tdx, im.x0);
    ty0 = std::max<int64_t>(int64_t(im.ty0) + int64_t(q) * im.tdy, im.y0);
    tx1 = std::min<int64_t>(int64_t(im.tx0) + int64_t(p + 1) * im.tdx, im.x1);
    ty1 = std::min<int64_t>(int64_t(im.ty0) + int64_t(q + 1) * im.tdy, im.y1);
    // PIL's bounds check of the tile against its image, before it decodes
    if (tx1 - im.x0 > out_w || ty1 - im.y0 > out_h) broken("a tile outside PIL's image");
    const Tcp& tcp = ts.tcp;
    if (tcp.prog < 0) broken("unknown progression order");
    if (tcp.csty & 0x02) refuse("SOP markers");
    if (tcp.csty & 0x04) refuse("EPH markers");
    std::vector<TileComp> tcs(im.ncomp);
    for (int c = 0; c < im.ncomp; ++c) {
      TileComp& tc = tcs[c];
      tc.x0 = tx0;
      tc.y0 = ty0;
      tc.x1 = tx1;
      tc.y1 = ty1;
      tc.cod = tcp.tccps[c];
      if (tc.cod.cblksty & 0x40) refuse("HTJ2K code-blocks");
      if (tc.cod.cblksty)
        refuse("code-block style flags (bypass, reset, termall, vertical causal, predictable "
               "termination or segmentation symbols)");
      build_tilecomp(tc, im.comps[c]);
    }
    if (tcp.mct && im.ncomp >= 3 &&
        (tcs[1].cod.qmfbid != tcs[0].cod.qmfbid || tcs[2].cod.qmfbid != tcs[0].cod.qmfbid))
      refuse("a multiple component transform over components of different wavelets");
    size_t pos = 0;
    packet_order(tcs, tcp.prog, tcp.layers, tx0, ty0, tx1, ty1, [&](int l, int r, int c, int p) {
      read_packet(tcs[c], r, p, l, ts.data.data(), ts.data.size(), &pos);
    });
    init_tables();
    T1 t1;
    for (int c = 0; c < im.ncomp; ++c) {
      TileComp& tc = tcs[c];
      int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      bool rev = tc.cod.qmfbid == 1;
      if (rev) tc.idata.assign(size_t(w * h), 0);
      else tc.fdata.assign(size_t(w * h), 0.0f);
      for (size_t r = 0; r < tc.res.size(); ++r) {
        Res& res = tc.res[r];
        for (int b = 0; b < res.nbands; ++b) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          int64_t offx = 0, offy = 0;
          if (band.bandno & 1) offx = tc.res[r - 1].x1 - tc.res[r - 1].x0;
          if (band.bandno & 2) offy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
          float step = 0.5f * band.stepsize;
          for (PrecBand& pb : band.precs)
            for (Cblk& cb : pb.cblks) {
              if (cb.numsegs == 0) continue;  // never included: zeros
              t1.decode(cb, band.bandno);
              int bw = cb.x1 - cb.x0, bh = cb.y1 - cb.y0;
              for (int y = 0; y < bh; ++y) {
                size_t o = size_t(cb.y0 - band.y0 + offy + y) * w + size_t(cb.x0 - band.x0 + offx);
                const int32_t* src = &t1.data[size_t(y) * bw];
                if (rev)
                  for (int x = 0; x < bw; ++x) tc.idata[o + x] = src[x] / 2;
                else
                  for (int x = 0; x < bw; ++x) tc.fdata[o + x] = float(src[x]) * step;
              }
            }
        }
      }
      if (rev) idwt2d(tc, tc.idata, idwt53_line, idwt53_columns);
      else idwt2d(tc, tc.fdata, idwt97_line, idwt97_columns);
    }
    size_t npix = size_t((tx1 - tx0) * (ty1 - ty0));
    if (tcp.mct && im.ncomp >= 3) {
      if (tcs[0].cod.qmfbid == 1) {
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        for (size_t i = 0; i < npix; ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
        for (size_t i = 0; i < npix; ++i) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
    std::vector<std::vector<int32_t>> samples(im.ncomp);
    for (int c = 0; c < im.ncomp; ++c) {
      const CompInfo& ci = im.comps[c];
      int64_t lo = ci.sgnd ? -(int64_t(1) << (ci.prec - 1)) : 0;
      int64_t hi = ci.sgnd ? (int64_t(1) << (ci.prec - 1)) - 1 : (int64_t(1) << ci.prec) - 1;
      int64_t shift = ci.sgnd ? 0 : int64_t(1) << (ci.prec - 1);
      std::vector<int32_t>& out_c = samples[c];
      out_c.resize(npix);
      auto clamp = [lo, hi](int64_t v) { return int32_t(v < lo ? lo : v > hi ? hi : v); };
      if (tcs[c].cod.qmfbid == 1) {
        const int32_t* src = tcs[c].idata.data();
        for (size_t i = 0; i < npix; ++i) out_c[i] = clamp(int64_t(src[i]) + shift);
      } else {
        const float* src = tcs[c].fdata.data();
        for (size_t i = 0; i < npix; ++i) {
          float f = src[i];
          out_c[i] = f > float(INT32_MAX) ? int32_t(hi)
                     : f < float(INT32_MIN) ? int32_t(lo)
                                            : clamp(int64_t(std::lrintf(f)) + shift);
        }
      }
    }
    ts.done = true;
    ts.data = std::vector<uint8_t>();
    ts.tcp = Tcp();
    can_decode = false;
    return samples;
  }

  void deliver(const std::vector<std::vector<int32_t>>& samples, int64_t tx0, int64_t ty0,
               int64_t tx1, int64_t ty1) {
    int64_t ox = tx0 - im.x0, oy = ty0 - im.y0, tw = tx1 - tx0, th = ty1 - ty0;
    for (int c = 0; c < im.ncomp; ++c) {
      int32_t* plane = out + size_t(c) * out_w * out_h;
      for (int64_t y = 0; y < th; ++y)
        std::memcpy(plane + size_t(oy + y) * out_w + ox, samples[c].data() + y * tw,
                    sizeof(int32_t) * size_t(tw));
    }
    for (int64_t y = 0; y < th; ++y) std::memset(written + size_t(oy + y) * out_w + ox, 1, size_t(tw));
  }

  // PIL's loop after the main header: read a tile's header, decode it, hand
  // it over, until the end.
  void run() {
    for (;;) {
      int t = read_tile_header();
      if (t < 0) return;
      int64_t tx0, ty0, tx1, ty1;
      auto samples = decode_tile(t, tx0, ty0, tx1, ty1);
      if (state != ST_EOC && state != ST_NEOC) {  // opj_j2k_decode_tile reads the next marker
        uint32_t m = next16();
        if (m == 0xffd9) {
          cur_tile = 0;
          state = ST_EOC;
        } else if (m != 0xff90) {
          if (left()) broken("expected SOT");
          state = ST_NEOC;
        }
      }
      deliver(samples, tx0, ty0, tx1, ty1);
    }
  }
};

void set_error(char* err, int64_t errlen, const std::string& why) {
  if (errlen <= 0) return;
  std::snprintf(err, size_t(errlen), "%s", why.c_str());
}

}  // namespace

extern "C" {

// The SIZ fields: info = [x0, y0, x1, y1, ncomp, (prec, sgnd) x min(ncomp, 4)].
// 0, -1 (the main header fails, the reason in err) or -2 (refused).
int64_t jpeg2000_info(const uint8_t* data, int64_t len, int64_t* info, char* err, int64_t errlen) {
  try {
    Decoder dec(data, size_t(len));
    dec.main_header();
    info[0] = dec.im.x0;
    info[1] = dec.im.y0;
    info[2] = dec.im.x1;
    info[3] = dec.im.y1;
    info[4] = dec.im.ncomp;
    for (int c = 0; c < dec.im.ncomp && c < 4; ++c) {
      info[5 + 2 * c] = dec.im.comps[c].prec;
      info[6 + 2 * c] = dec.im.comps[c].sgnd;
    }
    return 0;
  } catch (const Refused& e) {
    set_error(err, errlen, e.why);
    return -2;
  } catch (const Broken& e) {
    set_error(err, errlen, e.why);
    return -1;
  }
}

// Decode into `out`, ncomp planes of h x w int32 (PIL's image, whose origin
// is the image's), and mark the pixels of each tile handed over in `written`
// (h x w, zeroed by the caller). 0: to the end; 1: up to the first failure
// (the reason in err); -2: refused (err names the feature).
int64_t jpeg2000_decode(const uint8_t* data, int64_t len, int32_t* out, uint8_t* written,
                        int64_t w, int64_t h, int64_t ncomp, char* err, int64_t errlen) {
  Decoder dec(data, size_t(len));
  dec.out = out;
  dec.written = written;
  dec.out_w = w;
  dec.out_h = h;
  try {
    dec.main_header();
    if (dec.im.ncomp != ncomp) broken("component count differs from the caller's");
    dec.run();
    return 0;
  } catch (const Refused& e) {
    set_error(err, errlen, e.why);
    return -2;
  } catch (const Broken& e) {
    set_error(err, errlen, e.why);
    return 1;
  }
}
}
