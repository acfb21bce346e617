// JPEG decoding, bit for bit what libjpeg-turbo gives Pillow's
// Image.open(path) and OpenCV's imread (image_io.py turns 4-component
// output into RGB as each of them does): host code for the data pipeline's
// image reader (sam2_video_tpu_torch/data/image_io.py, whose
// jpeg_samples_numpy is the reference this file follows step by step).
//
// Sequential and progressive DCT, Huffman-coded (SOF0-SOF2, jdhuff.c,
// jdphuff.c) or arithmetic-coded (SOF9, SOF10, jdarith.c: the QM coder,
// DAC conditioning), and lossless Huffman (SOF3: jdlhuff.c differences,
// jdpred.c predictors 1-7, the point transform). 8-bit samples, 1 (grey),
// 3 (YCbCr, or RGB by an Adobe transform 0, the component ids 'R', 'G',
// 'B' or, in lossless mode, any ids without a JFIF marker) or 4 components
// (CMYK, or YCCK by an Adobe transform other than 0), any sampling factors
// that divide the largest, restart intervals. libjpeg's islow integer IDCT
// (jidctint.c) with its output saturated as libjpeg-turbo's SIMD code
// does, fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2 triangle
// filters, box replication otherwise and always in lossless mode),
// jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK. EXIF orientation
// is not applied (neither reader does here). Everything else (hierarchical
// or arithmetic lossless coding, 12-bit, lossless YCbCr or YCCK, a
// truncated or corrupt stream, an unknown marker) is refused with a
// message. Built with g++ on first use and loaded with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural index, padded so a corrupt run never indexes
// past a block
const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Fail{what}; }

struct Huffman {
    bool defined = false;
    uint8_t vals[256];
    int32_t maxcode[18];   // largest code of each length, -1 if none
    int32_t valptr[17];    // index in vals of each length's first code
    int32_t mincode[17];
    uint16_t look[512];    // next 9 bits -> length << 8 | symbol, 0: longer

    void build(const uint8_t* counts, const uint8_t* v, int total) {
        std::memcpy(vals, v, total);
        std::memset(look, 0, sizeof(look));
        int32_t code = 0, k = 0;
        for (int len = 1; len <= 16; ++len) {
            valptr[len] = k;
            mincode[len] = code;
            for (int i = 0; i < counts[len - 1]; ++i) {
                if (code >= (1 << len)) fail("bad JPEG Huffman table");
                if (len <= 9) {
                    int lo = code << (9 - len), n = 1 << (9 - len);
                    for (int j = 0; j < n; ++j)
                        look[lo + j] = (uint16_t)((len << 8) | vals[k]);
                }
                ++code;
                ++k;
            }
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        defined = true;
    }
};

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed bin (probability 0.5) of signs and DC refinement bits
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int w = 0, hgt = 0;    // downsampled size
    int bw = 0, bh = 0;    // blocks (lossless: samples) across and down,
                           // the MCU padding in
    std::vector<int32_t> coef;      // DCT coefficients or lossless
                                    // differences
    std::vector<uint8_t> samples;   // lossless: hgt x w after a scan
    bool latched = false;
    int32_t q[64] = {};    // quantisation table, natural order
};

enum Space { kGrey, kRGB, kYCbCr, kCMYK, kYCCK };

struct Frame {
    bool progressive = false, arithmetic = false, lossless = false;
    bool jfif = false;
    int adobe = -1;
    int width = 0, height = 0, hmax = 1, vmax = 1;
    // DAC conditioning of the 16 arithmetic tables, as SOI resets them
    int dc_l[16], dc_u[16], ac_k[16];
    std::vector<Component> comps;

    Frame() {
        for (int t = 0; t < 16; ++t) {
            dc_l[t] = 0;
            dc_u[t] = 1;
            ac_k[t] = 5;
        }
    }
    int unit() const { return lossless ? 1 : 8; }
    // jdapimin.c default_decompress_parms
    Space space() const {
        const size_t n = comps.size();
        if (n == 1) return kGrey;
        if (n == 4) return adobe > 0 ? kYCCK : kCMYK;
        if (jfif) return kYCbCr;
        if (adobe >= 0) return adobe == 0 ? kRGB : kYCbCr;
        if (lossless || (comps[0].id == 82 && comps[1].id == 71 &&
                         comps[2].id == 66))
            return kRGB;
        return kYCbCr;
    }
};

// the bits of one restart interval, byte stuffing removed, zeros past the
// end (as libjpeg feeds them)
struct Bits {
    const uint8_t* b;
    int64_t p = 0, end = 0;
    uint32_t peek16() const {
        int64_t i = p >> 3;
        uint32_t v = ((uint32_t)b[i] << 16) | ((uint32_t)b[i + 1] << 8) |
                     b[i + 2];
        return (v >> (8 - (p & 7))) & 0xffff;
    }
    int get(int s) {
        if (!s) return 0;
        int v = (int)(peek16() >> (16 - s));
        p += s;
        return v;
    }
    int value(int s) {  // HUFF_EXTEND
        if (s > 16) fail("corrupt JPEG data (coefficient size)");
        int v = get(s);
        return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
    }
    int sym(const Huffman& t) {
        uint32_t w = peek16();
        uint16_t e = t.look[w >> 7];
        if (e) {
            p += e >> 8;
            return e & 255;
        }
        for (int len = 10; len <= 16; ++len) {
            int32_t code = (int32_t)(w >> (16 - len));
            if (code <= t.maxcode[len]) {
                p += len;
                return t.vals[t.valptr[len] + code - t.mincode[len]];
            }
        }
        fail("corrupt JPEG data (bad Huffman code)");
    }
};

// jdarith.c arith_decode over one interval's bytes, zeros past the end
struct ArithDec {
    const uint8_t* b;
    int64_t n = 0, pos = 0, c = 0, a = 0;
    int ct = -16;  // two bytes are read first

    int operator()(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | (pos < n ? b[pos] : 0);
                ++pos;
                if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        const uint32_t e = kAritab[sv & 0x7F];
        const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
        const int64_t qe = e >> 16;
        a -= qe;
        const int64_t temp = a << ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {           // conditional LPS exchange
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
            a = qe;
        } else if (a < 0x8000) {    // conditional MPS exchange
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

inline int32_t int16_of(int64_t v) {  // as libjpeg's JCOEF holds it
    return (int32_t)(int16_t)(uint16_t)(v & 0xFFFF);
}

// zero bytes after an interval's data: more than one block can read
constexpr int kSlack = 512;

struct Scan {
    Frame* f;
    std::vector<int> comps;
    const Huffman* dc[4];
    const Huffman* ac[4];
    int ss, se, ah, al, restart;
    int pred[4];
    int eobrun;
    // arithmetic coding: statistics bins per conditioning table
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed;
    int64_t last_dc[4];
    int dc_ctx[4];

    void ac_first(Bits& bits, int32_t* coef, const Huffman& t) {
        if (eobrun) {
            --eobrun;
            return;
        }
        for (int k = ss; k <= se; ++k) {
            int rs = bits.sym(t), r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) fail("corrupt JPEG data");
                coef[kZigzag[k]] = (int32_t)((uint32_t)bits.value(s) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = (1 << r) + bits.get(r) - 1;
                break;
            }
        }
    }

    void ac_refine(Bits& bits, int32_t* coef, const Huffman& t) {
        const int p1 = 1 << al, m1 = -(1 << al);
        int k = ss;
        auto correct = [&](int32_t& c) {
            if (bits.get(1) && !(c & p1)) c += c >= 0 ? p1 : m1;
        };
        if (!eobrun) {
            for (; k <= se; ++k) {
                int rs = bits.sym(t), r = rs >> 4, s = rs & 15;
                if (s) {
                    s = bits.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = (1 << r) + bits.get(r);
                    break;
                }
                for (; k <= se; ++k) {
                    int32_t& c = coef[kZigzag[k]];
                    if (c) {
                        correct(c);
                    } else if (--r < 0) {
                        break;
                    }
                }
                if (s) {
                    if (k > 63) fail("corrupt JPEG data");
                    coef[kZigzag[k]] = s;
                }
            }
        }
        if (eobrun) {
            for (; k <= se; ++k) {
                int32_t& c = coef[kZigzag[k]];
                if (c) correct(c);
            }
            --eobrun;
        }
    }

    void block(Bits& bits, int slot, int32_t* coef) {
        if (f->lossless) {  // jdlhuff.c: a sample's difference
            const int s = bits.sym(*dc[slot]);
            coef[0] = s == 16 ? 32768 : bits.value(s);
        } else if (!f->progressive) {
            pred[slot] += bits.value(bits.sym(*dc[slot]));
            coef[0] = pred[slot];
            const Huffman& t = *ac[slot];
            for (int k = 1; k < 64; ++k) {
                int rs = bits.sym(t), r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    if (k > 63) fail("corrupt JPEG data");
                    coef[kZigzag[k]] = bits.value(s);
                } else if (r != 15) {
                    break;
                } else {
                    k += 15;
                }
            }
        } else if (ss == 0) {
            if (ah == 0) {
                pred[slot] += bits.value(bits.sym(*dc[slot]));
                coef[0] = (int32_t)((uint32_t)pred[slot] << al);
            } else if (bits.get(1)) {
                coef[0] |= 1 << al;
            }
        } else if (ah == 0) {
            ac_first(bits, coef, *ac[slot]);
        } else {
            ac_refine(bits, coef, *ac[slot]);
        }
        if (bits.p > bits.end) fail("truncated or corrupt JPEG data");
    }

    // jdarith.c Figures F.23 and F.24 from bin st[i]: |v| - 1; a DC
    // category continues at bin 20 (X1), an AC one past its second
    // decision at ac_bins (X2: 189 or 217)
    int magnitude(ArithDec& d, uint8_t* st, int i, int ac_bins) {
        int m = d(st + i);
        if (m && (!ac_bins || d(st + i))) {
            if (ac_bins) m <<= 1;
            i = ac_bins ? ac_bins : 20;
            while (d(st + i)) {
                if ((m <<= 1) == 0x8000)
                    fail("corrupt JPEG data (arithmetic magnitude "
                         "overflow)");
                ++i;
            }
        }
        int v = m;
        i += 14;
        while (m >>= 1)
            if (d(st + i)) v |= m;
        return v;
    }

    // Figure F.19 with the conditioning of F.1.4.4.1.2
    int dc_diff(ArithDec& d, int slot, int tbl) {
        uint8_t* st = dc_stats[tbl];
        const int s0 = dc_ctx[slot];
        if (!d(st + s0)) {
            dc_ctx[slot] = 0;
            return 0;
        }
        const int sign = d(st + s0 + 1);
        const int v = magnitude(d, st, s0 + 2 + sign, 0);
        int m = 0;
        for (int t = v; t; t >>= 1) m = m ? m << 1 : 1;
        if (m < ((1 << f->dc_l[tbl]) >> 1))
            dc_ctx[slot] = 0;
        else if (m > ((1 << f->dc_u[tbl]) >> 1))
            dc_ctx[slot] = 12 + 4 * sign;
        else
            dc_ctx[slot] = 4 + 4 * sign;
        return sign ? -(v + 1) : v + 1;
    }

    // Figure F.20 over ss..se, each value << shift
    void arith_ac(ArithDec& d, int32_t* coef, int tbl, int from, int to,
                  int shift) {
        uint8_t* st = ac_stats[tbl];
        for (int k = from; k <= to; ++k) {
            int i = 3 * (k - 1);
            if (d(st + i)) break;  // EOB
            while (!d(st + i + 1)) {
                i += 3;
                if (++k > to)
                    fail("corrupt JPEG data (arithmetic spectral overflow)");
            }
            const int sign = d(&fixed);
            const int v = magnitude(d, st, i + 2,
                                    k <= f->ac_k[tbl] ? 189 : 217) + 1;
            coef[kZigzag[k]] = int16_of((int64_t)(uint32_t)(sign ? -v : v)
                                        << shift);
        }
    }

    void arith_ac_refine(ArithDec& d, int32_t* coef, int tbl) {
        uint8_t* st = ac_stats[tbl];
        const int p1 = 1 << al, m1 = -(1 << al);
        int kex = se;
        while (kex > 0 && !coef[kZigzag[kex]]) --kex;
        for (int k = ss; k <= se; ++k) {
            int i = 3 * (k - 1);
            if (k > kex && d(st + i)) break;  // EOB
            for (;;) {
                int32_t& c = coef[kZigzag[k]];
                if (c) {  // previously nonzero
                    if (d(st + i + 2)) c += c < 0 ? m1 : p1;
                    break;
                }
                if (d(st + i + 1)) {  // newly nonzero
                    c = d(&fixed) ? m1 : p1;
                    break;
                }
                i += 3;
                if (++k > se)
                    fail("corrupt JPEG data (arithmetic spectral overflow)");
            }
        }
    }

    void arith_block(ArithDec& d, int slot, int32_t* coef) {
        const Component& c = f->comps[comps[slot]];
        if (!f->progressive) {
            last_dc[slot] = (last_dc[slot] + dc_diff(d, slot, c.td)) & 0xFFFF;
            coef[0] = int16_of(last_dc[slot]);
            arith_ac(d, coef, c.ta, 1, 63, 0);
        } else if (ss == 0) {
            if (ah == 0) {
                last_dc[slot] += dc_diff(d, slot, c.td);
                coef[0] = int16_of((int64_t)((uint64_t)last_dc[slot] << al));
            } else if (d(&fixed)) {
                coef[0] |= 1 << al;
            }
        } else if (ah == 0) {
            arith_ac(d, coef, c.ta, ss, se, al);
        } else {
            arith_ac_refine(d, coef, c.ta);
        }
    }

    // lossless: MCUs in an MCU row, of which the restart interval must be
    // a whole number (jddiffct.c: the predictors restart with a row)
    int mcus_per_row() const {
        if (comps.size() == 1) return f->comps[comps[0]].w;
        return (f->width + f->hmax - 1) / f->hmax;
    }

    // intervals: unstuffed bytes, each followed by kSlack zero bytes
    void run(const std::vector<std::vector<uint8_t>>& intervals) {
        if (f->lossless && restart % mcus_per_row())
            fail("lossless JPEG whose restart interval is not a whole "
                 "number of MCU rows");
        // each MCU's blocks (lossless: samples), in the scan's order
        const int u = f->unit(), size = u * u;
        int64_t mcus;
        int mcux = 0;
        if (comps.size() == 1) {
            Component& c = f->comps[comps[0]];
            mcux = (c.w + u - 1) / u;
            mcus = (int64_t)mcux * ((c.hgt + u - 1) / u);
        } else {
            mcux = (f->width + u * f->hmax - 1) / (u * f->hmax);
            mcus = (int64_t)mcux *
                   ((f->height + u * f->vmax - 1) / (u * f->vmax));
        }
        int64_t per = restart ? restart : mcus;
        int64_t want = mcus ? (mcus + per - 1) / per : 1;
        if ((int64_t)intervals.size() != (want ? want : 1))
            fail("corrupt JPEG data (restart markers do not match the "
                 "restart interval)");
        int64_t m = 0;
        for (const auto& seg : intervals) {
            Bits bits;
            bits.b = seg.data();
            bits.end = 8 * ((int64_t)seg.size() - kSlack);
            ArithDec dec;
            dec.b = seg.data();
            dec.n = (int64_t)seg.size() - kSlack;
            for (int i = 0; i < 4; ++i) {
                pred[i] = dc_ctx[i] = 0;
                last_dc[i] = 0;
            }
            eobrun = 0;
            std::memset(dc_stats, 0, sizeof(dc_stats));
            std::memset(ac_stats, 0, sizeof(ac_stats));
            fixed = 113;
            auto one = [&](int slot, int32_t* coef) {
                if (f->arithmetic)
                    arith_block(dec, slot, coef);
                else
                    block(bits, slot, coef);
            };
            int64_t stop = m + per < mcus ? m + per : mcus;
            for (; m < stop; ++m) {
                int my = (int)(m / mcux), mx = (int)(m % mcux);
                if (comps.size() == 1) {
                    Component& c = f->comps[comps[0]];
                    one(0, &c.coef[((int64_t)my * c.bw + mx) * size]);
                } else {
                    for (size_t s = 0; s < comps.size(); ++s) {
                        Component& c = f->comps[comps[s]];
                        for (int y = 0; y < c.v; ++y)
                            for (int x = 0; x < c.h; ++x)
                                one((int)s,
                                    &c.coef[(((int64_t)my * c.v + y) * c.bw +
                                             mx * c.h + x) * size]);
                    }
                }
            }
        }
    }

    // jdpred.c over a lossless component's differences -> its samples:
    // the first row of the scan and of each restart interval predicted
    // from the left (its first sample from 2^(7 - Pt)), the first column
    // from above, the rest by the predictor ss; sums modulo 2^16, shifted
    // left by the point transform al and cut to 8 bits as JSAMPLE does
    void undifference(Component& c) {
        int rows = restart / mcus_per_row() * (comps.size() == 1 ? 1 : c.v);
        if (!rows) rows = c.hgt;
        std::vector<int32_t> cur(c.w), prev(c.w);
        c.samples.assign((size_t)c.w * c.hgt, 0);
        for (int y = 0; y < c.hgt; ++y) {
            const int32_t* d = &c.coef[(size_t)y * c.bw];
            int32_t ra;
            if (y % rows == 0) {
                ra = (d[0] + (1 << (7 - al))) & 0xFFFF;
                cur[0] = ra;
                for (int x = 1; x < c.w; ++x)
                    cur[x] = ra = (d[x] + ra) & 0xFFFF;
            } else {
                int32_t rb = prev[0], rc;
                cur[0] = ra = (d[0] + rb) & 0xFFFF;
                for (int x = 1; x < c.w; ++x) {
                    rc = rb;
                    rb = prev[x];
                    int32_t p;
                    switch (ss) {
                    case 1: p = ra; break;
                    case 2: p = rb; break;
                    case 3: p = rc; break;
                    case 4: p = ra + rb - rc; break;
                    case 5: p = ra + ((rb - rc) >> 1); break;
                    case 6: p = rb + ((ra - rc) >> 1); break;
                    default: p = (ra + rb) >> 1; break;
                    }
                    cur[x] = ra = (d[x] + p) & 0xFFFF;
                }
            }
            uint8_t* out = &c.samples[(size_t)y * c.w];
            for (int x = 0; x < c.w; ++x) out[x] = (uint8_t)(cur[x] << al);
            prev.swap(cur);
        }
    }
};

const char* sof_refused(int marker) {
    switch (marker) {
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical JPEG (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
    }
    return nullptr;
}

bool is_sof(int m) {
    return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
}

void read_sof(Frame& f, int marker, const uint8_t* b, int64_t len) {
    if (!f.comps.empty()) fail("JPEG with two frame headers");
    if (const char* why = sof_refused(marker))
        fail(std::string(why) +
             " is not supported (libjpeg, and so Pillow, does not decode "
             "it)");
    if (len < 6) fail("JPEG frame header is truncated");
    int precision = b[0], h = (b[1] << 8) | b[2], w = (b[3] << 8) | b[4];
    int n = b[5];
    if (precision != 8)
        fail(std::to_string(precision) +
             "-bit JPEG is not supported (8-bit only)");
    if (n != 1 && n != 3 && n != 4)
        fail(std::to_string(n) + "-component JPEG is not supported");
    if (h == 0 || w == 0)
        fail("JPEG of size 0 (or with a DNL marker) is not supported");
    if (len < 6 + 3 * n) fail("JPEG frame header is truncated");
    f.progressive = marker == 0xC2 || marker == 0xCA;
    f.arithmetic = marker == 0xC9 || marker == 0xCA;
    f.lossless = marker == 0xC3;
    f.width = w;
    f.height = h;
    for (int i = 0; i < n; ++i) {
        Component c;
        c.id = b[6 + 3 * i];
        c.h = b[7 + 3 * i] >> 4;
        c.v = b[7 + 3 * i] & 15;
        c.tq = b[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
            fail("JPEG component with bad sampling factors or table");
        f.comps.push_back(c);
    }
    for (auto& c : f.comps) {
        f.hmax = c.h > f.hmax ? c.h : f.hmax;
        f.vmax = c.v > f.vmax ? c.v : f.vmax;
    }
    const int u = f.unit();
    int mcux = (w + u * f.hmax - 1) / (u * f.hmax);
    int mcuy = (h + u * f.vmax - 1) / (u * f.vmax);
    for (auto& c : f.comps) {
        if (f.hmax % c.h || f.vmax % c.v)
            fail("JPEG sampling factors that do not divide the largest are "
                 "not supported");
        c.w = (int)(((int64_t)w * c.h + f.hmax - 1) / f.hmax);
        c.hgt = (int)(((int64_t)h * c.v + f.vmax - 1) / f.vmax);
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.coef.assign((size_t)c.bw * c.bh * u * u, 0);
    }
}

void read_dac(Frame& f, const uint8_t* b, int64_t len) {
    if (len % 2) fail("bad JPEG arithmetic conditioning (DAC) segment");
    for (int64_t i = 0; i < len; i += 2) {
        const int t = b[i], val = b[i + 1];
        if (t >= 32) fail("bad JPEG arithmetic conditioning (DAC) segment");
        if (t >= 16) {
            f.ac_k[t - 16] = val;
        } else {
            if ((val & 15) > (val >> 4))
                fail("bad JPEG arithmetic conditioning (DAC) value");
            f.dc_l[t] = val & 15;
            f.dc_u[t] = val >> 4;
        }
    }
}

// jidctint.c's constants: CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline void idct_1d(const int64_t* x, int stride, int64_t* out, int ostride,
                    int shift) {
    int64_t z2 = x[2 * stride], z3 = x[6 * stride];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (x[0] + x[4 * stride]) * (1 << kConstBits);
    int64_t tmp1 = (x[0] - x[4 * stride]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = x[7 * stride], t1 = x[5 * stride], t2 = x[3 * stride],
            t3 = x[stride];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3, z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int64_t r = (int64_t)1 << (shift - 1);
    out[0] = (tmp10 + t3 + r) >> shift;
    out[1 * ostride] = (tmp11 + t2 + r) >> shift;
    out[2 * ostride] = (tmp12 + t1 + r) >> shift;
    out[3 * ostride] = (tmp13 + t0 + r) >> shift;
    out[4 * ostride] = (tmp13 - t0 + r) >> shift;
    out[5 * ostride] = (tmp12 - t1 + r) >> shift;
    out[6 * ostride] = (tmp11 - t2 + r) >> shift;
    out[7 * ostride] = (tmp10 - t3 + r) >> shift;
}

// one component's blocks -> its plane (bw * 8 wide, bh * 8 high)
void idct_component(const Component& c, std::vector<uint8_t>& plane) {
    const int pw = c.bw * 8;
    plane.assign((size_t)pw * c.bh * 8, 0);
    int64_t x[64], ws[64], o[64];
    for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
            const int32_t* k = &c.coef[((int64_t)by * c.bw + bx) * 64];
            for (int i = 0; i < 64; ++i) x[i] = (int64_t)k[i] * c.q[i];
            for (int col = 0; col < 8; ++col)       // pass 1: columns
                idct_1d(x + col, 8, ws + col, 8, kConstBits - kPass1Bits);
            for (int row = 0; row < 8; ++row)       // pass 2: rows
                idct_1d(ws + row * 8, 1, o + row * 8, 1,
                        kConstBits + kPass1Bits + 3);
            uint8_t* dst = &plane[(size_t)by * 8 * pw + bx * 8];
            for (int row = 0; row < 8; ++row)
                for (int col = 0; col < 8; ++col) {
                    int64_t v = o[row * 8 + col] + 128;
                    dst[row * pw + col] =
                        (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
                }
        }
    }
}

// jdsample.c: the component's w x hgt samples (row pitch `pitch`) ->
// (w * hx) x (hgt * vy) samples, fancy where libjpeg-turbo is
void upsample(const uint8_t* in, int pitch, int w, int hgt, int hx, int vy,
              std::vector<uint8_t>& out) {
    const int ow = w * hx;
    out.assign((size_t)ow * hgt * vy, 0);
    auto at = [&](int y, int x) -> int {
        y = y < 0 ? 0 : y >= hgt ? hgt - 1 : y;
        x = x < 0 ? 0 : x >= w ? w - 1 : x;
        return in[(size_t)y * pitch + x];
    };
    if (hx == 2 && vy == 1 && w > 2) {
        for (int y = 0; y < hgt; ++y)
            for (int x = 0; x < w; ++x) {
                int a = 3 * at(y, x);
                out[(size_t)y * ow + 2 * x] =
                    (uint8_t)((a + at(y, x - 1) + 1) >> 2);
                out[(size_t)y * ow + 2 * x + 1] =
                    (uint8_t)((a + at(y, x + 1) + 2) >> 2);
            }
    } else if (hx == 1 && vy == 2) {
        for (int y = 0; y < hgt; ++y)
            for (int x = 0; x < w; ++x) {
                int a = 3 * at(y, x);
                out[(size_t)(2 * y) * ow + x] =
                    (uint8_t)((a + at(y - 1, x) + 1) >> 2);
                out[(size_t)(2 * y + 1) * ow + x] =
                    (uint8_t)((a + at(y + 1, x) + 2) >> 2);
            }
    } else if (hx == 2 && vy == 2 && w > 2) {
        for (int y = 0; y < hgt; ++y)
            for (int v = 0; v < 2; ++v) {
                const int ny = v ? y + 1 : y - 1;
                uint8_t* o = &out[(size_t)(2 * y + v) * ow];
                auto colsum = [&](int x) { return 3 * at(y, x) + at(ny, x); };
                for (int x = 0; x < w; ++x) {
                    int t = colsum(x);
                    o[2 * x] = (uint8_t)((3 * t + colsum(x - 1) + 8) >> 4);
                    o[2 * x + 1] = (uint8_t)((3 * t + colsum(x + 1) + 7) >> 4);
                }
            }
    } else {
        for (int y = 0; y < hgt * vy; ++y)
            for (int x = 0; x < ow; ++x)
                out[(size_t)y * ow + x] = at(y / vy, x / hx);
    }
}

void decode(const uint8_t* data, int64_t n, int64_t height, int64_t width,
            int64_t channels, uint8_t* out) {
    if (n < 3 || data[0] != 0xFF || data[1] != 0xD8 || data[2] != 0xFF)
        fail("not a JPEG file");
    Frame f;
    Huffman huff[2][4];
    int32_t qt[4][64];
    bool qdef[4] = {false, false, false, false};
    int restart = 0;
    bool seen_sos = false;
    int64_t pos = 2;
    for (;;) {
        if (pos >= n || data[pos] != 0xFF) {
            if (pos >= n) fail("truncated JPEG (no EOI marker)");
            fail("corrupt JPEG (no marker at byte " + std::to_string(pos) +
                 ")");
        }
        while (pos < n && data[pos] == 0xFF) ++pos;
        if (pos >= n) fail("truncated JPEG (no EOI marker)");
        int marker = data[pos++];
        if (marker == 0xD9) break;
        const uint8_t* body = nullptr;
        int64_t len = 0;
        if (!(marker == 0x01 || marker == 0xD8 ||
              (marker >= 0xD0 && marker <= 0xD7))) {
            if (pos + 2 > n) fail("truncated JPEG marker segment");
            int64_t l = (data[pos] << 8) | data[pos + 1];
            if (l < 2 || pos + l > n) fail("truncated JPEG marker segment");
            body = data + pos + 2;
            len = l - 2;
            pos += l;
        }
        if ((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE) {
            if (marker == 0xE0 && len >= 14 && !std::memcmp(body, "JFIF", 5))
                f.jfif = true;
            if (marker == 0xEE && len >= 12 && !std::memcmp(body, "Adobe", 5))
                f.adobe = body[11];
        } else if (marker == 0xDB) {
            for (int64_t i = 0; i < len;) {
                int pq = body[i] >> 4, tq = body[i] & 15;
                int size = pq ? 128 : 64;
                if (tq > 3 || pq > 1 || i + 1 + size > len)
                    fail("bad JPEG quantisation table");
                for (int k = 0; k < 64; ++k)
                    qt[tq][kZigzag[k]] =
                        pq ? (body[i + 1 + 2 * k] << 8) | body[i + 2 + 2 * k]
                           : body[i + 1 + k];
                qdef[tq] = true;
                i += 1 + size;
            }
        } else if (marker == 0xC4) {
            for (int64_t i = 0; i < len;) {
                if (i + 17 > len) fail("bad JPEG Huffman table");
                int tc = body[i] >> 4, th = body[i] & 15, total = 0;
                for (int k = 0; k < 16; ++k) total += body[i + 1 + k];
                if (tc > 1 || th > 3 || total > 256 || i + 17 + total > len)
                    fail("bad JPEG Huffman table");
                huff[tc][th].build(body + i + 1, body + i + 17, total);
                i += 17 + total;
            }
        } else if (marker == 0xCC) {
            read_dac(f, body, len);
        } else if (marker == 0xDD) {
            if (len < 2) fail("bad JPEG restart interval");
            restart = (body[0] << 8) | body[1];
        } else if (is_sof(marker)) {
            read_sof(f, marker, body, len);
        } else if (marker == 0xDA) {
            if (f.comps.empty())
                fail("JPEG scan before its frame header (SOF)");
            if (!seen_sos && f.lossless &&
                (f.space() == kYCbCr || f.space() == kYCCK))
                fail(std::string("lossless JPEG in ") +
                     (f.space() == kYCbCr ? "YCbCr" : "YCCK") +
                     " is not supported (libjpeg converts no colours in "
                     "lossless mode, so Pillow cannot read it)");
            seen_sos = true;
            if (len < 1 || len < 1 + 2 * body[0] + 3)
                fail("JPEG scan header is truncated");
            Scan scan;
            scan.f = &f;
            int ns = body[0], blocks = 0;
            // libjpeg's "Bogus SOS": 1..4 components per scan (the size of
            // the per-scan slots below), each at most once
            if (ns < 1 || ns > 4 || ns > (int)f.comps.size())
                fail("JPEG scan header lists " + std::to_string(ns) +
                     " components");
            for (int i = 0; i < ns; ++i) {
                int cid = body[1 + 2 * i], t = body[2 + 2 * i], ci = -1;
                for (size_t j = 0; j < f.comps.size(); ++j)
                    if (f.comps[j].id == cid) ci = (int)j;
                if (ci < 0) fail("JPEG scan of an unknown component");
                for (int prev : scan.comps)
                    if (prev == ci) fail("JPEG scan lists a component twice");
                Component& c = f.comps[ci];
                c.td = t >> 4;
                c.ta = t & 15;
                if (!f.arithmetic && (c.td > 3 || c.ta > 3))
                    fail("JPEG scan without its Huffman table");
                scan.comps.push_back(ci);
                scan.dc[i] = &huff[0][c.td & 3];
                scan.ac[i] = &huff[1][c.ta & 3];
                blocks += c.h * c.v;
                if (!c.latched && !f.lossless) {
                    if (!qdef[c.tq])
                        fail("JPEG component without a quantisation table");
                    std::memcpy(c.q, qt[c.tq], sizeof(c.q));
                    c.latched = true;
                }
            }
            scan.ss = body[1 + 2 * ns];
            scan.se = body[2 + 2 * ns];
            scan.ah = body[3 + 2 * ns] >> 4;
            scan.al = body[3 + 2 * ns] & 15;
            scan.restart = restart;
            if (ns > 1 && blocks > 10)
                fail("JPEG scan with more than 10 blocks per MCU");
            if (f.lossless) {
                if (scan.ss < 1 || scan.ss > 7 || scan.se || scan.ah ||
                    scan.al > 7)
                    fail("bad lossless JPEG scan parameters");
            } else if (f.progressive) {
                if (scan.ss > scan.se || scan.se > 63 ||
                    (scan.ss == 0) != (scan.se == 0) || scan.al > 13 ||
                    scan.ah > 13 || (scan.ss && ns != 1))
                    fail("bad progressive JPEG scan parameters");
            } else if (scan.ss != 0 || scan.se != 63 || scan.ah || scan.al) {
                fail("bad sequential JPEG scan parameters");
            }
            for (int i = 0; i < ns && !f.arithmetic; ++i) {
                if ((f.lossless || (scan.ss == 0 &&
                                    !(f.progressive && scan.ah))) &&
                    !scan.dc[i]->defined)
                    fail("JPEG scan without its Huffman table");
                if (scan.se && !scan.ac[i]->defined)
                    fail("JPEG scan without its Huffman table");
            }
            // the entropy-coded data up to the marker that ends the scan
            std::vector<std::vector<uint8_t>> intervals(1);
            for (;;) {
                const void* ff = pos < n ? std::memchr(data + pos, 0xFF,
                                                       (size_t)(n - pos))
                                         : nullptr;
                if (!ff) fail("truncated JPEG (the scan has no end)");
                const int64_t j = (const uint8_t*)ff - data;
                intervals.back().insert(intervals.back().end(), data + pos,
                                        data + j);
                pos = j;
                int64_t k = pos + 1;
                while (k < n && data[k] == 0xFF) ++k;
                if (k >= n) fail("truncated JPEG (the scan has no end)");
                if (data[k] == 0) {
                    intervals.back().push_back(0xFF);
                    pos = k + 1;
                } else if (data[k] >= 0xD0 && data[k] <= 0xD7) {
                    intervals.emplace_back();
                    pos = k + 1;
                } else {
                    pos = k - 1;
                    break;
                }
            }
            for (auto& seg : intervals) seg.resize(seg.size() + kSlack, 0);
            scan.run(intervals);
            if (f.lossless)
                for (int ci : scan.comps) scan.undifference(f.comps[ci]);
        } else if (marker == 0xDC && seen_sos) {
            // DNL after a scan
        } else {
            char buf[64];
            std::snprintf(buf, sizeof(buf),
                          "JPEG marker 0x%02X is not supported", marker);
            fail(buf);
        }
    }
    if (!seen_sos) fail("JPEG without image data (no scan)");
    if (f.height != height || f.width != width)
        fail("JPEG size differs from its header's");
    if (channels != (f.comps.size() == 4 ? 4 : 3))
        fail("JPEG component count differs from its header's");

    const int W = f.width, H = f.height;
    std::vector<std::vector<uint8_t>> full(f.comps.size());
    std::vector<int> pitch(f.comps.size());
    for (size_t ci = 0; ci < f.comps.size(); ++ci) {
        Component& c = f.comps[ci];
        const int hx = f.hmax / c.h, vy = f.vmax / c.v;
        std::vector<uint8_t> plane;
        int plane_pitch;
        if (f.lossless) {
            if (c.samples.empty())
                fail("lossless JPEG without a scan of every component");
            plane.swap(c.samples);
            plane_pitch = c.w;
        } else {
            if (!c.latched) std::memset(c.q, 0, sizeof(c.q));
            idct_component(c, plane);
            plane_pitch = c.bw * 8;
        }
        if (hx == 1 && vy == 1) {
            full[ci].swap(plane);
            pitch[ci] = plane_pitch;
        } else if (f.lossless) {  // box replication
            pitch[ci] = c.w * hx;
            full[ci].assign((size_t)pitch[ci] * c.hgt * vy, 0);
            for (int y = 0; y < c.hgt * vy; ++y)
                for (int x = 0; x < pitch[ci]; ++x)
                    full[ci][(size_t)y * pitch[ci] + x] =
                        plane[(size_t)(y / vy) * plane_pitch + x / hx];
        } else {
            upsample(plane.data(), plane_pitch, c.w, c.hgt, hx, vy, full[ci]);
            pitch[ci] = c.w * hx;
        }
    }
    auto at = [&](int ci, int y, int x) -> int {
        return full[ci][(size_t)y * pitch[ci] + x];
    };
    const Space space = f.space();
    if (space == kGrey) {
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x) {
                uint8_t* o = out + ((size_t)y * W + x) * 3;
                o[0] = o[1] = o[2] = (uint8_t)at(0, y, x);
            }
        return;
    }
    if (space == kRGB || space == kCMYK) {
        const int nc = (int)f.comps.size();
        for (int y = 0; y < H; ++y)
            for (int x = 0; x < W; ++x)
                for (int ci = 0; ci < nc; ++ci)
                    out[((size_t)y * W + x) * nc + ci] = (uint8_t)at(ci, y, x);
        return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t fr = (int64_t)(1.40200 * 65536 + 0.5),
                  fb = (int64_t)(1.77200 * 65536 + 0.5),
                  fgr = (int64_t)(0.71414 * 65536 + 0.5),
                  fgb = (int64_t)(0.34414 * 65536 + 0.5);
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((fr * x + 32768) >> 16);
        cb_b[i] = (int)((fb * x + 32768) >> 16);
        cr_g[i] = -fgr * x;
        cb_g[i] = -fgb * x + 32768;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
            const int a = at(0, y, x), b = at(1, y, x), c = at(2, y, x);
            const uint8_t r = clamp(a + cr_r[c]),
                          g = clamp(a + (int)((cb_g[b] + cr_g[c]) >> 16)),
                          bl = clamp(a + cb_b[b]);
            if (space == kYCbCr) {
                uint8_t* o = out + ((size_t)y * W + x) * 3;
                o[0] = r;
                o[1] = g;
                o[2] = bl;
            } else {  // YCCK -> CMYK: ycck_cmyk_convert, K unchanged
                uint8_t* o = out + ((size_t)y * W + x) * 4;
                o[0] = (uint8_t)(255 - r);
                o[1] = (uint8_t)(255 - g);
                o[2] = (uint8_t)(255 - bl);
                o[3] = (uint8_t)at(3, y, x);
            }
        }
}

}  // namespace

extern "C" {

// data: n bytes of a JPEG whose header says height x width and how many
// components (image_io.py reads it first); out: height * width * channels
// bytes, channels 4 for a 4-component file (CMYK as libjpeg writes it,
// YCCK converted) and 3 otherwise (grey repeated, RGB, YCbCr converted).
// Returns 0, or 1 with a message (NUL-terminated, at most errlen bytes) in
// err.
int64_t jpeg_decode(const uint8_t* data, int64_t n, int64_t height,
                    int64_t width, int64_t channels, uint8_t* out, char* err,
                    int64_t errlen) {
    try {
        decode(data, n, height, width, channels, out);
        return 0;
    } catch (const Fail& e) {
        std::snprintf(err, (size_t)errlen, "%s", e.what.c_str());
    } catch (const std::exception& e) {
        std::snprintf(err, (size_t)errlen, "JPEG decode failed: %s",
                      e.what());
    }
    return 1;
}

}  // extern "C"
