// The loops of the WebP reader that are slow in Python, host code for the
// data pipeline's image reader (sam2_video_tpu_torch/data/webp.py, which
// keeps a numpy reference of each beside it and parses the container):
// a VP8 key frame to Y, U and V planes (the boolean decoder, modes, tokens,
// reconstruction and the loop filter), libwebp's fancy upsampling and YUV
// to RGB conversion, a VP8L image to ARGB (prefix codes, LZ77, the colour
// cache and the four transforms) and the alpha plane's unfiltering. Each
// reproduces libwebp 1.6.0 bit for bit. Built with g++ on first use and
// loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// VP8 (RFC 6386; libwebp src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
// frame_dec.c, src/dsp/dec.c)
// ---------------------------------------------------------------------------

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14,
                         15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133,
                         130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125,
    128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167,
    170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221,
    225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

inline int clip(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// The boolean decoder over d[pos, end), zeros past the end; eof is
// libwebp's: set once a bit is read with more than 8 (len - 1) bits
// shifted out.
struct BoolReader {
    const uint8_t* d = nullptr;
    int64_t pos = 0, end = 0, limit = 0, shifted = 0;
    uint32_t value = 0;
    int range = 255, count = 0;
    bool eof = false;

    void init(const uint8_t* data, int64_t start, int64_t stop) {
        d = data;
        pos = start;
        end = stop;
        limit = 8 * (stop - start) - 8;
        value = (uint32_t)next() << 8;
        value |= next();
        range = 255;
        count = 0;
        shifted = 0;
        eof = limit < 0;
    }
    inline uint32_t next() { return pos < end ? d[pos++] : (++pos, 0u); }
    inline int bit(int prob) {
        if (shifted > limit) eof = true;
        const int split = 1 + (((range - 1) * prob) >> 8);
        const uint32_t big = (uint32_t)split << 8;
        int b;
        if (value >= big) {
            b = 1;
            range -= split;
            value -= big;
        } else {
            b = 0;
            range = split;
        }
        if (range < 128) {
            const int shift = __builtin_clz((unsigned)range) - 24;
            range <<= shift;
            value <<= shift;
            shifted += shift;
            count += shift;
            if (count >= 8) {
                count -= 8;
                value |= next() << count;
            }
        }
        return b;
    }
    int literal(int n) {
        int v = 0;
        while (n-- > 0) v = (v << 1) | bit(128);
        return v;
    }
    int signed_value(int n) {
        const int v = literal(n);
        return bit(128) ? -v : v;
    }
};

struct Header {
    int width, height, mb_w, mb_h;
    int use_segment, update_map, absolute;
    int quantizer[4], filter_strength[4], segment_probs[3];
    int simple, level, sharpness, use_lf_delta, ref_delta[4], mode_delta[4];
    int filter_type, partitions, use_skip, skip_prob;
    int dq[4][3][2];                   // segment, (y1, y2, uv), (dc, ac)
    uint8_t probs[4][8][3][11];
    int64_t part_start[8], part_end[8];
    BoolReader br;
};

// VP8GetHeaders: 0, or a status code of webp.py's HELPER_ERRORS
int parse_header(const uint8_t* data, int64_t n, const uint8_t* tables,
                 Header& h) {
    if (n < 10) return 6;
    const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
    h.width = (data[6] | data[7] << 8) & 0x3fff;
    h.height = (data[8] | data[9] << 8) & 0x3fff;
    const int64_t first = bits >> 5;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
        first >= n || !h.width || !h.height || data[3] != 0x9d ||
        data[4] != 0x01 || data[5] != 0x2a)
        return 6;
    if (10 + first > n) return 2;
    BoolReader& br = h.br;
    br.init(data, 10, 10 + first);
    br.literal(2);                     // colour space, clamping type
    h.use_segment = br.bit(128);
    h.update_map = 0;
    h.absolute = 1;
    for (int s = 0; s < 4; ++s) h.quantizer[s] = h.filter_strength[s] = 0;
    for (int s = 0; s < 3; ++s) h.segment_probs[s] = 255;
    if (h.use_segment) {
        h.update_map = br.bit(128);
        if (br.bit(128)) {
            h.absolute = br.bit(128);
            for (int s = 0; s < 4; ++s)
                h.quantizer[s] = br.bit(128) ? br.signed_value(7) : 0;
            for (int s = 0; s < 4; ++s)
                h.filter_strength[s] = br.bit(128) ? br.signed_value(6) : 0;
        }
        if (h.update_map)
            for (int s = 0; s < 3; ++s)
                h.segment_probs[s] = br.bit(128) ? br.literal(8) : 255;
    }
    h.simple = br.bit(128);
    h.level = br.literal(6);
    h.sharpness = br.literal(3);
    h.use_lf_delta = br.bit(128);
    for (int i = 0; i < 4; ++i) h.ref_delta[i] = h.mode_delta[i] = 0;
    if (h.use_lf_delta && br.bit(128)) {
        for (int i = 0; i < 4; ++i)
            if (br.bit(128)) h.ref_delta[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.bit(128)) h.mode_delta[i] = br.signed_value(6);
    }
    h.filter_type = h.level == 0 ? 0 : h.simple ? 1 : 2;
    if (br.eof) return 3;
    h.partitions = 1 << br.literal(2);
    int64_t pos = 10 + first;
    const int64_t sizes = pos;
    pos += 3 * (h.partitions - 1);
    if (pos > n) return 4;
    for (int p = 0; p < h.partitions - 1; ++p) {
        const uint8_t* s = data + sizes + 3 * p;
        const int64_t size = std::min<int64_t>(s[0] | s[1] << 8 | s[2] << 16,
                                               n - pos);
        h.part_start[p] = pos;
        h.part_end[p] = pos + size;
        pos += size;
    }
    if (pos >= n) return 5;
    h.part_start[h.partitions - 1] = pos;
    h.part_end[h.partitions - 1] = n;
    const int q0 = br.literal(7);
    int dq[5];
    for (int i = 0; i < 5; ++i) dq[i] = br.bit(128) ? br.signed_value(4) : 0;
    for (int s = 0; s < 4; ++s) {
        int q = q0;
        if (h.use_segment) q = h.quantizer[s] + (h.absolute ? 0 : q0);
        h.dq[s][0][0] = kDcTable[clip(q + dq[0], 127)];
        h.dq[s][0][1] = kAcTable[clip(q, 127)];
        h.dq[s][1][0] = kDcTable[clip(q + dq[1], 127)] * 2;
        h.dq[s][1][1] = std::max((kAcTable[clip(q + dq[2], 127)] * 101581)
                                 >> 16, 8);
        h.dq[s][2][0] = kDcTable[clip(q + dq[3], 117)];
        h.dq[s][2][1] = kAcTable[clip(q + dq[4], 127)];
    }
    br.bit(128);                       // refresh entropy probs: ignored
    uint8_t* probs = &h.probs[0][0][0][0];
    for (int i = 0; i < 1056; ++i)
        probs[i] = br.bit(tables[1056 + i]) ? br.literal(8) : tables[i];
    h.use_skip = br.bit(128);
    h.skip_prob = h.use_skip ? br.literal(8) : 0;
    h.mb_w = (h.width + 15) >> 4;
    h.mb_h = (h.height + 15) >> 4;
    return 0;
}

struct MB {
    uint8_t segment, skip, i4x4, uv;
    uint8_t modes[16];
};

void parse_modes(Header& h, const uint8_t* bmodes, std::vector<MB>& mbs) {
    BoolReader& br = h.br;
    std::vector<uint8_t> top(4 * h.mb_w, B_DC);
    for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
        uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
        for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
            MB& m = mbs[mb_y * h.mb_w + mb_x];
            m.segment = 0;
            if (h.update_map) {
                const int* p = h.segment_probs;
                m.segment = !br.bit(p[0]) ? br.bit(p[1]) : br.bit(p[2]) + 2;
            }
            m.skip = h.use_skip ? br.bit(h.skip_prob) : 0;
            m.i4x4 = !br.bit(145);
            uint8_t* t = &top[4 * mb_x];
            if (!m.i4x4) {
                const int ymode = br.bit(156)
                    ? (br.bit(128) ? B_TM : B_HE)
                    : (br.bit(163) ? B_VE : B_DC);
                m.modes[0] = ymode;
                memset(t, ymode, 4);
                memset(left, ymode, 4);
            } else {
                for (int y = 0; y < 4; ++y) {
                    int mode = left[y];
                    for (int x = 0; x < 4; ++x) {
                        const uint8_t* p = bmodes + (t[x] * 10 + mode) * 9;
                        if (!br.bit(p[0])) mode = B_DC;
                        else if (!br.bit(p[1])) mode = B_TM;
                        else if (!br.bit(p[2])) mode = B_VE;
                        else if (!br.bit(p[3]))
                            mode = !br.bit(p[4]) ? B_HE
                                 : !br.bit(p[5]) ? B_RD : B_VR;
                        else
                            mode = !br.bit(p[6]) ? B_LD
                                 : !br.bit(p[7]) ? B_VL
                                 : !br.bit(p[8]) ? B_HD : B_HU;
                        t[x] = mode;
                    }
                    memcpy(m.modes + 4 * y, t, 4);
                    left[y] = mode;
                }
            }
            m.uv = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE
                 : br.bit(183) ? B_TM : B_HE;
        }
    }
}

// GetCoeffs: one block's tokens from coefficient n on, dequantised into
// out[raster index] as int16; returns the position after the last read.
int get_coeffs(BoolReader& br, const uint8_t (*probs)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
    const uint8_t* p = probs[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.bit(p[0])) return n;
        while (!br.bit(p[1])) {
            if (++n == 16) return 16;
            p = probs[kBands[n]][0];
        }
        int v, next;
        if (!br.bit(p[2])) {
            v = 1;
            next = 1;
        } else {
            if (!br.bit(p[3])) {
                v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
            } else if (!br.bit(p[6])) {
                v = !br.bit(p[7]) ? 5 + br.bit(159)
                                  : 7 + 2 * br.bit(165) + br.bit(145);
            } else {
                const int bit1 = br.bit(p[8]);
                const int cat = 2 * bit1 + br.bit(p[9 + bit1]);
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
                    v += v + br.bit(*tab);
                v += 3 + (8 << cat);
            }
            next = 2;
        }
        if (br.bit(128)) v = -v;
        out[kZigzag[n]] = (int16_t)(v * dq[n > 0]);
        p = probs[kBands[n + 1]][next];
    }
    return 16;
}

void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
        tmp[i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[4 * i] + 3;
        const int* t = tmp + 4 * i;
        const int a0 = dc + t[3], a1 = t[1] + t[2];
        const int a2 = t[1] - t[2], a3 = dc - t[3];
        out[16 * (4 * i + 0)] = (int16_t)((a0 + a1) >> 3);
        out[16 * (4 * i + 1)] = (int16_t)((a3 + a2) >> 3);
        out[16 * (4 * i + 2)] = (int16_t)((a0 - a1) >> 3);
        out[16 * (4 * i + 3)] = (int16_t)((a3 - a2) >> 3);
    }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: adds the inverse DCT of in[16] to the 4x4 block at dst
void idct_add(const int16_t* in, uint8_t* dst, int stride) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
        const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
        const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
        tmp[4 * i + 0] = a + d;
        tmp[4 * i + 1] = b + c;
        tmp[4 * i + 2] = b - c;
        tmp[4 * i + 3] = a - d;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[i] + 4;
        const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
        const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
        const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
        uint8_t* row = dst + i * stride;
        row[0] = (uint8_t)clip255(row[0] + ((a + d) >> 3));
        row[1] = (uint8_t)clip255(row[1] + ((b + c) >> 3));
        row[2] = (uint8_t)clip255(row[2] + ((b - c) >> 3));
        row[3] = (uint8_t)clip255(row[3] + ((a - d) >> 3));
    }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// One 4x4 luma prediction into dst from the 8 pixels above t[0..7], the 4
// to the left l[0..3] and the corner X.
void pred4(int mode, const int* t, const int* l, int X, uint8_t* dst,
           int stride) {
    const int A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5],
              G = t[6], H = t[7], I = l[0], J = l[1], K = l[2], L = l[3];
    int o[4][4];
    switch (mode) {
    case B_DC: {
        const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
        for (auto& r : o) for (int& v : r) v = dc;
        break;
    }
    case B_TM:
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) o[y][x] = clip255(t[x] + l[y] - X);
        break;
    case B_VE: {
        const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                          avg3(C, D, E)};
        for (auto& r : o) for (int x = 0; x < 4; ++x) r[x] = v[x];
        break;
    }
    case B_HE: {
        const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                          avg3(K, L, L)};
        for (int y = 0; y < 4; ++y) for (int x = 0; x < 4; ++x) o[y][x] = v[y];
        break;
    }
    case B_RD: {
        const int v[7] = {avg3(J, K, L), avg3(I, J, K), avg3(X, I, J),
                          avg3(A, X, I), avg3(B, A, X), avg3(C, B, A),
                          avg3(D, C, B)};
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) o[y][x] = v[3 - y + x];
        break;
    }
    case B_LD: {
        const int v[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E),
                          avg3(D, E, F), avg3(E, F, G), avg3(F, G, H),
                          avg3(G, H, H)};
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) o[y][x] = v[x + y];
        break;
    }
    case B_VR:
        o[0][0] = avg2(X, A); o[0][1] = avg2(A, B);
        o[0][2] = avg2(B, C); o[0][3] = avg2(C, D);
        o[1][0] = avg3(I, X, A); o[1][1] = avg3(X, A, B);
        o[1][2] = avg3(A, B, C); o[1][3] = avg3(B, C, D);
        o[2][0] = avg3(J, I, X); o[2][1] = o[0][0];
        o[2][2] = o[0][1]; o[2][3] = o[0][2];
        o[3][0] = avg3(K, J, I); o[3][1] = o[1][0];
        o[3][2] = o[1][1]; o[3][3] = o[1][2];
        break;
    case B_VL:
        o[0][0] = avg2(A, B); o[0][1] = avg2(B, C);
        o[0][2] = avg2(C, D); o[0][3] = avg2(D, E);
        o[1][0] = avg3(A, B, C); o[1][1] = avg3(B, C, D);
        o[1][2] = avg3(C, D, E); o[1][3] = avg3(D, E, F);
        o[2][0] = o[0][1]; o[2][1] = o[0][2];
        o[2][2] = o[0][3]; o[2][3] = avg3(E, F, G);
        o[3][0] = o[1][1]; o[3][1] = o[1][2];
        o[3][2] = o[1][3]; o[3][3] = avg3(F, G, H);
        break;
    case B_HD:
        o[0][0] = avg2(I, X); o[0][1] = avg3(I, X, A);
        o[0][2] = avg3(X, A, B); o[0][3] = avg3(A, B, C);
        o[1][0] = avg2(J, I); o[1][1] = avg3(J, I, X);
        o[1][2] = o[0][0]; o[1][3] = o[0][1];
        o[2][0] = avg2(K, J); o[2][1] = avg3(K, J, I);
        o[2][2] = o[1][0]; o[2][3] = o[1][1];
        o[3][0] = avg2(L, K); o[3][1] = avg3(L, K, J);
        o[3][2] = o[2][0]; o[3][3] = o[2][1];
        break;
    default:                           // B_HU
        o[0][0] = avg2(I, J); o[0][1] = avg3(I, J, K);
        o[0][2] = avg2(J, K); o[0][3] = avg3(J, K, L);
        o[1][0] = o[0][2]; o[1][1] = o[0][3];
        o[1][2] = avg2(K, L); o[1][3] = avg3(K, L, L);
        o[2][0] = o[1][2]; o[2][1] = o[1][3];
        o[2][2] = L; o[2][3] = L;
        o[3][0] = o[3][1] = o[3][2] = o[3][3] = L;
        break;
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[y * stride + x] = (uint8_t)o[y][x];
}

// A 16x16 luma or 8x8 chroma prediction (DC with libwebp's CheckMode at
// the frame's edges, TM, V, H) into dst.
void pred_block(int mode, int size, const int* t, const int* l, int X,
                int mb_x, int mb_y, uint8_t* dst, int stride) {
    const int shift = size == 16 ? 5 : 4;
    if (mode == B_DC) {
        int st = 0, sl = 0, dc;
        for (int i = 0; i < size; ++i) {
            st += t[i];
            sl += l[i];
        }
        const int round = 1 << (shift - 1);
        if (mb_x == 0 && mb_y == 0) dc = 128;
        else if (mb_y == 0) dc = (2 * sl + round) >> shift;
        else if (mb_x == 0) dc = (2 * st + round) >> shift;
        else dc = (st + sl + round) >> shift;
        for (int y = 0; y < size; ++y) memset(dst + y * stride, dc, size);
        return;
    }
    for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x)
            dst[y * stride + x] = (uint8_t)(
                mode == B_TM ? clip255(t[x] + l[y] - X)
                : mode == B_VE ? t[x] : l[y]);
}

struct Planes {
    std::vector<uint8_t> p[3];
    int stride[3];
};

// The pixels above (with `right` more), to the left and the corner of
// the block at (x0, y0), with libwebp's frame edges: 127 above the frame
// (the corner too), 129 left of it (the corner too below the first row);
// the above-right pixels past the last macroblock repeat the last above.
void edges(const uint8_t* plane, int stride, int x0, int y0, int size,
           int mb_x, int mb_y, int right, int* t, int* l, int* tl) {
    if (mb_y == 0) {
        for (int i = 0; i < size + right; ++i) t[i] = 127;
        *tl = 127;
    } else {
        const uint8_t* row = plane + (int64_t)(y0 - 1) * stride;
        for (int i = 0; i < size; ++i) t[i] = row[x0 + i];
        for (int i = 0; i < right; ++i)
            t[size + i] = x0 + size < stride ? row[x0 + size + i]
                                             : t[size - 1];
        *tl = mb_x > 0 ? row[x0 - 1] : 129;
    }
    for (int i = 0; i < size; ++i)
        l[i] = mb_x > 0 ? plane[(int64_t)(y0 + i) * stride + x0 - 1] : 129;
}

void reconstruct(Planes& P, int mb_x, int mb_y, const MB& m,
                 const int16_t* coeffs) {
    int t[20], l[16], tl;
    {
        uint8_t* Y = P.p[0].data();
        const int s = P.stride[0], x0 = 16 * mb_x, y0 = 16 * mb_y;
        if (!m.i4x4) {
            edges(Y, s, x0, y0, 16, mb_x, mb_y, 0, t, l, &tl);
            uint8_t* dst = Y + (int64_t)y0 * s + x0;
            pred_block(m.modes[0], 16, t, l, tl, mb_x, mb_y, dst, s);
            for (int n = 0; n < 16; ++n)
                idct_add(coeffs + 16 * n,
                         dst + 4 * (n >> 2) * s + 4 * (n & 3), s);
        } else {
            int mt[20], ml[16], mtl;
            edges(Y, s, x0, y0, 16, mb_x, mb_y, 4, mt, ml, &mtl);
            for (int n = 0; n < 16; ++n) {
                const int sx = n & 3, sy = n >> 2;
                const int bx = x0 + 4 * sx, by = y0 + 4 * sy;
                int bt[8], bl[4], btl;
                if (sy == 0) {
                    for (int i = 0; i < 8; ++i) bt[i] = mt[4 * sx + i];
                    btl = sx == 0 ? mtl : mt[4 * sx - 1];
                } else {
                    const uint8_t* row = Y + (int64_t)(by - 1) * s;
                    for (int i = 0; i < 4; ++i) bt[i] = row[bx + i];
                    for (int i = 0; i < 4; ++i)
                        bt[4 + i] = sx < 3 ? row[bx + 4 + i] : mt[16 + i];
                    btl = (sx || mb_x) ? row[bx - 1] : 129;
                }
                for (int i = 0; i < 4; ++i)
                    bl[i] = (sx || mb_x) ? Y[(int64_t)(by + i) * s + bx - 1]
                                         : 129;
                uint8_t* dst = Y + (int64_t)by * s + bx;
                pred4(m.modes[n], bt, bl, btl, dst, s);
                idct_add(coeffs + 16 * n, dst, s);
            }
        }
    }
    for (int ch = 1; ch < 3; ++ch) {
        uint8_t* C = P.p[ch].data();
        const int s = P.stride[ch], x0 = 8 * mb_x, y0 = 8 * mb_y;
        edges(C, s, x0, y0, 8, mb_x, mb_y, 0, t, l, &tl);
        uint8_t* dst = C + (int64_t)y0 * s + x0;
        pred_block(m.uv, 8, t, l, tl, mb_x, mb_y, dst, s);
        for (int n = 0; n < 4; ++n)
            idct_add(coeffs + 256 + 64 * (ch - 1) + 16 * n,
                     dst + 4 * (n >> 1) * s + 4 * (n & 1), s);
    }
}

// ParseResiduals: the macroblock's tokens into coeffs[384], the contexts
// updated; returns whether any block has a coefficient.
bool residuals(BoolReader& br, const Header& h, const MB& m,
               int16_t* coeffs, uint8_t* top_nz, uint8_t* left_nz,
               int mb_x) {
    // top_nz per column: [4 y][2 u][2 v][1 dc]; left_nz the same for a row
    uint8_t* tnz = top_nz + 9 * mb_x;
    const int (*dq)[2] = h.dq[m.segment];
    bool nonzero = false;
    int first, kind;
    if (!m.i4x4) {
        int16_t dc[16] = {0};
        const int ctx = tnz[8] + left_nz[8];
        const int nz = get_coeffs(br, h.probs[1], ctx, dq[1], 0, dc);
        tnz[8] = left_nz[8] = nz > 0;
        wht(dc, coeffs);
        first = 1;
        kind = 0;
    } else {
        first = 0;
        kind = 3;
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            int16_t* b = coeffs + 16 * (4 * y + x);
            const int ctx = tnz[x] + left_nz[y];
            const int nz = get_coeffs(br, h.probs[kind], ctx, dq[0], first, b);
            tnz[x] = left_nz[y] = nz > first;
            nonzero |= nz > 1 || b[0] != 0;
        }
    for (int ch = 0; ch < 2; ++ch)
        for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
                int16_t* b = coeffs + 256 + 64 * ch + 16 * (2 * y + x);
                const int ctx = tnz[4 + 2 * ch + x] + left_nz[4 + 2 * ch + y];
                const int nz = get_coeffs(br, h.probs[2], ctx, dq[2], 0, b);
                tnz[4 + 2 * ch + x] = left_nz[4 + 2 * ch + y] = nz > 0;
                nonzero |= nz > 1 || b[0] != 0;
            }
    return nonzero;
}

struct FilterInfo {
    int limit, ilevel, hev;
    bool inner;
};

FilterInfo filter_params(const Header& h, int segment, int i4x4) {
    int level = h.level;
    if (h.use_segment)
        level = h.filter_strength[segment] + (h.absolute ? 0 : h.level);
    if (h.use_lf_delta)
        level += h.ref_delta[0] + (i4x4 ? h.mode_delta[0] : 0);
    level = clip(level, 63);
    if (level == 0) return {0, 0, 0, false};
    int ilevel = level;
    if (h.sharpness > 0) {
        ilevel >>= h.sharpness > 4 ? 2 : 1;
        ilevel = std::min(ilevel, 9 - h.sharpness);
    }
    ilevel = std::max(ilevel, 1);
    return {2 * level + ilevel, ilevel, level >= 40 ? 2 : level >= 15 ? 1 : 0,
            false};
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// The filters of dec.c at p (q0), across an edge with pixel step `step`
inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = (uint8_t)clip255(p1 + a3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
              a3 = (9 * a + 63) >> 7;
    p[-3 * step] = (uint8_t)clip255(p2 + a3);
    p[-2 * step] = (uint8_t)clip255(p1 + a2);
    p[-step] = (uint8_t)clip255(p0 + a1);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a2);
    p[2 * step] = (uint8_t)clip255(q2 - a3);
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step])
           <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
              q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

inline bool hev(const uint8_t* p, int step, int t) {
    return std::abs(p[-2 * step] - p[-step]) > t ||
           std::abs(p[step] - p[0]) > t;
}

// One edge of `size` pixels: `step` crosses it, `along` runs along it;
// kind 0 simple, 1 macroblock edge, 2 inner edge
void filter_edge(uint8_t* p, int step, int along, int size, int kind,
                 int limit, int ilevel, int hev_t) {
    const int t = 2 * limit + 1;
    for (int i = 0; i < size; ++i, p += along) {
        if (kind == 0) {
            if (needs_filter(p, step, t)) do_filter2(p, step);
        } else if (needs_filter2(p, step, t, ilevel)) {
            if (hev(p, step, hev_t)) do_filter2(p, step);
            else if (kind == 1) do_filter6(p, step);
            else do_filter4(p, step);
        }
    }
}

// DoFilter of one macroblock: left edge, inner vertical edges, top edge,
// inner horizontal edges; luma, and chroma for the normal filter
void filter_mb(Planes& P, bool simple, int mb_x, int mb_y,
               const FilterInfo& f) {
    const int nplanes = simple ? 1 : 3;
    const int mb_kind = simple ? 0 : 1, in_kind = simple ? 0 : 2;
    for (int stage = 0; stage < 4; ++stage) {
        const bool vertical_edge = stage < 2, inner = stage & 1;
        if (!inner && (vertical_edge ? mb_x : mb_y) == 0) continue;
        if (inner && !f.inner) continue;
        for (int c = 0; c < nplanes; ++c) {
            const int size = c ? 8 : 16, s = P.stride[c];
            uint8_t* base = P.p[c].data() + (int64_t)size * mb_y * s +
                            size * mb_x;
            const int lim = inner ? f.limit : f.limit + 4;
            for (int off = inner ? 4 : 0; off < (inner ? size : 1); off += 4) {
                if (vertical_edge)
                    filter_edge(base + off, 1, s, size,
                                inner ? in_kind : mb_kind, lim, f.ilevel,
                                f.hev);
                else
                    filter_edge(base + (int64_t)off * s, s, 1, size,
                                inner ? in_kind : mb_kind, lim, f.ilevel,
                                f.hev);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// VP8L (RFC 9649; libwebp src/dec/vp8l_dec.c, src/dsp/lossless.c)
// ---------------------------------------------------------------------------

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9,
                                  10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct BitReader {                     // LSB first
    const uint8_t* d;
    int64_t n, pos = 0, limit;
    BitReader(const uint8_t* data, int64_t size, int64_t start)
        : d(data), n(size), pos(start),
          limit(std::max<int64_t>(64, 8 * size)) {}
    inline uint32_t peek32() const {
        const int64_t i = pos >> 3;
        uint64_t v = 0;
        if (i + 8 <= n) {
            memcpy(&v, d + i, 8);
        } else {
            for (int64_t k = 0; k < 8 && i + k < n; ++k)
                v |= (uint64_t)d[i + k] << (8 * k);
        }
        return (uint32_t)(v >> (pos & 7));
    }
    inline uint32_t read(int bits) {
        if (!bits) return 0;
        const uint32_t v = peek32() & ((1u << bits) - 1);
        pos += bits;
        return v;
    }
    bool over() const { return pos > limit; }
};

// A canonical prefix code: one used symbol is a code of no bits; else a
// complete code, decoded through an 8-bit table and bit by bit past it.
struct Prefix {
    int single = -1;
    uint16_t table[256];               // (symbol << 4) | length, 0: longer
    int count[16] = {0};
    std::vector<uint16_t> symbols;

    bool build(const int* lengths, int size) {
        int used = 0, last = -1;
        for (int s = 0; s < size; ++s) {
            if (lengths[s] > 15) return false;
            if (lengths[s]) {
                ++used;
                last = s;
            }
        }
        if (!used) return false;
        if (used == 1) {
            single = last;
            return true;
        }
        for (int s = 0; s < size; ++s) ++count[lengths[s]];
        count[0] = 0;
        int left = 1;
        for (int len = 1; len < 16; ++len) {
            left = 2 * left - count[len];
            if (left < 0) return false;
        }
        if (left) return false;
        symbols.clear();
        for (int len = 1; len < 16; ++len)
            for (int s = 0; s < size; ++s)
                if (lengths[s] == len) symbols.push_back((uint16_t)s);
        memset(table, 0, sizeof(table));
        int code = 0, k = 0;
        for (int len = 1; len <= 8; ++len) {
            for (int i = 0; i < count[len]; ++i, ++k, ++code) {
                int rev = 0;
                for (int b = 0; b < len; ++b)
                    rev |= ((code >> (len - 1 - b)) & 1) << b;
                for (int fill = rev; fill < 256; fill += 1 << len)
                    table[fill] = (uint16_t)(symbols[k] << 4 | len);
            }
            code <<= 1;
        }
        return true;
    }
    inline int read(BitReader& br) const {
        if (single >= 0) return single;
        const uint16_t e = table[br.peek32() & 255];
        if (e) {
            br.pos += e & 15;
            return e >> 4;
        }
        int code = 0, first = 0, index = 0;
        for (int len = 1; len < 16; ++len) {
            code |= (int)br.read(1);
            const int c = count[len];
            if (code - first < c) return symbols[index + code - first];
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        return -1;
    }
};

struct Transform {
    int kind, bits, xsize;
    std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
}

int read_code(BitReader& br, int size, Prefix& out) {
    std::vector<int> lengths(std::max(size, 256), 0);
    if (br.read(1)) {
        const int n = br.read(1) + 1;
        const int first_bits = br.read(1) ? 8 : 1;
        lengths[br.read(first_bits)] = 1;
        if (n == 2) lengths[br.read(8)] = 1;
        return out.build(lengths.data(), size) ? 0 : 11;
    }
    int cl[19] = {0};
    const int ncodes = br.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Prefix clc;
    if (!clc.build(cl, 19)) return 11;
    int max_symbol = size;
    if (br.read(1)) {
        const int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > size) return 14;
    }
    int sym = 0, prev = 8;
    while (sym < size) {
        if (max_symbol-- == 0) break;
        const int c = clc.read(br);
        if (c < 0) return 11;
        if (c < 16) {
            lengths[sym++] = c;
            if (c) prev = c;
        } else {
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            const int repeat = br.read(extra[c - 16]) + offset[c - 16];
            if (sym + repeat > size) return 14;
            const int v = c == 16 ? prev : 0;
            for (int k = 0; k < repeat; ++k) lengths[sym++] = v;
        }
    }
    if (br.over()) return 16;
    return out.build(lengths.data(), size) ? 0 : 11;
}

inline int copy_distance(int sym, BitReader& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    return ((2 + (sym & 1)) << extra) + (int)br.read(extra) + 1;
}

int decode_image(BitReader& br, int w, int h, bool level0,
                 std::vector<uint32_t>& px, std::vector<Transform>* tf);

// ExpandColorMap: each palette entry is the byte-wise sum of its delta and
// the entry before; entries past the palette are 0
void expand_palette(const std::vector<uint32_t>& pal, int size,
                    std::vector<uint32_t>& out) {
    out.assign(size, 0);
    uint8_t* o = reinterpret_cast<uint8_t*>(out.data());
    const uint8_t* p = reinterpret_cast<const uint8_t*>(pal.data());
    const int n = (int)std::min<size_t>(pal.size(), size);
    for (int i = 0; i < 4 * n; ++i)
        o[i] = (uint8_t)(p[i] + (i >= 4 ? o[i - 4] : 0));
}

int decode_image(BitReader& br, int w, int h, bool level0,
                 std::vector<uint32_t>& px, std::vector<Transform>* tf) {
    if (level0) {
        int seen = 0;
        while (br.read(1)) {
            const int kind = br.read(2);
            if (seen & (1 << kind)) return 12;
            seen |= 1 << kind;
            Transform t;
            t.kind = kind;
            t.xsize = w;
            t.bits = 0;
            if (kind == 0 || kind == 1) {
                t.bits = br.read(3) + 2;
                const int st = decode_image(br, subsample(w, t.bits),
                                            subsample(h, t.bits), false,
                                            t.data, nullptr);
                if (st) return st;
            } else if (kind == 3) {
                const int n = br.read(8) + 1;
                t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
                std::vector<uint32_t> pal;
                const int st = decode_image(br, n, 1, false, pal, nullptr);
                if (st) return st;
                expand_palette(pal, 1 << (8 >> t.bits), t.data);
                w = subsample(w, t.bits);
            }
            tf->push_back(std::move(t));
        }
    }
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = br.read(4);
        if (cache_bits < 1 || cache_bits > 11) return 13;
    }
    int meta_bits = 0, groups = 1, mw = 0;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
        meta_bits = br.read(3) + 2;
        mw = subsample(w, meta_bits);
        const int st = decode_image(br, mw, subsample(h, meta_bits), false,
                                    meta, nullptr);
        if (st) return st;
        groups = 1;
        for (uint32_t& m : meta) {
            m = (m >> 8) & 0xffff;
            groups = std::max(groups, (int)m + 1);
        }
    }
    const int alphabet[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0),
                             256, 256, 256, 40};
    std::vector<Prefix> codes(5 * groups);
    for (int g = 0; g < groups; ++g)
        for (int j = 0; j < 5; ++j) {
            const int st = read_code(br, alphabet[j], codes[5 * g + j]);
            if (st) return st;
        }
    const int64_t n = (int64_t)w * h;
    px.assign(n, 0);
    std::vector<uint32_t> cache(cache_bits ? 1 << cache_bits : 0);
    const int shift = 32 - cache_bits;
    int64_t i = 0, last = 0;
    const int cache_limit = 280 + (cache_bits ? 1 << cache_bits : 0);
    while (i < n) {
        const int x = (int)(i % w), y = (int)(i / w);
        const Prefix* g = &codes[5 * (meta_bits
            ? meta[(int64_t)(y >> meta_bits) * mw + (x >> meta_bits)] : 0)];
        const int code = g[0].read(br);
        if (code < 0) return 11;
        if (code < 256) {
            const int r = g[1].read(br), b = g[2].read(br), a = g[3].read(br);
            if (r < 0 || b < 0 || a < 0) return 11;
            px[i++] = (uint32_t)a << 24 | r << 16 | code << 8 | b;
        } else if (code < 280) {
            const int length = copy_distance(code - 256, br);
            const int dsym = g[4].read(br);
            if (dsym < 0) return 11;
            const int dcode = copy_distance(dsym, br);
            int64_t dist;
            if (dcode > 120) {
                dist = dcode - 120;
            } else {
                const int v = kCodeToPlane[dcode - 1];
                dist = std::max<int64_t>(
                    1, (int64_t)(v >> 4) * w + 8 - (v & 15));
            }
            if (br.over()) break;
            if (dist > i || length > n - i) return 15;
            for (int k = 0; k < length; ++k) px[i + k] = px[i + k - dist];
            i += length;
        } else if (code < cache_limit) {
            for (; last < i; ++last)
                cache[(0x1e35a7bdu * px[last]) >> shift] = px[last];
            px[i++] = cache[code - 280];
        } else {
            return 17;
        }
        if (br.over()) break;
        if (cache_bits)
            for (; last < i; ++last)
                cache[(0x1e35a7bdu * px[last]) >> shift] = px[last];
    }
    return br.over() ? 16 : 0;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline uint32_t avg_px(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR,
                        uint32_t TL) {
    switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg_px(avg_px(L, TR), T);
    case 6: return avg_px(L, TL);
    case 7: return avg_px(L, T);
    case 8: return avg_px(TL, T);
    case 9: return avg_px(T, TR);
    case 10: return avg_px(avg_px(L, TL), avg_px(T, TR));
    case 11: {
        int d = 0;
        for (int s = 0; s < 32; s += 8) {
            const int l = (L >> s) & 255, t = (T >> s) & 255,
                      tl = (TL >> s) & 255;
            d += std::abs(l - tl) - std::abs(t - tl);
        }
        return d <= 0 ? T : L;
    }
    case 12: {
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8)
            out |= (uint32_t)clip255((int)((L >> s) & 255) +
                                     (int)((T >> s) & 255) -
                                     (int)((TL >> s) & 255)) << s;
        return out;
    }
    case 13: {
        const uint32_t ave = avg_px(L, T);
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8) {
            const int a = (ave >> s) & 255, b = (TL >> s) & 255;
            out |= (uint32_t)clip255(a + (a - b) / 2) << s;
        }
        return out;
    }
    default: return 0xff000000u;
    }
}

void inverse(const Transform& t, std::vector<uint32_t>& px, int h) {
    const int w = t.xsize;
    if (t.kind == 2) {                 // subtract green
        for (uint32_t& p : px) {
            const uint32_t g = (p >> 8) & 255;
            p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 255) << 16) |
                (((p & 255) + g) & 255);
        }
    } else if (t.kind == 0) {          // predictor
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
            uint32_t* row = px.data() + (int64_t)y * w;
            for (int x = 0; x < w; ++x) {
                uint32_t pred;
                if (y == 0) pred = x ? row[x - 1] : 0xff000000u;
                else if (x == 0) pred = row[-w];
                else
                    pred = predict((t.data[(int64_t)(y >> t.bits) * tiles +
                                           (x >> t.bits)] >> 8) & 15,
                                   row[x - 1], row[x - w], row[x - w + 1],
                                   row[x - w - 1]);
                row[x] = add_px(row[x], pred);
            }
        }
    } else if (t.kind == 1) {          // cross colour
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                uint32_t& p = px[(int64_t)y * w + x];
                const uint32_t m = t.data[(int64_t)(y >> t.bits) * tiles +
                                          (x >> t.bits)];
                const int g2r = (int8_t)(m & 255), g2b = (int8_t)(m >> 8),
                          r2b = (int8_t)(m >> 16), g = (int8_t)(p >> 8);
                const int r = (((p >> 16) & 255) + ((g2r * g) >> 5)) & 255;
                const int b = ((p & 255) + ((g2b * g) >> 5) +
                               ((r2b * (int8_t)r) >> 5)) & 255;
                p = (p & 0xff00ff00u) | (uint32_t)r << 16 | (uint32_t)b;
            }
    } else {                           // colour indexing
        const int pw = subsample(w, t.bits), per = 1 << t.bits,
                  nbits = 8 >> t.bits, mask = (1 << nbits) - 1;
        std::vector<uint32_t> out((int64_t)w * h);
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                const int g = (px[(int64_t)y * pw + (x >> t.bits)] >> 8) & 255;
                out[(int64_t)y * w + x] =
                    t.data[(g >> (nbits * (x & (per - 1)))) & mask];
            }
        px.swap(out);
    }
}

}  // namespace

extern "C" {

// A VP8 key frame (data[0, n)) -> Y [H, W], U and V [(H + 1) / 2,
// (W + 1) / 2]; tables: webp.py TABLES (the coefficient probabilities,
// their update probabilities and the 4x4 mode probabilities). Returns 0 or
// a status code of webp.py's HELPER_ERRORS.
int64_t webp_vp8(const uint8_t* data, int64_t n, const uint8_t* tables,
                 uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
    Header h;
    int st = parse_header(data, n, tables, h);
    if (st) return st;
    std::vector<MB> mbs((size_t)h.mb_w * h.mb_h);
    parse_modes(h, tables + 2112, mbs);
    Planes P;
    P.stride[0] = 16 * h.mb_w;
    P.stride[1] = P.stride[2] = 8 * h.mb_w;
    P.p[0].assign((size_t)P.stride[0] * 16 * h.mb_h, 0);
    P.p[1].assign((size_t)P.stride[1] * 8 * h.mb_h, 0);
    P.p[2].assign((size_t)P.stride[2] * 8 * h.mb_h, 0);
    BoolReader parts[8];
    for (int p = 0; p < h.partitions; ++p)
        parts[p].init(data, h.part_start[p], h.part_end[p]);
    std::vector<uint8_t> top_nz(9 * h.mb_w, 0);
    std::vector<FilterInfo> filters(mbs.size());
    int16_t coeffs[384];
    for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
        BoolReader& br = parts[mb_y & (h.partitions - 1)];
        uint8_t left_nz[9] = {0};
        for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
            const MB& m = mbs[mb_y * h.mb_w + mb_x];
            memset(coeffs, 0, sizeof(coeffs));
            bool coded;
            if (h.use_skip && m.skip) {
                uint8_t* t = &top_nz[9 * mb_x];
                memset(t, 0, 8);
                memset(left_nz, 0, 8);
                if (!m.i4x4) t[8] = left_nz[8] = 0;
                coded = false;
            } else {
                coded = residuals(br, h, m, coeffs, top_nz.data(), left_nz,
                                  mb_x);
            }
            FilterInfo f = filter_params(h, m.segment, m.i4x4);
            f.inner = m.i4x4 || coded;
            filters[mb_y * h.mb_w + mb_x] = f;
            reconstruct(P, mb_x, mb_y, m, coeffs);
        }
    }
    bool eof = h.br.eof;
    for (int p = 0; p < h.partitions; ++p) eof |= parts[p].eof;
    if (eof) return 1;
    if (h.filter_type)
        for (int mb_y = 0; mb_y < h.mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
                const FilterInfo& f = filters[mb_y * h.mb_w + mb_x];
                if (f.limit)
                    filter_mb(P, h.filter_type == 1, mb_x, mb_y, f);
            }
    const int W = h.width, H = h.height, uw = (W + 1) / 2, uh = (H + 1) / 2;
    for (int y = 0; y < H; ++y)
        memcpy(y_out + (int64_t)y * W,
               P.p[0].data() + (int64_t)y * P.stride[0], W);
    for (int y = 0; y < uh; ++y) {
        memcpy(u_out + (int64_t)y * uw,
               P.p[1].data() + (int64_t)y * P.stride[1], uw);
        memcpy(v_out + (int64_t)y * uw,
               P.p[2].data() + (int64_t)y * P.stride[2], uw);
    }
    return 0;
}

// libwebp's fancy upsampler and VP8YUVToR/G/B: Y [H, W], U and V
// [(H + 1) / 2, (W + 1) / 2] -> RGB [H, W, 3]
void webp_yuv_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                  int64_t W, int64_t H, uint8_t* rgb) {
    const int64_t uw = (W + 1) / 2, uh = (H + 1) / 2;
    std::vector<int> ur(W), vr(W);
    // one output row from chroma rows `near` and `far`, weights 3:1
    auto upsample = [&](const uint8_t* near, const uint8_t* far, int* out) {
        out[0] = (3 * near[0] + far[0] + 2) >> 2;
        const int64_t pairs = (W - 1) >> 1;
        for (int64_t j = 1; j <= pairs; ++j) {
            const int a = near[j - 1], b = near[j], c = far[j - 1],
                      d = far[j];
            const int avg = a + b + c + d + 8;
            out[2 * j - 1] = (((avg + 2 * (b + c)) >> 3) + a) >> 1;
            out[2 * j] = (((avg + 2 * (a + d)) >> 3) + b) >> 1;
        }
        if (!(W & 1)) out[W - 1] = (3 * near[pairs] + far[pairs] + 2) >> 2;
    };
    auto clip8 = [](int v) {
        return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
    };
    std::vector<int> ut(W), vt(W);
    for (int64_t r = 0; r < H; ++r) {
        int64_t near, far;
        if (r == 0) {
            near = far = 0;
        } else if (r & 1) {            // the upper row of pair (k - 1, k)
            const int64_t k = (r + 1) / 2;
            near = k - 1;
            far = k < uh ? k : k - 1;
        } else {                       // the lower row of pair (k - 1, k)
            near = r / 2;
            far = near - 1;
        }
        upsample(u + near * uw, u + far * uw, ur.data());
        upsample(v + near * uw, v + far * uw, vr.data());
        const uint8_t* yr = y + r * W;
        uint8_t* o = rgb + r * W * 3;
        for (int64_t x = 0; x < W; ++x) {
            const int yy = (yr[x] * 19077) >> 8;
            const int uu = ur[x], vv = vr[x];
            o[3 * x] = (uint8_t)clip8(yy + ((vv * 26149) >> 8) - 14234);
            o[3 * x + 1] = (uint8_t)clip8(yy - ((uu * 6419) >> 8) -
                                          ((vv * 13320) >> 8) + 8708);
            o[3 * x + 2] = (uint8_t)clip8(yy + ((uu * 33050) >> 8) - 17685);
        }
    }
}

// A VP8L image stream from bit `start_bits` of data[0, n) (40: a VP8L
// chunk past its header; 0: an ALPH chunk's headerless stream) of
// width x height -> ARGB. Returns 0 or a status code.
int64_t webp_vp8l(const uint8_t* data, int64_t n, int64_t start_bits,
                  int64_t width, int64_t height, uint32_t* argb) {
    BitReader br(data, n, start_bits);
    std::vector<uint32_t> px;
    std::vector<Transform> tf;
    const int st = decode_image(br, (int)width, (int)height, true, px, &tf);
    if (st) return st;
    for (auto t = tf.rbegin(); t != tf.rend(); ++t)
        inverse(*t, px, (int)height);
    memcpy(argb, px.data(), sizeof(uint32_t) * width * height);
    return 0;
}

// Undoes the ALPH filter (0 none, 1 horizontal, 2 vertical, 3 gradient)
// of a [H, W] plane in place (libwebp src/dsp/filters.c)
void webp_alpha_unfilter(uint8_t* a, int64_t W, int64_t H, int64_t method) {
    if (method == 0) return;
    for (int64_t y = 0; y < H; ++y) {
        uint8_t* row = a + y * W;
        const uint8_t* prev = y ? row - W : nullptr;
        if (!prev || method == 1) {
            uint8_t pred = prev ? prev[0] : 0;
            for (int64_t x = 0; x < W; ++x)
                pred = row[x] = (uint8_t)(pred + row[x]);
        } else if (method == 2) {
            for (int64_t x = 0; x < W; ++x)
                row[x] = (uint8_t)(prev[x] + row[x]);
        } else {
            int left = prev[0], top_left = prev[0];
            for (int64_t x = 0; x < W; ++x) {
                const int top = prev[x];
                const int g = left + top - top_left;
                left = (uint8_t)(row[x] + clip255(g));
                top_left = top;
                row[x] = (uint8_t)left;
            }
        }
    }
}

}  // extern "C"
