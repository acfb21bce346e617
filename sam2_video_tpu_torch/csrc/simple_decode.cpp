// The loops of the simple-format readers that are slow in Python, host code
// for the data pipeline's image reader
// (sam2_video_tpu_torch/data/simple_formats.py, which keeps a numpy or
// plain-Python reference of each beside it): the Sun, TGA, PCX and SGI
// run-length decoders as Pillow 12.1.0 runs them, Pillow's QOI op stream,
// Radiance HDR scanlines and RGBE to float as OpenCV 5.0.0's rgbe.cpp
// reads them, and the ASCII Netpbm tokenisers of Pillow's PpmPlainDecoder
// and OpenCV's ReadNumber. Built with g++ on first use and loaded with
// ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sun byte-encoded RLE (SunRleDecode.c) as one stream across rows: 0x80 0
// is a literal 0x80, 0x80 n v is n + 1 copies of v, any other byte itself.
// Writes at most total bytes; returns the bytes written (fewer than total
// when the data ran out).
int64_t simple_sun_rle(const uint8_t* src, int64_t n, int64_t total,
                       uint8_t* out) {
    int64_t i = 0, w = 0;
    while (w < total) {
        if (i >= n) break;
        const uint8_t b = src[i];
        if (b == 0x80) {
            if (i + 1 >= n) break;
            if (src[i + 1] == 0) {
                out[w++] = 0x80;
                i += 2;
            } else {
                if (i + 2 >= n) break;
                int64_t c = (int64_t)src[i + 1] + 1;
                if (c > total - w) c = total - w;
                memset(out + w, src[i + 2], (size_t)c);
                w += c;
                i += 3;
            }
        } else {
            out[w++] = b;
            ++i;
        }
    }
    return w;
}

// TGA RLE (TgaRleDecode.c) in rows of row bytes: a packet byte, then (bit
// 7 set) one pixel of unit bytes repeated (low 7 bits) + 1 times, or that
// many literal pixels; a literal packet may cross rows, a run may not.
// Returns the bytes written; status[0] is 0, 1 when the data ran out, 2 on
// a run past the end of its row (Pillow's overrun error).
int64_t simple_tga_rle(const uint8_t* src, int64_t n, int64_t unit,
                       int64_t row, int64_t total, uint8_t* out,
                       int64_t* status) {
    int64_t i = 0, w = 0;
    status[0] = 1;
    while (w < total) {
        if (i >= n) return w;
        const int64_t count = (src[i] & 0x7F) + 1;
        if (src[i] & 0x80) {
            if (i + 1 + unit > n) return w;
            if (w % row + unit * count > row) {
                status[0] = 2;
                return w;
            }
            for (int64_t k = 0; k < count && w < total; ++k)
                for (int64_t b = 0; b < unit && w < total; ++b)
                    out[w++] = src[i + 1 + b];
            i += 1 + unit;
        } else {
            const int64_t len = unit * count;
            if (i + 1 + len > n) return w;
            const int64_t c = len < total - w ? len : total - w;
            memcpy(out + w, src + i + 1, (size_t)c);
            w += c;
            i += 1 + len;
        }
    }
    status[0] = 0;
    return w;
}

// PCX RLE (PcxDecode.c): a byte with its two top bits set runs its low six
// bits' count of the next byte, any other byte is itself; rows of row_bytes
// into out [rows, row_bytes]. Returns 0, 1 when the data ran out, 2 when a
// run passed the end of its row (the rest of that run dropped, as Pillow
// drops it before raising its overrun error).
int64_t simple_pcx_rle(const uint8_t* src, int64_t n, int64_t row_bytes,
                       int64_t rows, uint8_t* out) {
    std::vector<uint8_t> buf((size_t)row_bytes);
    int64_t i = 0, x = 0, y = 0, status = 0;
    for (;;) {
        if (i >= n) return 1;
        const uint8_t b = src[i];
        if ((b & 0xC0) == 0xC0) {
            if (i + 1 >= n) return 1;
            for (int c = b & 0x3F; c > 0; --c) {
                if (x >= row_bytes) {
                    status = 2;
                    break;
                }
                buf[(size_t)x++] = src[i + 1];
            }
            i += 2;
        } else {
            buf[(size_t)x++] = b;
            ++i;
        }
        if (x >= row_bytes) {
            memcpy(out + y * row_bytes, buf.data(), (size_t)row_bytes);
            x = 0;
            if (++y >= rows) return status;
        }
    }
}

// SgiRleDecode.c's expandrow / expandrow2: chunks is the row's table length
// (counted down once per chunk), z the channels, end the index of the data's
// last byte. Returns -1 on an overrun, 1 when the last chunk was not a
// terminator, 0 when done.
static int sgi_expand(const uint8_t* src, int64_t s, int64_t chunks,
                      uint8_t* buf, int64_t d, int64_t z, int64_t xsize,
                      int64_t end, int64_t bpc) {
    int64_t x = 0;
    const int64_t step = z * bpc;
    for (; chunks > 0; --chunks) {
        if (s + bpc - 1 > end) return -1;
        const uint8_t pixel = src[s + bpc - 1];
        s += bpc;
        if (chunks == 1 && pixel != 0) return 1;
        int count = pixel & 0x7F;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (s + bpc * count > end) return -1;
            while (count--) {
                memcpy(buf + d, src + s, (size_t)bpc);
                s += bpc;
                d += step;
            }
        } else {
            if (s + (bpc == 1 ? 0 : 2) > end) return -1;
            while (count--) {
                memcpy(buf + d, src + s, (size_t)bpc);
                d += step;
            }
            s += bpc;
        }
    }
    return 0;
}

// SgiRleDecode.c over data (the file after its 512-byte header): big-endian
// start and length tables of bands * ysize entries, then each row's
// channels expanded into one row buffer that the rows share; out [ysize,
// xsize * bands * bpc] in table order (the bottom row first), rows not
// reached left as they are (a row's table length bounds its chunk count;
// reads are checked against the data's end). Returns 0, 1 when a row's
// chunks ran out before its terminator (Pillow stops there without an
// error), 2 on Pillow's overrun errors.
int64_t simple_sgi_rle(const uint8_t* data, int64_t n, int64_t xsize,
                       int64_t ysize, int64_t bands, int64_t bpc,
                       uint8_t* out) {
    const int64_t tablen = bands * ysize, row = xsize * bands * bpc;
    if (n < 8 * tablen) return 2;
    auto be32 = [&](int64_t at) {
        return ((int64_t)data[at] << 24) | ((int64_t)data[at + 1] << 16) |
               ((int64_t)data[at + 2] << 8) | (int64_t)data[at + 3];
    };
    std::vector<uint8_t> buf((size_t)row);
    for (int64_t r = 0; r < ysize; ++r) {
        for (int64_t ch = 0; ch < bands; ++ch) {
            int64_t off = be32(4 * (r + ch * ysize));
            const int64_t len = be32(4 * (tablen + r + ch * ysize));
            if (off < 512) return 2;
            off -= 512;
            // Pillow passes the length on as an int: past 2^31 it is
            // negative, and the row expands no chunk
            const int status = sgi_expand(data, off, (int32_t)(uint32_t)len,
                                          buf.data(), ch * bpc, bands, xsize,
                                          n - 1, bpc);
            if (status == -1) return 2;
            if (status == 1) return 1;
        }
        memcpy(out + r * row, buf.data(), (size_t)row);
    }
    return 0;
}

// Pillow's QoiDecoder: INDEX of an entry never set gives 0, 0, 0, 0; RUN
// does not enter the index; the end marker is not read. Writes at most
// pixels * bands bytes; returns the bytes written (fewer when the data ran
// out).
int64_t simple_qoi(const uint8_t* src, int64_t n, int64_t pixels,
                   int64_t bands, uint8_t* out) {
    uint8_t seen[64][4];
    bool set[64] = {false};
    uint8_t prev[4] = {0, 0, 0, 255};
    const int64_t want = pixels * bands;
    int64_t i = 0, w = 0;
    while (w < want) {
        if (i >= n) break;
        const uint8_t b = src[i++];
        uint8_t v[4];
        if (b == 0xFE) {
            if (i + 3 > n) break;
            v[0] = src[i];
            v[1] = src[i + 1];
            v[2] = src[i + 2];
            v[3] = prev[3];
            i += 3;
        } else if (b == 0xFF) {
            if (i + 4 > n) break;
            memcpy(v, src + i, 4);
            i += 4;
        } else {
            const int op = b >> 6;
            if (op == 0) {
                if (set[b & 63]) memcpy(v, seen[b & 63], 4);
                else memset(v, 0, 4);
            } else if (op == 1) {
                v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
                v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
                v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
                v[3] = prev[3];
            } else if (op == 2) {
                if (i >= n) break;
                const uint8_t b2 = src[i++];
                const int dg = (b & 63) - 32;
                v[0] = (uint8_t)(prev[0] + dg + (b2 >> 4) - 8);
                v[1] = (uint8_t)(prev[1] + dg);
                v[2] = (uint8_t)(prev[2] + dg + (b2 & 15) - 8);
                v[3] = prev[3];
            } else {
                for (int r = (b & 63) + 1; r > 0 && w < want; --r)
                    for (int64_t c = 0; c < bands && w < want; ++c)
                        out[w++] = prev[c];
                continue;
            }
        }
        memcpy(prev, v, 4);
        const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        memcpy(seen[h], v, 4);
        set[h] = true;
        for (int64_t c = 0; c < bands && w < want; ++c) out[w++] = v[c];
    }
    return w;
}

// rgbe.cpp's rgbe2float into R, G, B.
static void rgbe_float(const uint8_t* q, float* o) {
    if (q[3]) {
        const float f = (float)std::ldexp(1.0, (int)q[3] - 136);
        o[0] = q[0] * f;
        o[1] = q[1] * f;
        o[2] = q[2] * f;
    } else {
        o[0] = o[1] = o[2] = 0.0f;
    }
}

// rgbe.cpp's RGBE_ReadPixels_RLE into out [height, width, 3] (R, G, B):
// flat pixels when the width is under 8 or past 0x7fff, or from the first
// pixel that is not a new-style scanline header on; else each scanline's
// four channels run-length coded. Returns 0, 1 when the data ran out, 2 on
// a bad scanline.
int64_t simple_hdr(const uint8_t* src, int64_t n, int64_t width,
                   int64_t height, float* out) {
    int64_t pos = 0, done = 0;
    const int64_t total = width * height;
    auto flat = [&](int64_t count) -> int64_t {
        for (; count > 0; --count) {
            if (pos + 4 > n) return 1;
            rgbe_float(src + pos, out + 3 * done);
            pos += 4;
            ++done;
        }
        return 0;
    };
    if (width < 8 || width > 0x7FFF) return flat(total);
    std::vector<uint8_t> line((size_t)(4 * width));
    for (int64_t y = 0; y < height; ++y) {
        if (pos + 4 > n) return 1;
        const uint8_t* r = src + pos;
        if (r[0] != 2 || r[1] != 2 || (r[2] & 0x80)) return flat(total - done);
        if (((int64_t)r[2] << 8 | r[3]) != width) return 2;
        pos += 4;
        int64_t p = 0;
        for (int ch = 0; ch < 4; ++ch) {
            const int64_t stop = (ch + 1) * width;
            while (p < stop) {
                if (pos + 2 > n) return 1;
                int64_t c = src[pos];
                const uint8_t v = src[pos + 1];
                pos += 2;
                if (c > 128) {
                    c -= 128;
                    if (c == 0 || c > stop - p) return 2;
                    memset(line.data() + p, v, (size_t)c);
                    p += c;
                } else {
                    if (c == 0 || c > stop - p) return 2;
                    line[(size_t)p++] = v;
                    if (c > 1) {
                        if (pos + c - 1 > n) return 1;
                        memcpy(line.data() + p, src + pos, (size_t)(c - 1));
                        p += c - 1;
                        pos += c - 1;
                    }
                }
            }
        }
        for (int64_t x = 0; x < width; ++x) {
            const uint8_t q[4] = {line[(size_t)x], line[(size_t)(width + x)],
                                  line[(size_t)(2 * width + x)],
                                  line[(size_t)(3 * width + x)]};
            rgbe_float(q, out + 3 * done);
            ++done;
        }
    }
    return 0;
}

static bool is_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == 0x0B || c == 0x0C ||
           c == '\r';
}

// Pillow's PpmPlainDecoder: comments (from # through the next CR or LF)
// removed, then (bitonal, P1) each other non-whitespace byte a value that
// must be 0 or 1 (checked over each 1 MiB block read), or whitespace-
// separated tokens of at most 10 characters, each a decimal value at most
// maxval. Writes up to count values; status[0] is 0, 1 when the values ran
// out, 2 on a token Pillow refuses, or -1 on a token that is not plain
// digits (for the caller's reference, which parses as Python's int does).
// Returns the values written.
int64_t simple_pnm_pillow(const uint8_t* src, int64_t n, int64_t count,
                          int64_t maxval, int64_t bitonal, int64_t* out,
                          int64_t* status) {
    int64_t got = 0;
    bool comment = false;
    status[0] = 1;
    if (bitonal) {
        const int64_t block = 1 << 20;
        for (int64_t k = 0; k < n; k += block) {
            const int64_t stop = k + block < n ? k + block : n;
            for (int64_t i = k; i < stop; ++i) {
                const uint8_t c = src[i];
                if (comment) {
                    if (c == '\n' || c == '\r') comment = false;
                    continue;
                }
                if (c == '#') {
                    comment = true;
                    continue;
                }
                if (is_ws(c)) continue;
                if (c != '0' && c != '1') {
                    status[0] = 2;
                    return got;
                }
                if (got < count) out[got++] = c - '0';
            }
            if (got >= count) {
                status[0] = 0;
                return got;
            }
        }
        return got;
    }
    int64_t len = 0, v = 0;
    bool digits = true;
    // a token ends at whitespace or at the end of the data; a comment
    // inside a token joins its two halves, as Pillow removes the comment
    // before it splits
    auto flush = [&]() -> bool {
        if (len) {
            if (len > 10 || (digits && v > maxval)) {
                status[0] = 2;
                return false;
            }
            if (!digits) {
                status[0] = -1;
                return false;
            }
            out[got++] = v;
        }
        len = v = 0;
        digits = true;
        return true;
    };
    for (int64_t i = 0; i < n && got < count; ++i) {
        const uint8_t c = src[i];
        if (comment) {
            if (c == '\n' || c == '\r') comment = false;
            continue;
        }
        if (c == '#') {
            comment = true;
        } else if (is_ws(c)) {
            if (!flush()) return got;
        } else {
            ++len;
            if (c >= '0' && c <= '9') {
                if (len <= 10) v = v * 10 + (c - '0');
            } else {
                digits = false;
            }
        }
    }
    if (got < count && !flush()) return got;
    if (got == count) status[0] = 0;
    return got;
}

// OpenCV's ReadNumber count times (grfmt_pxm.cpp): whitespace and #
// comments (to CR or LF) skipped, any other non-digit an error; digits up
// to maxdigits (0: all), then one byte read past them, which must exist; a
// value past INT_MAX an error. Returns the values read before the first
// error.
int64_t simple_pnm_opencv(const uint8_t* src, int64_t n, int64_t count,
                          int64_t maxdigits, int64_t* out) {
    int64_t pos = 0;
    for (int64_t k = 0; k < count; ++k) {
        if (pos >= n) return k;
        int c = src[pos++];
        while (!(c >= '0' && c <= '9')) {
            if (c == '#') {
                do {
                    if (pos >= n) return k;
                    c = src[pos++];
                } while (c != '\n' && c != '\r');
                if (pos >= n) return k;
                c = src[pos++];
            } else if (is_ws((uint8_t)c)) {
                while (is_ws((uint8_t)c)) {
                    if (pos >= n) return k;
                    c = src[pos++];
                }
            } else {
                return k;
            }
        }
        int64_t v = 0, digits = 0;
        for (;;) {
            v = v * 10 + (c - '0');
            if (v > 2147483647) return k;
            ++digits;
            if (maxdigits && digits >= maxdigits) break;
            if (pos >= n) return k;
            c = src[pos++];
            if (!(c >= '0' && c <= '9')) break;
        }
        out[k] = v;
    }
    return count;
}

}  // extern "C"
