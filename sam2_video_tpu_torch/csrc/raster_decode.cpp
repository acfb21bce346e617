// The loops of the TIFF, BMP and GIF readers that are slow in Python, host
// code for the data pipeline's image reader
// (sam2_video_tpu_torch/data/image_io.py, which keeps a numpy reference of
// each beside it): LZW with either bit order (TIFF: MSB-first with early
// change; GIF: LSB-first), PackBits, BMP RLE4 / RLE8 and TIFF's horizontal
// predictor. Built with g++ on first use and loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// LZW of symbol_bits-bit symbols (Clear = 2^bits, end = Clear + 1), codes
// of bits + 1 up to 12 bits, read LSB-first when lsb, else MSB-first; the
// width grows when the next free code reaches 2^width - early. Writes at
// most cap bytes to out. Returns the bytes written, or -1 for a code past
// the table. Each table entry is kept as the place in out where its string
// was first written (a new entry is the previous code's string and one
// more byte, which out already holds contiguously), so a code's string is
// one copy from earlier output.
int64_t lzw_decode(const uint8_t* in, int64_t n, int64_t lsb,
                   int64_t symbol_bits, int64_t early, uint8_t* out,
                   int64_t cap) {
    const int clear = 1 << symbol_bits, end = clear + 1;
    std::vector<int64_t> start(4096);
    std::vector<int32_t> length(4096, 1);
    int next = clear + 2, width = symbol_bits + 1, prev = -1;
    int64_t prev_at = 0;
    uint64_t acc = 0;
    int nacc = 0;
    int64_t pos = 0, w = 0;
    while (w < cap) {
        while (nacc < width && pos < n) {
            if (lsb) acc |= (uint64_t)in[pos] << nacc;
            else acc = (acc << 8) | in[pos];
            ++pos;
            nacc += 8;
        }
        if (nacc < width) break;
        int code;
        if (lsb) {
            code = (int)(acc & ((1u << width) - 1));
            acc >>= width;
        } else {
            code = (int)((acc >> (nacc - width)) & ((1u << width) - 1));
        }
        nacc -= width;
        if (code == clear) {
            next = clear + 2;
            width = symbol_bits + 1;
            prev = -1;
            continue;
        }
        if (code == end) break;
        if (prev < 0 && code >= clear) return -1;
        if (prev >= 0 && (code > next || (code == next && next >= 4096)))
            return -1;
        const int64_t at = w;
        if (code < clear) {
            out[w++] = (uint8_t)code;
        } else if (code < next) {
            const int64_t len = length[code], from = start[code];
            for (int64_t k = 0; k < len && w < cap; ++k)
                out[w++] = out[from + k];
        } else {                       // prev's string and its first byte
            const int64_t len = length[prev];
            for (int64_t k = 0; k < len && w < cap; ++k)
                out[w++] = out[prev_at + k];
            if (w < cap) out[w++] = out[prev_at];
        }
        if (prev >= 0 && next < 4096) {
            start[next] = prev_at;
            length[next] = length[prev] + 1;
            ++next;
        }
        prev = code;
        prev_at = at;
        if (next + early >= (1 << width) && width < 12) ++width;
    }
    return w;
}

// PackBits as libtiff's PackBitsDecode reads it: a header n >= 0 copies
// n + 1 bytes, -127..-1 repeats the next byte 1 - n times, -128 is a no-op.
// Returns the bytes written (at most cap).
int64_t packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap) {
    int64_t i = 0, w = 0;
    while (i < n && w < cap) {
        int h = (int8_t)in[i++];
        if (h >= 0) {
            for (int k = 0; k <= h && i < n; ++k, ++i)
                if (w < cap) out[w++] = in[i];
        } else if (h != -128 && i < n) {
            const uint8_t b = in[i++];
            for (int k = 0; k < 1 - h && w < cap; ++k) out[w++] = b;
        }
    }
    return w;
}

// BMP RLE8 (bits 8) or RLE4 (bits 4) from in[start] on into width x
// height palette indices in file row order (the bottom row first).
// pillow != 0: Pillow's BmpRleDecoder, which appends to one buffer: a run
// is cut at its row's end, an end of line pads the row with index 0, a
// delta reads two bytes and then (dx, dy) from the next two and pads with
// index 0, an RLE4 absolute run of n reads n / 2 bytes, absolute runs
// align to even file offsets; returns 0, or 1 when the data ends short of
// the image. Otherwise OpenCV's BmpDecoder: pixels placed at a position
// that an end of line, a delta or the end of bitmap moves (the skipped
// pixels keep index 0); returns 0, 2 for a run past its row's end (imread
// stops there) or 1 when the data ends before the end of bitmap.
int64_t bmp_rle_decode(const uint8_t* in, int64_t n, int64_t start,
                       int64_t bits, int64_t width, int64_t height,
                       int64_t pillow, uint8_t* out) {
    const int64_t size = width * height;
    std::memset(out, 0, (size_t)size);
    int64_t i = start;
    if (pillow) {
        int64_t len = 0, x = 0;
        auto push = [&](int v) {
            if (len < size) out[len] = (uint8_t)v;
            ++len;
        };
        while (len < size) {
            if (i + 2 > n) break;
            int count = in[i], byte = in[i + 1];
            i += 2;
            if (count) {
                const int64_t room = width - x > 0 ? width - x : 0;
                if (count > room) count = (int)room;
                for (int k = 0; k < count; ++k)
                    push(bits == 8 ? byte : (k & 1 ? byte & 15 : byte >> 4));
                x += count;
            } else if (byte == 0) {
                while (len % width) push(0);
                x = 0;
            } else if (byte == 1) {
                break;
            } else if (byte == 2) {
                if (i + 4 > n) return 1;
                const int64_t right = in[i + 2], up = in[i + 3];
                i += 4;
                for (int64_t k = 0; k < right + up * width; ++k) push(0);
                x = len % width;
            } else {
                const int64_t take = bits == 4 ? byte / 2 : byte;
                const int64_t got = i + take <= n ? take : n - i;
                for (int64_t k = 0; k < got; ++k) {
                    const int b = in[i + k];
                    if (bits == 4) {
                        push(b >> 4);
                        push(b & 15);
                    } else {
                        push(b);
                    }
                }
                i += got;
                if (got < take) break;
                x += byte;
                i += i & 1;
            }
        }
        return len < size ? 1 : 0;
    }
    int64_t x = 0, y = 0;
    while (y < height) {
        if (i + 2 > n) return 1;
        const int count = in[i], code = in[i + 1];
        i += 2;
        if (count) {
            if (x + count > width) return 2;
            for (int k = 0; k < count; ++k)
                out[y * width + x + k] = (uint8_t)(
                    bits == 8 ? code : (k & 1 ? code & 15 : code >> 4));
            x += count;
        } else if (code == 0) {
            x = 0;
            ++y;
        } else if (code == 1) {
            return 0;
        } else if (code == 2) {
            if (i + 2 > n) return 1;
            int64_t p = y * width + x + in[i] + in[i + 1] * width;
            i += 2;
            y = p / width;
            x = p % width;
        } else {
            const int64_t nb = bits == 8 ? code : (code + 1) / 2;
            if (x + code > width) return 2;
            if (i + nb > n) return 1;
            for (int k = 0; k < code; ++k) {
                const int b = in[i + (bits == 8 ? k : k / 2)];
                out[y * width + x + k] =
                    (uint8_t)(bits == 8 ? b : (k & 1 ? b & 15 : b >> 4));
            }
            x += code;
            i += nb + (nb & 1);
        }
    }
    return 0;
}

// TIFF's horizontal predictor (2) undone in place over rows of row_bytes
// bytes: sample_bytes-byte samples (1, 2 or 4; big-endian when big) summed
// modulo 2^(8 sample_bytes) with a stride of `stride` samples, written
// back little-endian.
void tiff_undiff(uint8_t* buf, int64_t rows, int64_t row_bytes,
                 int64_t stride, int64_t sample_bytes, int64_t big) {
    const int64_t n = row_bytes / sample_bytes;
    std::vector<uint32_t> v(n);
    for (int64_t r = 0; r < rows; ++r) {
        uint8_t* row = buf + r * row_bytes;
        for (int64_t k = 0; k < n; ++k) {
            uint32_t s = 0;
            for (int64_t b = 0; b < sample_bytes; ++b) {
                const int64_t at = big ? b : sample_bytes - 1 - b;
                s = (s << 8) | row[k * sample_bytes + at];
            }
            v[k] = s;
        }
        const uint32_t mask =
            sample_bytes == 4 ? 0xFFFFFFFFu : (1u << (8 * sample_bytes)) - 1;
        for (int64_t k = stride; k < n; ++k)
            v[k] = (v[k] + v[k - stride]) & mask;
        for (int64_t k = 0; k < n; ++k)
            for (int64_t b = 0; b < sample_bytes; ++b)
                row[k * sample_bytes + b] = (uint8_t)(v[k] >> (8 * b));
    }
}

}  // extern "C"
