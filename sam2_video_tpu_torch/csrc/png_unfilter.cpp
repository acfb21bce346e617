// PNG row unfiltering (the five filter types of the PNG spec, section 9),
// host code for the data pipeline's image reader
// (sam2_video_tpu_torch/data/image_io.py). Sub and Up vectorise in numpy;
// Average and Paeth depend on the byte just reconstructed to the left, so
// they run here, one pass over the rows. Built with g++ on first use and
// loaded with ctypes; image_io.py keeps the numpy version beside it.

#include <cstdint>
#include <cstdlib>

extern "C" {

// in: height rows of 1 filter byte + stride data bytes. out: height x
// stride reconstructed bytes. bpp: bytes per complete pixel (at least 1).
// Returns 0, or 1 + the row index of an unknown filter type.
int64_t png_unfilter(const uint8_t* in, int64_t height, int64_t stride,
                     int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* src = in + y * (stride + 1);
        const uint8_t filter = src[0];
        ++src;
        uint8_t* row = out + y * stride;
        const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
        switch (filter) {
        case 0:
            for (int64_t x = 0; x < stride; ++x) row[x] = src[x];
            break;
        case 1:
            for (int64_t x = 0; x < stride; ++x)
                row[x] = (uint8_t)(src[x] + (x >= bpp ? row[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < stride; ++x)
                row[x] = (uint8_t)(src[x] + (prev ? prev[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? row[x - bpp] : 0;
                const int b = prev ? prev[x] : 0;
                row[x] = (uint8_t)(src[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < stride; ++x) {
                const int a = x >= bpp ? row[x - bpp] : 0;
                const int b = prev ? prev[x] : 0;
                const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                const int p = a + b - c;
                const int pa = std::abs(p - a), pb = std::abs(p - b),
                          pc = std::abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a
                                 : (pb <= pc ? b : c);
                row[x] = (uint8_t)(src[x] + pred);
            }
            break;
        default:
            return 1 + y;
        }
    }
    return 0;
}

}  // extern "C"
