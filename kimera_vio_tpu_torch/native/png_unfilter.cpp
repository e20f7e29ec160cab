// Undo the PNG row filters of a one-channel, non-interlaced image of 8 or
// 16 bits a sample (PNG specification, section 9: None, Sub, Up, Average,
// Paeth), for kimera_vio_tpu_torch/dataprovider/png.py. The filters work
// on bytes, each against the byte one pixel (bpp bytes) to its left; the
// Average and Paeth filters depend on the byte just decoded there, so a
// row is a serial chain that numpy cannot vectorise; this loop is that
// chain. png.py::unfilter_plain is its plain version.
//
// Built into kimera_vio_tpu_torch/_build/ at first use by
// kimera_vio_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw : H rows of (1 + W) bytes, each a filter-type byte then W filtered
//       bytes (the inflated IDAT stream); W counts bytes, not pixels.
// out : H * W bytes.
// bpp : bytes per pixel (1 for 8-bit gray, 2 for 16-bit gray, 3 for 8-bit RGB).
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0..4.
long long png_unfilter(const uint8_t* raw, uint8_t* out, long long H,
                       long long W, long long bpp) {
  for (long long y = 0; y < H; ++y) {
    const uint8_t ft = raw[y * (W + 1)];
    const uint8_t* src = raw + y * (W + 1) + 1;
    uint8_t* row = out + y * W;
    const uint8_t* up = y > 0 ? out + (y - 1) * W : nullptr;
    switch (ft) {
      case 0:
        for (long long x = 0; x < W; ++x) row[x] = src[x];
        break;
      case 1:
        for (long long x = 0; x < W; ++x)
          row[x] = (uint8_t)(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:
        for (long long x = 0; x < W; ++x)
          row[x] = (uint8_t)(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (long long x = 0; x < W; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long long x = 0; x < W; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (x >= bpp && up) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[x] = (uint8_t)(src[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
