// Fused host encoder of the delta4c consolidated staging wire for
// kimera_vio_tpu_torch/ops/frame_codec.py::encode_delta4c_planes; the
// same C interface and the same bytes out as the JAX package's
// kimera_vio_tpu/native/delta4c.cpp.
//
// The numpy form of the encode costs ~6 memory passes (np.stack of the
// frame planes, diff, compare, flatnonzero, gather, nibble pack, final
// concat into the wire buffer) on the stager thread. This encoder is ONE
// pass: it reads the original (unstacked) image planes through a pointer
// table and writes the base frame + packed nibbles DIRECTLY into the
// wire buffer at their final offsets, emitting escape
// gap-tokens (see frame_codec.py for the token semantics: token 0 =
// filler advancing 65535 positions, token g>=1 = gap to the next
// escape) into caller scratch.
//
// Built into kimera_vio_tpu_torch/_build/ at first use by
// kimera_vio_tpu_torch/native/__init__.py; frame_codec.py holds its numpy
// twin, byte-identical, for the tests.

#include <cstdint>
#include <cstring>

extern "C" {

// planes  : F * n_planes pointers, each plane_sz bytes (plane_sz even);
//           frame t's pixel stream is planes[t*n_planes .. +n_planes-1]
//           back to back (S = n_planes * plane_sz bytes per frame).
// base_out: S bytes (frame 0, copied verbatim)
// packed  : (F-1) * S / 2 bytes (two 4-bit codes per byte, low = even px)
// tok     : up to tok_cap uint16 gap tokens
// val     : up to tok_cap uint8 escape values (0 for filler tokens)
// Returns the token count, or -1 on overflow / bad args (caller falls
// back to the separate-array delta4 / raw staging).
long long delta4c_encode(const uint8_t** planes, long long n_planes,
                         long long F, long long plane_sz,
                         uint8_t* base_out, uint8_t* packed_out,
                         uint16_t* tok, uint8_t* val, long long tok_cap) {
  if (F < 2 || n_planes < 1 || plane_sz < 2 || (plane_sz & 1)) return -1;
  const long long S = n_planes * plane_sz;
  if ((F - 1) * S > 0x7fffffff00LL) return -1;
  for (long long q = 0; q < n_planes; ++q)
    std::memcpy(base_out + q * plane_sz, planes[q], (size_t)plane_sz);
  long long n_tok = 0;
  long long prev_pos = -1;  // flat index of the previous escape
  for (long long t = 1; t < F; ++t) {
    for (long long q = 0; q < n_planes; ++q) {
      const uint8_t* cur = planes[t * n_planes + q];
      const uint8_t* prv = planes[(t - 1) * n_planes + q];
      const long long flat0 = (t - 1) * S + q * plane_sz;
      uint8_t* out = packed_out + (flat0 >> 1);
      for (long long j = 0; j < plane_sz; j += 2) {
        uint8_t n0, n1;
        const uint8_t d0 = (uint8_t)(cur[j] - prv[j]);
        const uint8_t e0 = (uint8_t)(d0 + 8);
        if (e0 < 1 || e0 > 15) {
          n0 = 0;
          long long gap = flat0 + j - prev_pos;
          while (gap > 65535) {
            if (n_tok >= tok_cap) return -1;
            tok[n_tok] = 0;  // filler: +65535, no escape
            val[n_tok++] = 0;
            gap -= 65535;
          }
          if (n_tok >= tok_cap) return -1;
          tok[n_tok] = (uint16_t)gap;
          val[n_tok++] = d0;
          prev_pos = flat0 + j;
        } else {
          n0 = e0;
        }
        const uint8_t d1 = (uint8_t)(cur[j + 1] - prv[j + 1]);
        const uint8_t e1 = (uint8_t)(d1 + 8);
        if (e1 < 1 || e1 > 15) {
          n1 = 0;
          long long gap = flat0 + j + 1 - prev_pos;
          while (gap > 65535) {
            if (n_tok >= tok_cap) return -1;
            tok[n_tok] = 0;
            val[n_tok++] = 0;
            gap -= 65535;
          }
          if (n_tok >= tok_cap) return -1;
          tok[n_tok] = (uint16_t)gap;
          val[n_tok++] = d1;
          prev_pos = flat0 + j + 1;
        } else {
          n1 = e1;
        }
        out[j >> 1] = (uint8_t)(n0 | (n1 << 4));
      }
    }
  }
  return n_tok;
}

}  // extern "C"
