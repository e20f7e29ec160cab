// Host encoder of the temporal-delta 4-bit staging codec (delta4) for
// kimera_vio_tpu_torch/ops/frame_codec.py::encode_delta4; the same C
// interface and the same bytes out as the JAX package's
// kimera_vio_tpu/native/delta4.cpp.
//
// The encoder runs on the stager thread of run_chunked, so it must move
// at memory speed: one fused pass (numpy needs ~6: diff, compare, where,
// flatnonzero, gather, pack) over uint8 data with wraparound (mod-256)
// arithmetic, called through ctypes, which releases the GIL.
//
// Nibble 0 = escape, nibbles 1..15 encode (d8 + 8) & 0xF for true deltas
// in [-7, 7]; escapes ship (flat index, d8) pairs. See ops/frame_codec.py
// for the wire format, the numpy twin and the device decoder.
//
// Built into kimera_vio_tpu_torch/_build/ at first use by
// kimera_vio_tpu_torch/native/__init__.py.

#include <cstdint>

extern "C" {

// frames: F*S bytes, S even. Outputs:
//   packed  : (F-1)*S/2 bytes (two nibbles per byte, low = even pixel)
//   esc_idx : up to esc_cap int32 flat indices into the (F-1)*S deltas
//   esc_val : up to esc_cap uint8 wraparound deltas
// Returns the escape count, or -1 when it would exceed esc_cap
// (caller falls back to raw staging).
long long delta4_encode(const uint8_t* frames, long long F, long long S,
                        uint8_t* packed, int32_t* esc_idx, uint8_t* esc_val,
                        long long esc_cap) {
  if (F < 2 || S <= 0 || (S & 1) || (F - 1) * S > 0x7fffffffLL) return -1;
  long long n_esc = 0;
  const uint8_t* prev = frames;
  const uint8_t* cur = frames + S;
  for (long long t = 1; t < F; ++t) {
    const long long base = (t - 1) * S;
    uint8_t* out = packed + (base >> 1);
    for (long long j = 0; j < S; j += 2) {
      const uint8_t d0 = (uint8_t)(cur[j] - prev[j]);
      const uint8_t e0 = (uint8_t)(d0 + 8);
      uint8_t n0 = e0;
      if (e0 < 1 || e0 > 15) {
        n0 = 0;
        if (n_esc >= esc_cap) return -1;
        esc_idx[n_esc] = (int32_t)(base + j);
        esc_val[n_esc] = d0;
        ++n_esc;
      }
      const uint8_t d1 = (uint8_t)(cur[j + 1] - prev[j + 1]);
      const uint8_t e1 = (uint8_t)(d1 + 8);
      uint8_t n1 = e1;
      if (e1 < 1 || e1 > 15) {
        n1 = 0;
        if (n_esc >= esc_cap) return -1;
        esc_idx[n_esc] = (int32_t)(base + j + 1);
        esc_val[n_esc] = d1;
        ++n_esc;
      }
      out[j >> 1] = (uint8_t)(n0 | (n1 << 4));
    }
    prev = cur;
    cur += S;
  }
  return n_esc;
}

}  // extern "C"
