// Host encoder of the 3-tier temporal-delta staging codec (delta3) for
// kimera_vio_tpu_torch/ops/frame_codec.py (encode_delta3; decode_delta3
// on the device); the same C interface and the same bytes out as the JAX
// package's kimera_vio_tpu/native/delta3.cpp.
//
// Tier 1: 3-bit codes. code 0 = escape to tier 2; codes 1..7 encode
//         d in [-3, 3] as code = d + 4.
// Tier 2: 4-bit codes for tier-1 escapes in pixel scan order, two per
//         byte (low nibble first). code 0 = escape to tier 3; codes
//         1..7 encode d in [4, 10] as code = d - 3; codes 8..15 encode
//         d in [-11, -4] as code = 4 - d.
// Tier 3: raw wraparound deltas (d8 = (cur - prev) mod 256) for tier-2
//         escapes, one byte each, in scan order.
//
// PLANAR tier-1 layout (the JAX package's wire, shaped by a TPU layout
// constraint and kept so that the two packages' wires are the same
// bytes): with n_grp = ceil(N / 8) 24-bit group words, pixel p's code
// lives in group g = p % n_grp at bit 3 * (p / n_grp), and the wire
// ships the three BYTE PLANES of the group words back to back:
//   t1[0 .. n_grp)          = w & 0xFF
//   t1[n_grp .. 2 n_grp)    = (w >> 8) & 0xFF
//   t1[2 n_grp .. 3 n_grp)  = (w >> 16) & 0xFF
// so the device unpack is pure contiguous slices + shifts + concat.
//
// Positions are IMPLICIT at every tier (an escape's payload index is
// the running count of escapes before it), so an escape costs 1 wire
// byte, not the 5 bytes (int32 index + value) of the delta4 codec.
// The device decoder recovers positions with prefix sums.
//
// Built into kimera_vio_tpu_torch/_build/ at first use by
// kimera_vio_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// frames: F*S bytes. Outputs:
//   t1 : 3 * ceil((F-1)*S / 8) bytes (three byte planes, see above)
//   t2 : up to ceil(t2_cap_nib / 2) bytes (two 4-bit codes per byte)
//   t3 : up to t3_cap bytes
//   n_out[0] = tier-2 code count (nibbles), n_out[1] = tier-3 byte count
// Returns 0, or -1 when a tier would exceed its capacity (caller falls
// back to delta4 / raw staging).
long long delta3_encode(const uint8_t* frames, long long F, long long S,
                        uint8_t* t1, uint8_t* t2, long long t2_cap_nib,
                        uint8_t* t3, long long t3_cap,
                        long long* n_out) {
  if (F < 2 || S <= 0 || (F - 1) * S > 0x7fffffff00LL) return -1;
  const long long N = (F - 1) * S;
  const long long n_grp = (N + 7) / 8;
  uint32_t* w = (uint32_t*)calloc((size_t)n_grp, sizeof(uint32_t));
  if (!w) return -1;
  long long n2 = 0;  // tier-2 nibble count
  long long n3 = 0;  // tier-3 byte count
  uint8_t pend2 = 0; // pending low nibble of the current t2 byte
  const uint8_t* prev = frames;
  const uint8_t* cur = frames + S;
  long long jj = 0;   // pixel within the current frame pair
  long long gg = 0;   // group index (wraps at n_grp)
  int sh = 0;         // 3 * plane index
  for (long long p = 0; p < N; ++p) {
    const uint8_t d8 = (uint8_t)(cur[jj] - prev[jj]);
    const int ds = (int)(int8_t)d8;
    if (ds >= -3 && ds <= 3) {
      w[gg] |= (uint32_t)(ds + 4) << sh;
    } else {
      // tier-1 escape: code 0 == leave the group bits zero
      uint8_t c2;
      if (ds >= 4 && ds <= 10) {
        c2 = (uint8_t)(ds - 3);
      } else if (ds >= -11 && ds <= -4) {
        c2 = (uint8_t)(4 - ds);
      } else {
        c2 = 0;
        if (n3 >= t3_cap) { free(w); return -1; }
        t3[n3++] = d8;
      }
      if (n2 >= t2_cap_nib) { free(w); return -1; }
      if (n2 & 1) {
        t2[n2 >> 1] = (uint8_t)(pend2 | (c2 << 4));
      } else {
        pend2 = c2;
        t2[n2 >> 1] = c2;  // low nibble now, high filled by the pair
      }
      ++n2;
    }
    if (++jj == S) {
      jj = 0;
      prev = cur;
      cur += S;
    }
    if (++gg == n_grp) {
      gg = 0;
      sh += 3;
    }
  }
  // Emit the three byte planes.
  for (long long g = 0; g < n_grp; ++g) t1[g] = (uint8_t)(w[g] & 0xFF);
  for (long long g = 0; g < n_grp; ++g)
    t1[n_grp + g] = (uint8_t)((w[g] >> 8) & 0xFF);
  for (long long g = 0; g < n_grp; ++g)
    t1[2 * n_grp + g] = (uint8_t)((w[g] >> 16) & 0xFF);
  free(w);
  n_out[0] = n2;
  n_out[1] = n3;
  return 0;
}

}  // extern "C"
