// One pyramid level of forward-additive Lucas-Kanade, one warp per keypoint.
//
// Replaces the Pallas TPU kernels of kimera_vio_tpu/ops/pallas/lk_kernel.py:
// `_level_kernel` (:68, launched by `_track_level_pallas`) and
// `_level_kernel_vmem` (:332, launched by `_track_level_pallas_vmem`), and,
// with window_rule = 0, the XLA level `_track_level` of
// kimera_vio_tpu/ops/optical_flow.py that `klt_track_pallas` uses on coarse
// levels. The plain PyTorch twin is `lk_level_plain` in ops/lk_kernel.py;
// both compute the same f32 arithmetic in the same term order (built with
// -fmad=false) and differ only in the order of the window sums.
//
// Design. A keypoint's work is a chain of up to max_iter dependent
// Gauss-Newton steps over a 24x24 window, so the kernel is bound by that
// chain's latency, not by bytes or FLOPs (a 752x480 level moves ~6 MB:
// ~2 us at 3.35 TB/s; its arithmetic is a few MFLOP). One warp owns one
// keypoint: its template, gradient windows and search window are cut from
// global memory once into shared memory, each lane blends 18 of the 576
// window pixels per step, and warp shuffles reduce the two sums; every lane
// then holds the same step and the warp leaves the loop at the keypoint's
// own convergence. Blocks are one warp, so N keypoints are N independent
// blocks (no block waits for its slowest keypoint, unlike the TPU's blocks
// of 8).
//
// Plain C interface, loaded with ctypes; the launch returns cudaGetLastError.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // search-window width (the TPU lane width)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Sum over the warp, then lane 0's value to every lane, so that all lanes
// take bit-identical decisions afterwards.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// Edge-replicated read (the padding of the reference's windows).
__device__ __forceinline__ float ld(const float* __restrict__ img, int H, int W,
                                    int y, int x) {
  y = clampi(y, 0, H - 1);
  x = clampi(x, 0, W - 1);
  return __ldg(img + (size_t)y * W + x);
}

__device__ __forceinline__ float blend4(const float* __restrict__ img, int H, int W,
                                        int y, int x, float w00, float w01,
                                        float w10, float w11) {
  return w00 * ld(img, H, W, y, x) + w01 * ld(img, H, W, y, x + 1) +
         w10 * ld(img, H, W, y + 1, x) + w11 * ld(img, H, W, y + 1, x + 1);
}

__global__ void __launch_bounds__(32)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ gxi,
                const float* __restrict__ gyi, const float* __restrict__ cur,
                int H, int W, const float* __restrict__ base,
                const float* __restrict__ init, const int32_t* __restrict__ valid,
                float* __restrict__ out_pts, int32_t* __restrict__ out_ok,
                int32_t* __restrict__ out_iters, int win, int search_rows,
                int max_iter, float eps2, float min_eig_thresh, int window_rule,
                int clamp_h) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const int npx = win * win;
  float* s_t = smem;
  float* s_gx = s_t + npx;
  float* s_gy = s_gx + npx;
  float* s_S = s_gy + npx;  // search_rows x kLanes (window rule only)

  const float half = (win - 1) * 0.5f;
  const int pad = win / 2 + 2;  // the XLA level's edge padding
  const float px = base[2 * k], py = base[2 * k + 1];
  float cx = init[2 * k], cy = init[2 * k + 1];

  // ---- template origin + fractional offsets --------------------------------
  int t_ox, t_oy, sx0 = 0, sy0 = 0;
  float ftx, fty;
  bool frac_ok = true;
  if (window_rule) {
    const int TR = (win + 2 + 7) / 8 * 8;
    const int TC = (win + 3 + 31) / 32 * 32;
    t_ox = clampi((int)floorf(px - half), 0, max(W - TC, 0));
    t_oy = clampi((int)floorf(py - half), 0, max(clamp_h - TR, 0));
    ftx = px - half - (float)t_ox;
    fty = py - half - (float)t_oy;
    frac_ok = ftx >= 0.f && ftx < 1.5f && fty >= 0.f && fty < 1.5f;
    sx0 = clampi((int)floorf(cx) - kLanes / 2, 0, max(W - kLanes, 0));
    sy0 = clampi((int)floorf(cy) - search_rows / 2, 0, max(clamp_h - search_rows, 0));
  } else {
    const float x0f = (px + (float)pad) - half, y0f = (py + (float)pad) - half;
    const float x0 = floorf(x0f), y0 = floorf(y0f);
    ftx = x0f - x0;
    fty = y0f - y0;
    t_ox = clampi((int)x0, 0, W + 2 * pad - win - 1) - pad;
    t_oy = clampi((int)y0, 0, H + 2 * pad - win - 1) - pad;
  }

  // ---- template / gradient windows and the 2x2 gradient matrix -------------
  {
    const float w00 = (1.f - ftx) * (1.f - fty), w01 = ftx * (1.f - fty);
    const float w10 = (1.f - ftx) * fty, w11 = ftx * fty;
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
    for (int p = lane; p < npx; p += 32) {
      const int y = t_oy + p / win, x = t_ox + p % win;
      const float t = blend4(prev, H, W, y, x, w00, w01, w10, w11);
      const float gx = blend4(gxi, H, W, y, x, w00, w01, w10, w11);
      const float gy = blend4(gyi, H, W, y, x, w00, w01, w10, w11);
      s_t[p] = t;
      s_gx[p] = gx;
      s_gy[p] = gy;
      sxx += gx * gx;
      sxy += gx * gy;
      syy += gy * gy;
    }
    if (window_rule) {
      for (int p = lane; p < search_rows * kLanes; p += 32)
        s_S[p] = ld(cur, H, W, sy0 + p / kLanes, sx0 + p % kLanes);
    }
    __syncwarp();
    sxx = warp_sum(sxx);
    sxy = warp_sum(sxy);
    syy = warp_sum(syy);
    const float det = sxx * syy - sxy * sxy;
    const float half_tr = 0.5f * (sxx + syy);
    const float min_eig =
        (half_tr - sqrtf(fmaxf(half_tr * half_tr - det, 0.f))) / (float)(win * win);
    const bool good = (min_eig > min_eig_thresh) && valid[k] > 0 && frac_ok;
    const float safe_det = fabsf(det) > 1e-12f ? det : 1.f;
    const float inv00 = syy / safe_det, inv01 = -sxy / safe_det, inv11 = sxx / safe_det;

    // ---- Gauss-Newton iterations, exiting at this keypoint's convergence ---
    bool inb = true;
    int it = 0;
    if (good) {
      const float sxf = (float)sx0, syf = (float)sy0;
      for (; it < max_iter;) {
        float bx = 0.f, by = 0.f;
        if (window_rule) {
          const float ox = cx - half - sxf, oy = cy - half - syf;
          const int oxi = (int)floorf(ox), oyi = (int)floorf(oy);
          if (oxi < 0 || oyi < 0 || oxi > kLanes - win - 2 || oyi > search_rows - win - 2) {
            inb = false;  // left the search window: the keypoint fails here
            break;
          }
          const float fx = ox - (float)oxi, fy = oy - (float)oyi;
          for (int p = lane; p < npx; p += 32) {
            const float* r0 = s_S + (oyi + p / win) * kLanes + oxi + p % win;
            const float* r1 = r0 + kLanes;
            const float ya = (1.f - fy) * r0[0] + fy * r1[0];
            const float yb = (1.f - fy) * r0[1] + fy * r1[1];
            const float dI = ((1.f - fx) * ya + fx * yb) - s_t[p];
            bx += dI * s_gx[p];
            by += dI * s_gy[p];
          }
        } else {
          const float x0f = (cx + (float)pad) - half, y0f = (cy + (float)pad) - half;
          const float x0 = floorf(x0f), y0 = floorf(y0f);
          const float fx = x0f - x0, fy = y0f - y0;
          const int xi = clampi((int)x0, 0, W + 2 * pad - win - 1) - pad;
          const int yi = clampi((int)y0, 0, H + 2 * pad - win - 1) - pad;
          const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
          const float w10 = (1.f - fx) * fy, w11 = fx * fy;
          for (int p = lane; p < npx; p += 32) {
            const float v = blend4(cur, H, W, yi + p / win, xi + p % win, w00, w01, w10, w11);
            const float dI = v - s_t[p];
            bx += dI * s_gx[p];
            by += dI * s_gy[p];
          }
        }
        bx = warp_sum(bx);
        by = warp_sum(by);
        const float dx = -(inv00 * bx + inv01 * by);
        const float dy = -(inv01 * bx + inv11 * by);
        cx = cx + dx;
        cy = cy + dy;
        ++it;
        if (dx * dx + dy * dy < eps2) break;
      }
    }
    if (lane == 0) {
      out_pts[2 * k] = cx;
      out_pts[2 * k + 1] = cy;
      out_ok[k] = (good && inb) ? 1 : 0;
      out_iters[k] = it;
    }
  }
}

}  // namespace

extern "C" int lk_level_launch(const void* prev, const void* gx, const void* gy,
                               const void* cur, int H, int W, const void* base,
                               const void* init, const void* valid, void* out_pts,
                               void* out_ok, void* out_iters, int N, int win,
                               int search_rows, int max_iter, float eps2,
                               float min_eig_thresh, int window_rule, int clamp_h,
                               void* stream) {
  if (N <= 0) return 0;
  const size_t smem =
      sizeof(float) * (3 * (size_t)win * win + (window_rule ? (size_t)search_rows * kLanes : 0));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lk_level_kernel<<<N, 32, smem, (cudaStream_t)stream>>>(
      (const float*)prev, (const float*)gx, (const float*)gy, (const float*)cur, H, W,
      (const float*)base, (const float*)init, (const int32_t*)valid, (float*)out_pts,
      (int32_t*)out_ok, (int32_t*)out_iters, win, search_rows, max_iter, eps2,
      min_eig_thresh, window_rule, clamp_h);
  return (int)cudaGetLastError();
}

extern "C" const char* lk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
