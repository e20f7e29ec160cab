// Pyramidal forward-additive Lucas-Kanade: one launch tracks one frame of
// each of B streams, every pyramid level coarse to fine; one multi-warp
// block per keypoint and stream (grid N x B), or over 54 px one
// thread-block cluster (design note 6). The JAX package's default tracker
// (lk_impl="matmul": a per-keyframe template cache, one search patch a
// level) is two more kernels with their own notes below: `lk_cached_kernel`
// tracks a frame against the cache (one warp a keypoint at the main path's
// widths, `lk_cached_warp_kernel`), `lk_cache_build_kernel` builds the
// cache at a keyframe.
//
// Replaces, in one kernel:
//   * kimera_vio_tpu/ops/pallas/lk_kernel.py:_level_kernel_vmem (:332,
//     launched by _track_level_pallas_vmem, pallas_call :626): the level
//     resident in VMEM, window origins clamped to the 8-row padded height;
//   * kimera_vio_tpu/ops/pallas/lk_kernel.py:_level_kernel (:68, launched
//     by _track_level_pallas, pallas_call :309): windows gathered by XLA,
//     origins clamped to the true height;
//   * kimera_vio_tpu/ops/optical_flow.py:_track_level (:92): the XLA level
//     (edge-replicated windows, no search window) that
//     klt_track_pallas (:649) runs on levels too small for the search window;
//   * and klt_track_pallas's coarse-to-fine loop itself: the level plan is a
//     table passed by value (`Table`, built on the host by
//     ops/lk_kernel.py:level_table), so a frame is one launch, not one per
//     level.
// The plain PyTorch version is `track_pyramid(lk_level_plain, ...)` in
// ops/lk_kernel.py. Both compute the same float32 arithmetic in the same term
// order (built with -fmad=false); only the order of the window sums differs.
//
// What bounds it on this card. A keypoint's work is a serial chain: stage
// its windows, blend the template, reduce the 2x2 gradient matrix, then up
// to max_iter dependent Gauss-Newton steps, each a 24x24 resample and two
// sums, on every level in turn. A frame moves ~8 MB (a few us at 3.35 TB/s)
// and does a few MFLOP, so neither bytes nor FLOPs bound it: the latency of
// that chain does, and the frame waits for its slowest keypoint.
//
// What the design does about it.
//   1. One launch per frame: the keypoint walks every level in one block
//      with its point in registers; no launch gaps, no host work between
//      levels, and the frame pays the worst keypoint's whole chain once
//      instead of the sum over levels of each level's worst keypoint.
//   2. kThreads = 192 threads (6 warps) own a keypoint, so each thread
//      blends 3 of the 576 window pixels per step (against 18 for the one
//      warp of a per-level kernel); its template and gradient pixels
//      live in registers. A step's two sums (and the setup's three) are
//      reduced together: interleaved xor-butterfly shuffles (every lane ends
//      with bit-identical sums), one partial per warp to shared memory,
//      one barrier, and every thread adds the partials in the same order,
//      so all threads take the same exit decision. The partials are
//      double-buffered, so one barrier per step suffices.
//   3. Loads are asynchronous and issued all at once: cp.async (4 bytes,
//      from clamped source addresses, which gives the reference's edge
//      replication) stages the 56x128 search window of a level -- or, at an
//      XLA level that fits, the whole current plane -- while the template is
//      blended from the tiles staged earlier; the next level's raw template
//      and gradient tiles (they depend only on the keypoint's position in the
//      previous frame, known at launch) are prefetched into a second buffer
//      while the current level iterates. Search-window rows are padded to a
//      stride congruent to the window width mod 32, so a warp's 32
//      consecutive window pixels fall in 32 distinct banks.
//   4. win and search_rows are template parameters (<24, 56> for the main
//      path), so the pixel loops unroll and divide by constants. Two
//      generic instantiations take runtime sizes: <0, 0, kMaxWin> for
//      windows up to 32 px and <0, 0, kMaxWinWide> for 33-54 px. The third
//      parameter sizes each thread's pixel arrays (6 pixels a thread up to
//      32 px, 16 up to 54), so the wide one costs the narrower windows
//      nothing. 54 px is the widest window the Pallas tracker admits: its
//      search-window clip search_rows - win - 2 must stay >= 0 at its 56
//      rows (pallas/lk_kernel.py:177-181).
//   5. A stream axis: B independent streams (a fleet of robots sharing one
//      rig) are tracked in the same launch. blockIdx.y picks the stream: it
//      offsets the four planes of every level by the level's stride between
//      streams' planes, and the keypoint and output indices by N. One stream
//      is B = 1 of the same kernel.
//   6. Windows wider than 54 px take the gather rule only (every level an
//      XLA level, as the JAX package's default tracker runs them), in a
//      kernel of their own, `lk_wide_kernel`: one thread-block cluster of C
//      blocks per keypoint and stream (grid C*N x B, cluster C x 1 x 1).
//      One block cannot hold such a keypoint: at 101 px its template and
//      gradients alone take 122 KB, so one block would fill an SM, and its
//      192 threads would blend 53 pixels each on every step. Block `rank`
//      of the cluster owns a band of band_rows window rows: it blends its
//      band's template and gradients into its own shared memory once per
//      level, and on every step resamples only its band of `cur`. A thread
//      takes kRun horizontally adjacent pixels of one band row at a time:
//      it loads their 2 (kRun + 1) edge-clamped `cur` neighbours once and
//      blends each pixel from registers, in the plain version's term order
//      (so each pixel's value is unchanged); a run's template and gradients
//      are one float4 each, read again only by the thread that blended
//      them. A step's two sums (the setup's three) cross the cluster once:
//      each warp's lanes 0..C-1 send its butterfly-reduced partial into its
//      own slot of every block of the cluster (distributed shared memory,
//      st.async), each store counted on the receiving block's mbarrier;
//      a block waits only for its own slots to fill, then every thread adds
//      all C x warps slots in the same order, so every block holds the same
//      bits and takes the same exit decision. On an H100 that is a quarter
//      faster than a barrier.cluster a step (scripts/lk_kernel_ab.py). The
//      slots are double-buffered (`cluster_sum`).
//      The launch plan (C, threads, band rows, shared memory) is a pure
//      function of the window and the card's opt-in shared memory
//      (`plan_wide`; its Python twin is ops/lk_kernel.py:wide_plan): the
//      fewest waves of a 256-keypoint frame, then the fewest runs a
//      thread. Where no band fits in shared memory even at C = 8, the
//      template is blended again from the level planes on every step
//      (the global route). A cluster the card cannot hold
//      (cudaOccupancyMaxActiveClusters) or a refused launch returns an
//      error; there is no other route. lk_pyramid_launch reports the plan.
// TMA does not fit: level rows (94, 47, 311, 621, 1241 floats...) are not
// multiples of 16 bytes, and its out-of-bounds fill is zeros, not the edge
// replication the reference uses. Tensor cores have nothing to do: a step is
// two 576-long dot products over a freshly resampled window.
//
// Plain C interface, loaded with ctypes; the launch returns cudaGetLastError.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;     // search-window width (the TPU lane width)
constexpr int kMaxLevels = 8;
constexpr int kMaxWin = 32;     // largest window of the narrow generic instantiation
constexpr int kMaxWinWide = 54; // largest window of the wide one, and of the window rule
// Threads per block (one block per keypoint). Of 96, 192 and 288, which
// split a 24x24 window evenly, 192 was the fastest on an H100.
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// lk_wide_kernel (design note 6) and its launch plan, `plan_wide`. The
// plan's Python twin (ops/lk_kernel.py:wide_plan) reads the same values; a
// CPU test parses them from this file.
constexpr int kRun = 4;  // adjacent pixels a thread blends at a time: one float4 per plane
static_assert(kRun == 4, "lk_wide_kernel keeps a run's pixels of each plane in one float4");
constexpr int kWideClusters[] = {1, 2, 4, 8};     // the portable cluster sizes
constexpr int kWideThreads[] = {128, 256, 512};   // threads per block
constexpr int kWideMaxThreads = 512;
constexpr int kWideMinBlocks = 2;  // launch bounds: ptxas keeps the kernel within kWideRegs
constexpr int kWideRegs = 65536 / (kWideMaxThreads * kWideMinBlocks) / 8 * 8;
constexpr int kWideKeypoints = 256;  // keypoints a frame at the configured max_features
constexpr int kSms = 132;            // an H100 SXM's SMs
constexpr int kSmThreads = 2048, kSmBlocks = 32, kSmRegs = 65536;
constexpr int kBlockSmemReserve = 1024;  // shared memory an SM reserves for each block

enum Mode : int { kSkip = 0, kXla = 1, kVmem = 2, kGather = 3 };

struct Level {
  const float* prev;
  const float* gx;
  const float* gy;
  const float* cur;
  long long stride;  // elements between one stream's planes and the next's
  int H, W, mode, clamp_h;
  float scale;   // the point and its base are multiplied by this first
  int keep_ok;   // this level's ok is and-ed into the result
};

struct Table {
  Level lv[kMaxLevels];  // coarse to fine: entry e is level n - 1 - e
  int n;
  int H0, W0;            // level 0, for the final in-image gate
  int win, search_rows, max_iter;
  float eps2, min_eig_thresh;
  int stage_floats;      // floats of the staging buffer
  int tmpl_smem;         // lk_wide: the template and gradients in shared memory
  int band_rows;         // lk_wide: window rows of each block of a cluster
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum K values over the block. Every thread returns the same bits: the
// butterfly leaves identical sums in every lane, and every thread adds the
// warps' partials in the same order. `part` holds two buffers of one float4
// per warp; alternating them makes one barrier enough.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float4* part, int& parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
  float4* buf = part + parity * kWarps;
  if ((threadIdx.x & 31) == 0) {
    float4 t = make_float4(v[0], 0.f, 0.f, 0.f);
    if constexpr (K > 1) t.y = v[1];
    if constexpr (K > 2) t.z = v[2];
    buf[threadIdx.x >> 5] = t;
  }
  __syncthreads();
  float4 s = buf[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 t = buf[w];
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
  }
  v[0] = s.x;
  if constexpr (K > 1) v[1] = s.y;
  if constexpr (K > 2) v[2] = s.z;
  parity ^= 1;
}

// Origin of the (win+1)^2 raw template tile and the blend fractions at
// base point (px, py): the window rule's clamp (Pallas kernels) or the XLA
// level's edge-padded origin.
__device__ __forceinline__ void tile_origin(const Level& L, int win, float px, float py,
                                            int& t_ox, int& t_oy, float& ftx, float& fty,
                                            bool& frac_ok) {
  const float half = (win - 1) * 0.5f;
  if (L.mode != kXla) {
    const int TR = (win + 2 + 7) / 8 * 8;
    const int TC = (win + 3 + 31) / 32 * 32;
    t_ox = clampi((int)floorf(px - half), 0, max(L.W - TC, 0));
    t_oy = clampi((int)floorf(py - half), 0, max(L.clamp_h - TR, 0));
    ftx = px - half - (float)t_ox;
    fty = py - half - (float)t_oy;
    frac_ok = ftx >= 0.f && ftx < 1.5f && fty >= 0.f && fty < 1.5f;
  } else {
    const int pad = win / 2 + 2;
    const float x0f = (px + (float)pad) - half, y0f = (py + (float)pad) - half;
    const float x0 = floorf(x0f), y0 = floorf(y0f);
    ftx = x0f - x0;
    fty = y0f - y0;
    t_ox = clampi((int)x0, 0, L.W + 2 * pad - win - 1) - pad;
    t_oy = clampi((int)y0, 0, L.H + 2 * pad - win - 1) - pad;
    frac_ok = true;
  }
}

// Issue the cp.async copies of a level's raw prev / gx / gy tiles (edge-
// clamped) into dst (3 planes of (win+1)^2 floats); `off` is the stream's
// plane offset.
__device__ __forceinline__ void stage_tiles(float* dst, const Level& L, size_t off, int win,
                                            float px, float py) {
  int t_ox, t_oy;
  float ftx, fty;
  bool frac_ok;
  tile_origin(L, win, px, py, t_ox, t_oy, ftx, fty, frac_ok);
  const int tw = win + 1, t2 = tw * tw;
  for (int i = threadIdx.x; i < 3 * t2; i += kThreads) {
    const int q = i / t2, rem = i - q * t2;
    const int r = rem / tw, c = rem - r * tw;
    const float* plane = (q == 0 ? L.prev : (q == 1 ? L.gx : L.gy)) + off;
    cp_async4(dst + i, plane + (size_t)clampi(t_oy + r, 0, L.H - 1) * L.W +
                           clampi(t_ox + c, 0, L.W - 1));
  }
}

__device__ __forceinline__ int next_active(const Table& tab, int e) {
  while (e < tab.n && tab.lv[e].mode == kSkip) ++e;
  return e;
}

// The kRun pixels of one window row starting at window column c0, sampled
// at integer origin (ox, oy) of an (H, W) plane with weights w..: pixel m
// is the bilinear blend of its edge-clamped 2x2 neighbourhood in the plain
// version's term order; neighbouring pixels share their loads, and a run
// inside the plane's columns needs no clamp.
__device__ __forceinline__ void blend_run(const float* P, int H, int W, int ox, int oy, int row,
                                          int c0, float w00, float w01, float w10, float w11,
                                          float (&v)[kRun]) {
  const float* ra = P + (size_t)clampi(oy + row, 0, H - 1) * W;
  const float* rb = P + (size_t)clampi(oy + row + 1, 0, H - 1) * W;
  const int x0 = ox + c0;
  float a[kRun + 1], b[kRun + 1];
  if (x0 >= 0 && x0 + kRun < W) {
#pragma unroll
    for (int m = 0; m <= kRun; ++m) {
      a[m] = ra[x0 + m];
      b[m] = rb[x0 + m];
    }
  } else {
#pragma unroll
    for (int m = 0; m <= kRun; ++m) {
      const int x = clampi(x0 + m, 0, W - 1);
      a[m] = ra[x];
      b[m] = rb[x];
    }
  }
#pragma unroll
  for (int m = 0; m < kRun; ++m) v[m] = w00 * a[m] + w01 * a[m + 1] + w10 * b[m] + w11 * b[m + 1];
}

// Zero the gradients of a run's pixels from column `left` on (past the
// window's last column): such a pixel then adds exactly 0 to every sum.
__device__ __forceinline__ void zero_past(float (&tx)[kRun], float (&ty)[kRun], int left) {
#pragma unroll
  for (int m = 0; m < kRun; ++m) {
    if (m >= left) {
      tx[m] = 0.f;
      ty[m] = 0.f;
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address `addr` of this block's shared memory in the block of cluster
// rank `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The reduction state of one block: two slot buffers of n_slots float4
// (one per warp of the cluster) with one mbarrier each, used in turns.
struct ClusterSum {
  float4* slots;
  unsigned long long* bars;
  int n_slots, C, rank;
  int n = 0;  // reductions so far: buffer n & 1, its phase (n >> 1) & 1
};

// Sum K values over the cluster. Each warp reduces its lanes with a
// butterfly (every lane ends with the same bits); lanes 0..C-1 then send
// the warp's partial into its slot of block `lane` (slot rank * warps +
// warp) with st.async, which counts its 16 bytes on that block's mbarrier.
// Thread 0 of each block arms its own mbarrier for n_slots x 16 bytes; every
// thread waits for that phase and adds the n_slots slots in the same order,
// so every block of the cluster holds the same bits and takes the same
// exit decision. No cluster-wide barrier: a block waits only for the data
// it reads. Two buffers are enough: a block sends into buffer n & 1 again
// (reduction n + 2) only after it has received every warp's reduction
// n + 1, which each warp sends after its reads of reduction n.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], ClusterSum& cs) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
  const int p = cs.n & 1;
  const unsigned phase = (cs.n >> 1) & 1;
  float4* buf = cs.slots + p * cs.n_slots;
  const unsigned bar = smem_addr(cs.bars + p);
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(cs.n_slots * 16)
                 : "memory");
  const int lane = threadIdx.x & 31;
  if (lane < cs.C) {
    float y = 0.f, z = 0.f;
    if constexpr (K > 1) y = v[1];
    if constexpr (K > 2) z = v[2];
    const unsigned dst =
        cluster_addr(smem_addr(buf + cs.rank * (blockDim.x >> 5) + (threadIdx.x >> 5)), lane);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(dst),
        "f"(v[0]), "f"(y), "f"(z), "f"(0.f), "r"(cluster_addr(bar, lane))
        : "memory");
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
  float4 s = buf[0];
  for (int j = 1; j < cs.n_slots; ++j) {
    const float4 t = buf[j];
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
  }
  v[0] = s.x;
  if constexpr (K > 1) v[1] = s.y;
  if constexpr (K > 2) v[2] = s.z;
  ++cs.n;
}

// The gather rule at windows wider than kMaxWinWide (design note 6): one
// cluster per keypoint of one stream, every level an XLA level or skipped.
// Block `rank` owns window rows rank * band_rows onward; its runs (kRun
// adjacent pixels of one band row) are numbered row-major, and thread t
// takes runs t, t + blockDim.x, ...; (r, j) walks them without a division.
// Every store into a block's shared memory from the cluster is one that
// block's own waits count (the blocks take the same decisions, so they
// make the same reductions), so no block exits while another can still
// write into its shared memory.
__global__ void __launch_bounds__(kWideMaxThreads, kWideMinBlocks)
lk_wide_kernel(const __grid_constant__ Table tab, const float* __restrict__ prev_pts,
               const float* __restrict__ init_pts, const uint8_t* __restrict__ valid,
               float* __restrict__ out_pts, uint8_t* __restrict__ out_ok,
               int32_t* __restrict__ out_iters) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const bool lead = rank == 0 && tid == 0;  // writes the keypoint's outputs
  const int n_slots = C * (T >> 5);
  const int win = tab.win;
  const int npx = win * win;
  const float half = (win - 1) * 0.5f;
  const int pad = win / 2 + 2;
  const bool in_smem = tab.tmpl_smem != 0;
  const int nrun = (win + kRun - 1) / kRun;  // runs a row
  const int row0 = rank * tab.band_rows;
  const int n_items = min(tab.band_rows, win - row0) * nrun;  // this block's runs
  const int S = tab.band_rows * nrun;  // runs of a template plane

  extern __shared__ __align__(16) float smem[];
  ClusterSum cs;
  cs.bars = reinterpret_cast<unsigned long long*>(smem);  // 2 mbarriers
  cs.slots = reinterpret_cast<float4*>(smem) + 1;         // 2 x n_slots
  cs.n_slots = n_slots;
  cs.C = C;
  cs.rank = rank;
  // tmpl, gx, gy: 3 planes of S runs, one float4 per run (its kRun pixels;
  // pixels past the window's last column hold 0, so they add nothing).
  float4* s_t = cs.slots + 2 * n_slots;

  const int k = blockIdx.y * (gridDim.x / C) + blockIdx.x / C;
  const size_t b = blockIdx.y;
  const int r0 = tid / nrun, j0 = tid - r0 * nrun;
  const int dr = T / nrun, dj = T - dr * nrun;

  float px = prev_pts[2 * k], py = prev_pts[2 * k + 1];
  float cx = init_pts[2 * k], cy = init_pts[2 * k + 1];
  const bool vk = valid[k] != 0;
  bool ok = vk;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(cs.bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block of the cluster runs, its mbarriers armed, before any block
  // sends into it.
  cluster.sync();

  for (int e = 0; e < tab.n; ++e) {
    const Level& L = tab.lv[e];
    const int lvl = tab.n - 1 - e;
    px = px * L.scale;
    py = py * L.scale;
    cx = cx * L.scale;
    cy = cy * L.scale;
    if (L.mode == kSkip) {
      if (lead) out_iters[(size_t)k * tab.n + lvl] = 0;
      continue;
    }
    const int H = L.H, W = L.W;
    const size_t off = b * L.stride;
    const float* prev = L.prev + off;
    const float* gxp = L.gx + off;
    const float* gyp = L.gy + off;
    const float* cur = L.cur + off;

    // ---- template, gradients, G ------------------------------------------
    int t_ox, t_oy;
    float ftx, fty;
    bool frac_ok;
    tile_origin(L, win, px, py, t_ox, t_oy, ftx, fty, frac_ok);
    const float v00 = (1.f - ftx) * (1.f - fty), v01 = ftx * (1.f - fty);
    const float v10 = (1.f - ftx) * fty, v11 = ftx * fty;
    float g[3] = {0.f, 0.f, 0.f};
    {
      int r = r0, j = j0;
      for (int i = tid; i < n_items; i += T) {
        const int c0 = j * kRun;
        float tx[kRun], ty[kRun];
        blend_run(gxp, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, tx);
        blend_run(gyp, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, ty);
        zero_past(tx, ty, win - c0);
        if (in_smem) {
          float t[kRun];
          blend_run(prev, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, t);
          s_t[i] = make_float4(t[0], t[1], t[2], t[3]);
          s_t[S + i] = make_float4(tx[0], tx[1], tx[2], tx[3]);
          s_t[2 * S + i] = make_float4(ty[0], ty[1], ty[2], ty[3]);
        }
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
          g[0] += tx[m] * tx[m];
          g[1] += tx[m] * ty[m];
          g[2] += ty[m] * ty[m];
        }
        r += dr;
        j += dj;
        if (j >= nrun) {
          j -= nrun;
          ++r;
        }
      }
    }
    // The steps read only the runs each thread wrote itself: s_t needs no
    // barrier, within a level or between levels.
    cluster_sum<3>(g, cs);
    const float sxx = g[0], sxy = g[1], syy = g[2];
    const float det = sxx * syy - sxy * sxy;
    const float half_tr = 0.5f * (sxx + syy);
    const float min_eig = (half_tr - sqrtf(fmaxf(half_tr * half_tr - det, 0.f))) / (float)npx;
    const bool good = (min_eig > tab.min_eig_thresh) && vk && frac_ok;
    const float safe_det = fabsf(det) > 1e-12f ? det : 1.f;
    const float inv00 = syy / safe_det, inv01 = -sxy / safe_det, inv11 = sxx / safe_det;

    // ---- Gauss-Newton steps, exiting at this keypoint's convergence --------
    int it = 0;
    while (good && it < tab.max_iter) {
      const float x0f = (cx + (float)pad) - half, y0f = (cy + (float)pad) - half;
      const float x0 = floorf(x0f), y0 = floorf(y0f);
      const float fx = x0f - x0, fy = y0f - y0;
      const int xi = clampi((int)x0, 0, W + 2 * pad - win - 1) - pad;
      const int yi = clampi((int)y0, 0, H + 2 * pad - win - 1) - pad;
      const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
      const float w10 = (1.f - fx) * fy, w11 = fx * fy;
      float bs[2] = {0.f, 0.f};
      int r = r0, j = j0;
      for (int i = tid; i < n_items; i += T) {
        const int c0 = j * kRun;
        float v[kRun], t[kRun], tx[kRun], ty[kRun];
        blend_run(cur, H, W, xi, yi, row0 + r, c0, w00, w01, w10, w11, v);
        if (in_smem) {
          const float4 t4 = s_t[i], x4 = s_t[S + i], y4 = s_t[2 * S + i];
          t[0] = t4.x, t[1] = t4.y, t[2] = t4.z, t[3] = t4.w;
          tx[0] = x4.x, tx[1] = x4.y, tx[2] = x4.z, tx[3] = x4.w;
          ty[0] = y4.x, ty[1] = y4.y, ty[2] = y4.z, ty[3] = y4.w;
        } else {
          blend_run(prev, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, t);
          blend_run(gxp, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, tx);
          blend_run(gyp, H, W, t_ox, t_oy, row0 + r, c0, v00, v01, v10, v11, ty);
          zero_past(tx, ty, win - c0);
        }
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
          const float dI = v[m] - t[m];
          bs[0] += dI * tx[m];
          bs[1] += dI * ty[m];
        }
        r += dr;
        j += dj;
        if (j >= nrun) {
          j -= nrun;
          ++r;
        }
      }
      cluster_sum<2>(bs, cs);
      const float dx = -(inv00 * bs[0] + inv01 * bs[1]);
      const float dy = -(inv01 * bs[0] + inv11 * bs[1]);
      cx = cx + dx;
      cy = cy + dy;
      ++it;
      if (dx * dx + dy * dy < tab.eps2) break;
    }
    if (L.keep_ok) ok = ok && good;
    if (lead) out_iters[(size_t)k * tab.n + lvl] = it;
  }

  if (lead) {
    const float half0 = win * 0.5f;
    const bool in_img = cx >= half0 && cx < (float)tab.W0 - half0 && cy >= half0 &&
                        cy < (float)tab.H0 - half0;
    out_pts[2 * k] = cx;
    out_pts[2 * k + 1] = cy;
    out_ok[k] = (ok && in_img) ? 1 : 0;
  }
}

// The tiled instantiations (design notes 1-5): each thread holds its
// window pixels in registers, the tiles are staged in shared memory.
template <int WIN, int SR, int MAXWIN>
__device__ __forceinline__ void lk_tiles(const Table& tab, const float* __restrict__ prev_pts,
                                         const float* __restrict__ init_pts,
                                         const uint8_t* __restrict__ valid,
                                         float* __restrict__ out_pts,
                                         uint8_t* __restrict__ out_ok,
                                         int32_t* __restrict__ out_iters) {
  constexpr int kPPT = ((WIN > 0 ? WIN * WIN : MAXWIN * MAXWIN) + kThreads - 1) / kThreads;
  constexpr bool kExact = WIN > 0 && (WIN * WIN) % kThreads == 0;
  const int win = WIN > 0 ? WIN : tab.win;
  const int sr = SR > 0 ? SR : tab.search_rows;
  const int npx = win * win;
  const int tw = win + 1, t2 = tw * tw;
  const int sstride = kLanes + win % 32;  // == win (mod 32): conflict-free rows
  const float half = (win - 1) * 0.5f;
  const int pad = win / 2 + 2;

  extern __shared__ __align__(16) float smem[];
  float4* s_part = reinterpret_cast<float4*>(smem);  // 2 x kWarps
  float* s_stage = smem + 8 * kWarps;                // search window or plane
  float* s_raw = s_stage + tab.stage_floats;         // 2 x 3 x t2

  // Keypoint blockIdx.x of stream blockIdx.y: inputs and outputs are
  // (B, N, ...), so its row is k; every plane is offset by the stream's.
  const int k = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;

  // The window pixels this thread owns: p = tid + j * kThreads.
  int pr[kPPT], pc[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int p = tid + j * kThreads;
    pr[j] = p / win;
    pc[j] = p - pr[j] * win;
  }
  float tmpl[kPPT], tgx[kPPT], tgy[kPPT];

  float px = prev_pts[2 * k], py = prev_pts[2 * k + 1];
  float cx = init_pts[2 * k], cy = init_pts[2 * k + 1];
  const bool vk = valid[k] != 0;
  bool ok = vk;
  int parity = 0;
  int buf = 0;

  // Prologue: the first tracked level's tiles.
  {
    const int e0 = next_active(tab, 0);
    if (e0 < tab.n) {
      float bx = px, by = py;
      for (int e = 0; e <= e0; ++e) {
        bx = bx * tab.lv[e].scale;
        by = by * tab.lv[e].scale;
      }
      stage_tiles(s_raw, tab.lv[e0], b * tab.lv[e0].stride, win, bx, by);
    }
    cp_async_commit();
  }

  for (int e = 0; e < tab.n; ++e) {
    const Level& L = tab.lv[e];
    const int lvl = tab.n - 1 - e;
    px = px * L.scale;
    py = py * L.scale;
    cx = cx * L.scale;
    cy = cy * L.scale;
    if (L.mode == kSkip) {
      if (tid == 0) out_iters[(size_t)k * tab.n + lvl] = 0;
      continue;
    }
    const int H = L.H, W = L.W;
    const bool window = L.mode != kXla;
    const float* cur = L.cur + b * L.stride;

    // ---- stage the search window (or the XLA level's plane) ---------------
    int sx0 = 0, sy0 = 0;
    const float* P = cur;  // what an XLA level's steps sample: plane or its copy
    if (window) {
      sx0 = clampi((int)floorf(cx) - kLanes / 2, 0, max(W - kLanes, 0));
      sy0 = clampi((int)floorf(cy) - sr / 2, 0, max(L.clamp_h - sr, 0));
      for (int i = tid; i < sr * kLanes; i += kThreads) {
        const int r = i / kLanes, c = i % kLanes;
        cp_async4(s_stage + r * sstride + c,
                  cur + (size_t)clampi(sy0 + r, 0, H - 1) * W + clampi(sx0 + c, 0, W - 1));
      }
    } else if (H * W <= tab.stage_floats) {
      for (int i = tid; i < H * W; i += kThreads) cp_async4(s_stage + i, cur + i);
      P = s_stage;
    }
    cp_async_commit();

    // ---- prefetch the next tracked level's tiles into the other buffer ----
    {
      const int ne = next_active(tab, e + 1);
      if (ne < tab.n) {
        float bx = px, by = py;
        for (int f = e + 1; f <= ne; ++f) {
          bx = bx * tab.lv[f].scale;
          by = by * tab.lv[f].scale;
        }
        stage_tiles(s_raw + (buf ^ 1) * 3 * t2, tab.lv[ne], b * tab.lv[ne].stride, win, bx, by);
      }
      cp_async_commit();
    }

    // ---- this level's tiles have landed: template, gradients, G -----------
    cp_async_wait<2>();
    __syncthreads();
    int t_ox, t_oy;
    float ftx, fty;
    bool frac_ok;
    tile_origin(L, win, px, py, t_ox, t_oy, ftx, fty, frac_ok);
    float g[3] = {0.f, 0.f, 0.f};
    {
      const float w00 = (1.f - ftx) * (1.f - fty), w01 = ftx * (1.f - fty);
      const float w10 = (1.f - ftx) * fty, w11 = ftx * fty;
      const float* raw = s_raw + buf * 3 * t2;
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        if (kExact || tid + j * kThreads < npx) {
          const float* r0 = raw + pr[j] * tw + pc[j];
          const float* r1 = r0 + t2;
          const float* r2 = r1 + t2;
          tmpl[j] = w00 * r0[0] + w01 * r0[1] + w10 * r0[tw] + w11 * r0[tw + 1];
          tgx[j] = w00 * r1[0] + w01 * r1[1] + w10 * r1[tw] + w11 * r1[tw + 1];
          tgy[j] = w00 * r2[0] + w01 * r2[1] + w10 * r2[tw] + w11 * r2[tw + 1];
          g[0] += tgx[j] * tgx[j];
          g[1] += tgx[j] * tgy[j];
          g[2] += tgy[j] * tgy[j];
        }
      }
    }
    block_sum<3>(g, s_part, parity);
    const float sxx = g[0], sxy = g[1], syy = g[2];
    const float det = sxx * syy - sxy * sxy;
    const float half_tr = 0.5f * (sxx + syy);
    const float min_eig = (half_tr - sqrtf(fmaxf(half_tr * half_tr - det, 0.f))) / (float)npx;
    const bool good = (min_eig > tab.min_eig_thresh) && vk && frac_ok;
    const float safe_det = fabsf(det) > 1e-12f ? det : 1.f;
    const float inv00 = syy / safe_det, inv01 = -sxy / safe_det, inv11 = sxx / safe_det;

    // ---- the search window (or plane) has landed ---------------------------
    cp_async_wait<1>();
    __syncthreads();

    // ---- Gauss-Newton steps, exiting at this keypoint's convergence --------
    bool inb = true;
    int it = 0;
    if (good && window) {
      const float sxf = (float)sx0, syf = (float)sy0;
      int off[kPPT];
#pragma unroll
      for (int j = 0; j < kPPT; ++j) off[j] = pr[j] * sstride + pc[j];
      while (it < tab.max_iter) {
        const float ox = cx - half - sxf, oy = cy - half - syf;
        const int oxi = (int)floorf(ox), oyi = (int)floorf(oy);
        if (oxi < 0 || oyi < 0 || oxi > kLanes - win - 2 || oyi > sr - win - 2) {
          inb = false;  // left the search window: the keypoint fails here
          break;
        }
        const float fx = ox - (float)oxi, fy = oy - (float)oyi;
        const float* w0 = s_stage + oyi * sstride + oxi;
        float b[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kPPT; ++j) {
          if (kExact || tid + j * kThreads < npx) {
            const float* r0 = w0 + off[j];
            const float* r1 = r0 + sstride;
            const float ya = (1.f - fy) * r0[0] + fy * r1[0];
            const float yb = (1.f - fy) * r0[1] + fy * r1[1];
            const float dI = ((1.f - fx) * ya + fx * yb) - tmpl[j];
            b[0] += dI * tgx[j];
            b[1] += dI * tgy[j];
          }
        }
        block_sum<2>(b, s_part, parity);
        const float dx = -(inv00 * b[0] + inv01 * b[1]);
        const float dy = -(inv01 * b[0] + inv11 * b[1]);
        cx = cx + dx;
        cy = cy + dy;
        ++it;
        if (dx * dx + dy * dy < tab.eps2) break;
      }
    } else if (good) {
      while (it < tab.max_iter) {
        const float x0f = (cx + (float)pad) - half, y0f = (cy + (float)pad) - half;
        const float x0 = floorf(x0f), y0 = floorf(y0f);
        const float fx = x0f - x0, fy = y0f - y0;
        const int xi = clampi((int)x0, 0, W + 2 * pad - win - 1) - pad;
        const int yi = clampi((int)y0, 0, H + 2 * pad - win - 1) - pad;
        const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
        const float w10 = (1.f - fx) * fy, w11 = fx * fy;
        float b[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kPPT; ++j) {
          if (kExact || tid + j * kThreads < npx) {
            const int ya = clampi(yi + pr[j], 0, H - 1) * W;
            const int yb = clampi(yi + pr[j] + 1, 0, H - 1) * W;
            const int xa = clampi(xi + pc[j], 0, W - 1);
            const int xb = clampi(xi + pc[j] + 1, 0, W - 1);
            const float v = w00 * P[ya + xa] + w01 * P[ya + xb] + w10 * P[yb + xa] +
                            w11 * P[yb + xb];
            const float dI = v - tmpl[j];
            b[0] += dI * tgx[j];
            b[1] += dI * tgy[j];
          }
        }
        block_sum<2>(b, s_part, parity);
        const float dx = -(inv00 * b[0] + inv01 * b[1]);
        const float dy = -(inv01 * b[0] + inv11 * b[1]);
        cx = cx + dx;
        cy = cy + dy;
        ++it;
        if (dx * dx + dy * dy < tab.eps2) break;
      }
    }
    if (L.keep_ok) ok = ok && good && inb;
    if (tid == 0) out_iters[(size_t)k * tab.n + lvl] = it;
    buf ^= 1;
    __syncthreads();  // every read of this level's buffers precedes the next copies
  }
  cp_async_wait<0>();

  if (tid == 0) {
    const float half0 = win * 0.5f;
    const bool in_img = cx >= half0 && cx < (float)tab.W0 - half0 && cy >= half0 &&
                        cy < (float)tab.H0 - half0;
    out_pts[2 * k] = cx;
    out_pts[2 * k + 1] = cy;
    out_ok[k] = (ok && in_img) ? 1 : 0;
  }
}

template <int WIN, int SR, int MAXWIN>
__global__ void __launch_bounds__(kThreads)
lk_pyramid_kernel(const __grid_constant__ Table tab, const float* __restrict__ prev_pts,
                  const float* __restrict__ init_pts, const uint8_t* __restrict__ valid,
                  float* __restrict__ out_pts, uint8_t* __restrict__ out_ok,
                  int32_t* __restrict__ out_iters) {
  lk_tiles<WIN, SR, MAXWIN>(tab, prev_pts, init_pts, valid, out_pts, out_ok, out_iters);
}

// What a launch ran: which instantiation or, for lk_wide, where its
// template lives (the cluster shape is in the rest of the report).
enum Route { kRoute24 = 0, kRouteNarrow, kRouteWide54, kRouteWideShared, kRouteWideGlobal };

// The launch report, out_route[kReportInts]: the route, the dynamic shared
// memory per block in bytes, the cluster size, the threads per block, the
// window rows per block, the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 where not queried) and the opt-in
// shared memory per block the plan read.
constexpr int kReportInts = 7;

void report(int* out, int route, int smem, int clusters, int threads, int band_rows, int active,
            int optin) {
  const int r[kReportInts] = {route, smem, clusters, threads, band_rows, active, optin};
  for (int i = 0; i < kReportInts; ++i) out[i] = r[i];
}

template <int WIN, int SR, int MAXWIN>
int launch(const Table& tab, size_t smem, int N, int B, const void* prev_pts,
           const void* init_pts, const void* valid, void* out_pts, void* out_ok, void* out_iters,
           cudaStream_t stream, Route route, int optin, int* out_route) {
  auto kernel = lk_pyramid_kernel<WIN, SR, MAXWIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(N, B), kThreads, smem, stream>>>(
      tab, (const float*)prev_pts, (const float*)init_pts, (const uint8_t*)valid,
      (float*)out_pts, (uint8_t*)out_ok, (int32_t*)out_iters);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) report(out_route, route, (int)smem, 1, kThreads, tab.win, 0, optin);
  return (int)e;
}

struct WidePlan {
  int route;  // kRouteWideShared or kRouteWideGlobal; -1: no plan
  int clusters, threads, band_rows, smem;
};

long lmin(long a, long b) { return a < b ? a : b; }

// lk_wide_kernel's launch plan (design note 6), a pure function of the
// window and the opt-in shared memory per block; ops/lk_kernel.py:wide_plan
// is its twin. A candidate is a cluster size C and a block size T: each
// block holds ceil(win / C) window rows, its two mbarriers (16 bytes) and
// 2 x C x warps reduction slots, and on the shared route its band's
// template and gradients (3 x kRun floats per run). An SM holds the blocks that its threads, its
// registers (at kWideRegs a thread), its 32 block slots and its shared
// memory (the opt-in bytes and one reserve) allow; the card holds kSms
// times that over C keypoints at once. The shared route wins wherever a
// candidate fits it. Then the fewest waves of a kWideKeypoints frame (as
// many keypoints resident at once as the card holds), then the fewest runs
// per thread, then the larger cluster (smaller blocks).
WidePlan plan_wide(int win, int optin) {
  const long nrun = (win + kRun - 1) / kRun;
  WidePlan best = {-1, 0, 0, 0, 0};
  long best_waves = 0, best_items = 0;
  for (int shared = 1; shared >= 0 && best.route < 0; --shared) {
    for (const int C : kWideClusters) {
      const long R = (win + C - 1) / C;
      for (const int T : kWideThreads) {
        const long smem = 16L * (1 + 2 * C * (T / 32)) + (shared ? 4L * 3 * kRun * R * nrun : 0);
        if (smem > optin) continue;
        long blocks = lmin(lmin(kSmBlocks, kSmThreads / T), kSmRegs / ((long)T * kWideRegs));
        blocks = lmin(blocks, (optin + kBlockSmemReserve) / (smem + kBlockSmemReserve));
        const long resident = kSms * blocks / C;
        if (resident < 1) continue;
        const long waves = (kWideKeypoints + resident - 1) / resident;
        const long items = (R * nrun + T - 1) / T;
        if (best.route < 0 || waves < best_waves ||
            (waves == best_waves && (items < best_items ||
                                     (items == best_items && C > best.clusters)))) {
          best = {shared ? kRouteWideShared : kRouteWideGlobal, C, T, (int)R, (int)smem};
          best_waves = waves;
          best_items = items;
        }
      }
    }
  }
  return best;
}

// Launch lk_wide_kernel on plan_wide's plan: one cluster per keypoint and
// stream, through cudaLaunchKernelEx with a cluster dimension (a CUDA graph
// captures it like any launch). A cluster the card cannot hold at all
// (cudaOccupancyMaxActiveClusters < 1) is an error.
int launch_wide(Table& tab, int optin, int N, int B, const void* prev_pts, const void* init_pts,
                const void* valid, void* out_pts, void* out_ok, void* out_iters,
                cudaStream_t stream, int* out_route) {
  const WidePlan p = plan_wide(tab.win, optin);
  if (p.route < 0) return (int)cudaErrorInvalidConfiguration;
  tab.tmpl_smem = p.route == kRouteWideShared;
  tab.band_rows = p.band_rows;
  cudaError_t e = cudaSuccess;
  if (p.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lk_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * N, B);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, lk_wide_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, lk_wide_kernel, (const Table)tab, (const float*)prev_pts,
                         (const float*)init_pts, (const uint8_t*)valid, (float*)out_pts,
                         (uint8_t*)out_ok, (int32_t*)out_iters);
  if (e == cudaSuccess) e = cudaGetLastError();
  // The route as the kernel reads it (tab.tmpl_smem), not as planned.
  if (e == cudaSuccess)
    report(out_route, tab.tmpl_smem ? kRouteWideShared : kRouteWideGlobal, p.smem, p.clusters,
           p.threads, p.band_rows, active, optin);
  return (int)e;
}


// ---------------------------------------------------------------------------
// lk_cached_kernel: the JAX package's default tracker (lk_impl="matmul").
//
// Replaces kimera_vio_tpu/ops/optical_flow.py:klt_track_cached (:461) and
// its level _iterate_level_cached (:352), which XLA runs outside any Pallas
// kernel: the per-frame half of the matmul tracker. The keyframe half,
// build_lk_templates (:323), is `lk_cache_build_kernel` below (one launch a
// keyframe); it hands this kernel its cache: per level the template window
// and its gradients ((B, N, win, win) float32), the inverse gradient matrix
// and the min-eigenvalue gate ((B, N)). The plain PyTorch version is
// ops/optical_flow.py:track_cached; the two compute the same float32
// arithmetic in the same term order (-fmad=false), only the order of the
// window sums differs.
//
// Per keypoint and stream, every level coarse to fine in one launch (points
// double between levels, skipped levels included): stage the level's S x S
// search patch (S = win + 2 slack + 2) at the seed's clamped origin with
// cp.async from edge-clamped addresses (jnp.pad(mode="edge") and the
// clamped dynamic slice of the reference), then up to max_iter Gauss-Newton
// steps inside it. Before each step the window offset is clipped to the
// patch, a clip over 0.5 px marks the keypoint diverged (it fails), and the
// window is blended at the clipped offset: a y-lerp of two patch rows, then
// an x-lerp of two columns, the order of the reference's two resampling
// matmuls. Each keypoint stops at its own convergence. Level 0 gates on the
// template gate and the image.
//
// What bounds it: as lk_pyramid_kernel, the latency of each keypoint's
// serial chain of steps (a 24x24 blend and two sums a step) and of each
// level's dependent patch copy, not bytes (the patches and the cache are ~2
// MB a 752x480 frame) or operations. The matmul form that fed the TPU's MXU
// has nothing to feed here: each window row has two nonzero weights, so the
// blend is 6 multiply-adds a pixel on the CUDA cores.
//
// Routes (`plan_cached` picks one, the launcher reports it; the Python twin
// is ops/lk_kernel.py:cached_plan):
//   * kCachedWarp, 24 px with slack 8 (the JAX default): `lk_cached_warp_kernel`,
//     one warp a keypoint and stream, kCachedWarpBlock (or, where their
//     buffers do not fit, 1) keypoints a block, each warp with its own patch
//     and cache buffer:
//       - lane l blends the runs q = l + 32 j of kCachedRun adjacent window
//         pixels, with fixed offsets, and holds the level's template and
//         gradients at them in registers (54 floats); a step's two sums are
//         an xor-butterfly, which leaves the same bits in every lane, so a
//         step has no shared partials and no barrier, and every lane takes
//         the same exit decision;
//       - a level's template, gx and gy windows are contiguous (win, win)
//         rows of the leaves (16-byte aligned: the launcher checks), so one
//         lane copies them with three cp.async.bulk (the bulk copy engine,
//         global to shared), beside the level's patch copy, completing on
//         the warp's mbarrier (copying levels ahead was slower). The gate
//         and inverse of every level are read at entry: lane e holds level
//         entry e's, and a shuffle hands them to the warp;
//       - the patch depends on the previous level's result, so it stays a
//         dependent copy: edge-clamped cp.async (a TMA tile fills
//         out-of-bounds cells with zeros, not edge values), at a row stride
//         congruent to win mod 32, so a warp's 32 consecutive window pixels
//         read 32 distinct banks.
//   * other widths, `lk_cached_kernel`, a block of kThreads a keypoint:
//     kCachedShared, the patch and the template cache in shared memory (to
//     101 px and a little beyond); kCachedPatch, the patch in shared memory
//     and the cache read through L1/L2 (to 222 px); kCachedGlobal, both read
//     through L2, with the same arithmetic.
enum CachedRoute : int { kCachedShared = 0, kCachedPatch = 1, kCachedGlobal = 2, kCachedWarp = 3 };

// The warp route's window and slack, the JAX default: the only width at
// which one warp a keypoint was faster than the 192-thread block on an H100
// (scripts/lk_kernel_ab.py --kernel cached, PERF.md; a walk at run time
// was slower at 16, 20 and 28-61 px).
constexpr int kCachedWarpWin = 24;
constexpr int kCachedWarpSlack = 8;
constexpr int kCachedWarpBlock = 2;  // keypoints (warps) a block of the warp route
// A lane blends runs of kCachedRun adjacent window pixels, which share
// their column lerps.
constexpr int kCachedRun = 3;

struct CachedLevel {
  const float* cur;                       // stream 0's plane of the current level
  const float* tmpl;                      // (B, N, win, win)
  const float* gx;
  const float* gy;
  const float* inv00;                     // (B, N)
  const float* inv01;
  const float* inv11;
  const uint8_t* good;                    // (B, N)
  long long stride;                       // elements between streams' planes
  int H, W;
  int skip;                               // no template: the level is skipped
  float scale;                            // the point is multiplied by this first
};

struct CachedTable {
  CachedLevel lv[kMaxLevels];  // coarse to fine: entry e is level n - 1 - e
  int n;
  int win, slack, max_iter;
  float eps2;
  int N;  // keypoints a stream (the warp route)
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The warp route's patch row stride: the smallest stride >= the patch's
// S = win + 2 slack + 2 columns congruent to win mod 32.
__host__ __device__ constexpr int cached_patch_stride(int win, int slack) {
  return win + 32 * ((2 * slack + 2 + 31) / 32);
}

// Bytes of one warp of the warp route: its mbarrier (a 16-byte unit), its
// S x S patch at cached_patch_stride, then its cache buffer (template, gx,
// gy), each buffer a whole number of 16-byte units.
constexpr int kCachedWarpS = kCachedWarpWin + 2 * kCachedWarpSlack + 2;
constexpr int kCachedWarpPS = cached_patch_stride(kCachedWarpWin, kCachedWarpSlack);
constexpr int kCachedWarpPatchFloats = round4(kCachedWarpS * kCachedWarpPS);
constexpr int kCachedWarpBytes =
    16 + 4 * (kCachedWarpPatchFloats + round4(3 * kCachedWarpWin * kCachedWarpWin));

template <int ROUTE>
__global__ void __launch_bounds__(kThreads)
lk_cached_kernel(const __grid_constant__ CachedTable tab, const float* __restrict__ init_pts,
                 const uint8_t* __restrict__ valid, float* __restrict__ out_pts,
                 uint8_t* __restrict__ out_ok, int32_t* __restrict__ out_iters) {
  const int win = tab.win;
  const int npx = win * win;
  const int S = win + 2 * tab.slack + 2;
  const float half = (win - 1) * 0.5f;
  const float hi = (float)(S - win - 1);
  const int k = blockIdx.y * gridDim.x + blockIdx.x;  // row of (B, N, ...)
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  // This thread's window pixels p = tid, tid + kThreads, ... walked as (r, c).
  const int r0 = tid / win, c0 = tid - r0 * win;
  const int dr = kThreads / win, dc = kThreads - dr * win;

  extern __shared__ __align__(16) float smem[];
  float4* s_part = reinterpret_cast<float4*>(smem);  // 2 x kWarps
  float* s_patch = smem + 8 * kWarps;                // S x S (shared routes)
  float* s_tmpl = s_patch + S * S;                   // 3 x npx (kCachedShared)

  float cx = init_pts[2 * k], cy = init_pts[2 * k + 1];
  bool ok = valid[k] != 0, diverged = false;
  int parity = 0;

  for (int e = 0; e < tab.n; ++e) {
    const CachedLevel& L = tab.lv[e];
    const int lvl = tab.n - 1 - e;
    cx = cx * L.scale;
    cy = cy * L.scale;
    if (L.skip) {
      if (tid == 0) out_iters[(size_t)k * tab.n + lvl] = 0;
      continue;
    }
    const int H = L.H, W = L.W;
    const float* cur = L.cur + b * L.stride;
    // The patch origin: the initial offset lands at slack + 1 + frac; the
    // patch itself starts where the reference's clamped slice starts.
    const int ox = (int)floorf(cx - half) - (tab.slack + 1);
    const int oy = (int)floorf(cy - half) - (tab.slack + 1);
    const int px0 = clampi(ox, -S, W), py0 = clampi(oy, -S, H);
    const float* T = L.tmpl + (size_t)k * npx;
    const float* GX = L.gx + (size_t)k * npx;
    const float* GY = L.gy + (size_t)k * npx;
    if constexpr (ROUTE != kCachedGlobal) {
      for (int i = tid; i < S * S; i += kThreads) {
        const int r = i / S, c = i - r * S;
        cp_async4(s_patch + i, cur + (size_t)clampi(py0 + r, 0, H - 1) * W + clampi(px0 + c, 0, W - 1));
      }
      if constexpr (ROUTE == kCachedShared) {
        for (int i = tid; i < npx; i += kThreads) {
          cp_async4(s_tmpl + i, T + i);
          cp_async4(s_tmpl + npx + i, GX + i);
          cp_async4(s_tmpl + 2 * npx + i, GY + i);
        }
        T = s_tmpl;
        GX = s_tmpl + npx;
        GY = s_tmpl + 2 * npx;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const bool good = L.good[k] != 0;
    const float inv00 = L.inv00[k], inv01 = L.inv01[k], inv11 = L.inv11[k];
    float relx = cx - (float)ox, rely = cy - (float)oy;

    int it = 0;
    while (good && it < tab.max_iter) {
      const float offx = relx - half, offy = rely - half;
      const float ocx = fminf(fmaxf(offx, 0.f), hi), ocy = fminf(fmaxf(offy, 0.f), hi);
      if (fabsf(offx - ocx) > 0.5f || fabsf(offy - ocy) > 0.5f) diverged = true;
      const float kx = floorf(ocx), ky = floorf(ocy);
      const float fx = ocx - kx, fy = ocy - ky;
      const int ix = (int)kx, iy = (int)ky;
      float bs[2] = {0.f, 0.f};
      int r = r0, c = c0;
      for (int p = tid; p < npx; p += kThreads) {
        float a0, a1, b0, b1;  // rows iy + r and iy + r + 1, columns ix + c and + 1
        if constexpr (ROUTE == kCachedGlobal) {
          const float* ra = cur + (size_t)clampi(py0 + iy + r, 0, H - 1) * W;
          const float* rb = cur + (size_t)clampi(py0 + iy + r + 1, 0, H - 1) * W;
          const int xa = clampi(px0 + ix + c, 0, W - 1), xb = clampi(px0 + ix + c + 1, 0, W - 1);
          a0 = ra[xa];
          a1 = ra[xb];
          b0 = rb[xa];
          b1 = rb[xb];
        } else {
          const float* q = s_patch + (iy + r) * S + ix + c;
          a0 = q[0];
          a1 = q[1];
          b0 = q[S];
          b1 = q[S + 1];
        }
        const float ya = (1.f - fy) * a0 + fy * b0;
        const float yb = (1.f - fy) * a1 + fy * b1;
        const float dI = ((1.f - fx) * ya + fx * yb) - T[p];
        bs[0] += dI * GX[p];
        bs[1] += dI * GY[p];
        r += dr;
        c += dc;
        if (c >= win) {
          c -= win;
          ++r;
        }
      }
      block_sum<2>(bs, s_part, parity);
      const float dx = -(inv00 * bs[0] + inv01 * bs[1]);
      const float dy = -(inv01 * bs[0] + inv11 * bs[1]);
      relx = relx + dx;
      rely = rely + dy;
      ++it;
      if (dx * dx + dy * dy < tab.eps2) break;
    }
    cx = relx + (float)ox;
    cy = rely + (float)oy;
    if (lvl == 0) {
      const float half0 = win * 0.5f;
      const bool inb = cx >= half0 && cx < (float)W - half0 && cy >= half0 && cy < (float)H - half0;
      ok = ok && good && inb;
    }
    if (tid == 0) out_iters[(size_t)k * tab.n + lvl] = it;
    __syncthreads();  // every read of this level's patch precedes the next level's copies
  }
  if (tid == 0) {
    out_pts[2 * k] = cx;
    out_pts[2 * k + 1] = cy;
    out_ok[k] = (ok && !diverged) ? 1 : 0;
  }
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the bulk copy engine, counted on mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The warp route: copy a level's template, gx and gy windows of keypoint
// row k into dst by the bulk copy engine, counted on mbarrier `bar`. One
// lane calls it.
__device__ __forceinline__ void cache_copy(float* dst, const CachedLevel& L, int k, unsigned bar) {
  constexpr int npx = kCachedWarpWin * kCachedWarpWin;
  constexpr unsigned bytes = 4u * npx;
  const size_t o = (size_t)k * npx;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(3 * bytes)
               : "memory");
  bulk_copy(dst, L.tmpl + o, bytes, bar);
  bulk_copy(dst + npx, L.gx + o, bytes, bar);
  bulk_copy(dst + 2 * npx, L.gy + o, bytes, bar);
}

// The warp route: copy the S x S cells of an (H, W) plane from origin (oy,
// ox), edge-clamped, into dst at row stride kCachedWarpPS, as one cp.async
// group. Lane l takes cells l, l + 32, ... in row-major order, walked as
// (r, c).
__device__ __forceinline__ void copy_patch(float* dst, const float* plane, int H, int W, int oy,
                                           int ox, int lane) {
  constexpr int S = kCachedWarpS;
  constexpr int dr = 32 / S, dc = 32 - dr * S;
  int r = lane / S, c = lane - (lane / S) * S;
#pragma unroll
  for (int i = 0; i < (S * S + 31) / 32; ++i) {
    if (lane + 32 * i < S * S)
      cp_async4(dst + r * kCachedWarpPS + c,
                plane + (size_t)clampi(oy + r, 0, H - 1) * W + clampi(ox + c, 0, W - 1));
    r += dr;
    c += dc;
    if (c >= S) {
      c -= S;
      ++r;
    }
  }
  cp_async_commit();
}

// The warp route (see the route note above), at kCachedWarpWin px and
// kCachedWarpSlack.
__global__ void __launch_bounds__(32 * kCachedWarpBlock)
lk_cached_warp_kernel(const __grid_constant__ CachedTable tab, const float* __restrict__ init_pts,
                      const uint8_t* __restrict__ valid, float* __restrict__ out_pts,
                      uint8_t* __restrict__ out_ok, int32_t* __restrict__ out_iters) {
  constexpr int WIN = kCachedWarpWin, PS = kCachedWarpPS, kR = kCachedRun;
  constexpr int npx = WIN * WIN;
  constexpr int kRuns = npx / kR / 32;  // runs a lane
  static_assert(WIN % kR == 0 && (npx / kR) % 32 == 0, "the runs fill every lane");
  constexpr float half = (WIN - 1) * 0.5f;
  constexpr float hi = (float)(kCachedWarpS - WIN - 1);
  constexpr int slack = kCachedWarpSlack;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kn = blockIdx.x * (blockDim.x >> 5) + warp;
  if (kn >= tab.N) return;
  const int k = blockIdx.y * tab.N + kn;  // row of (B, N, ...)
  const size_t b = blockIdx.y;

  // Per warp: its mbarrier, its patch, then its cache buffer.
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem + warp * (kCachedWarpBytes / 4);
  const unsigned bar = smem_addr(wbuf);
  float* patch = wbuf + 4;
  float* cache = patch + kCachedWarpPatchFloats;
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Lane e holds level entry e's gate and inverse gradient matrix.
  float my_inv00 = 0.f, my_inv01 = 0.f, my_inv11 = 0.f;
  int my_good = 0;
  if (lane < tab.n && !tab.lv[lane].skip) {
    const CachedLevel& L = tab.lv[lane];
    my_good = L.good[k];
    my_inv00 = L.inv00[k];
    my_inv01 = L.inv01[k];
    my_inv11 = L.inv11[k];
  }
  // Lane l blends the runs q = l + 32 j of kR adjacent window pixels (run q
  // starts at pixel kR q) at patch offsets off[j].
  int off[kRuns];
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const int p = kR * (lane + 32 * j);
    off[j] = (p / WIN) * PS + p % WIN;
  }

  float cx = init_pts[2 * k], cy = init_pts[2 * k + 1];
  bool ok = valid[k] != 0, diverged = false;
  unsigned phase = 0;  // the mbarrier's phase: one completion a tracked level
  for (int e = 0; e < tab.n; ++e) {
    const CachedLevel& L = tab.lv[e];
    const int lvl = tab.n - 1 - e;
    cx = cx * L.scale;
    cy = cy * L.scale;
    if (L.skip) {
      if (lane == 0) out_iters[(size_t)k * tab.n + lvl] = 0;
      continue;
    }
    const int H = L.H, W = L.W;
    const int ox = (int)floorf(cx - half) - (slack + 1);
    const int oy = (int)floorf(cy - half) - (slack + 1);
    copy_patch(patch, L.cur + b * L.stride, H, W, clampi(oy, -kCachedWarpS, H),
               clampi(ox, -kCachedWarpS, W), lane);
    if (lane == 0) cache_copy(cache, L, k, bar);
    cp_async_wait<0>();
    __syncwarp();
    mbar_wait(bar, phase);
    phase ^= 1;
    const bool good = __shfl_sync(kFull, my_good, e) != 0;
    const float inv00 = __shfl_sync(kFull, my_inv00, e);
    const float inv01 = __shfl_sync(kFull, my_inv01, e);
    const float inv11 = __shfl_sync(kFull, my_inv11, e);
    float t[kRuns][kR], tx[kRuns][kR], ty[kRuns][kR];
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const int p = kR * (lane + 32 * j) + m;
        t[j][m] = cache[p];
        tx[j][m] = cache[npx + p];
        ty[j][m] = cache[2 * npx + p];
      }
    }
    float relx = cx - (float)ox, rely = cy - (float)oy;

    int it = 0;
    while (good && it < tab.max_iter) {
      const float offx = relx - half, offy = rely - half;
      const float ocx = fminf(fmaxf(offx, 0.f), hi), ocy = fminf(fmaxf(offy, 0.f), hi);
      if (fabsf(offx - ocx) > 0.5f || fabsf(offy - ocy) > 0.5f) diverged = true;
      const float kx = floorf(ocx), ky = floorf(ocy);
      const float fx = ocx - kx, fy = ocy - ky;
      const float* q0 = patch + (int)ky * PS + (int)kx;
      // One partial sum a run position, so that the adds form kR short
      // chains.
      float px[kR] = {}, py[kR] = {};
#pragma unroll
      for (int j = 0; j < kRuns; ++j) {
        // A run's kR + 1 column lerps, then each pixel's x-lerp: the plain
        // version's terms, a column lerp shared by two pixels.
        const float* q = q0 + off[j];
        float ya[kR + 1];
#pragma unroll
        for (int i = 0; i <= kR; ++i) ya[i] = (1.f - fy) * q[i] + fy * q[PS + i];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float dI = ((1.f - fx) * ya[i] + fx * ya[i + 1]) - t[j][i];
          px[i] += dI * tx[j][i];
          py[i] += dI * ty[j][i];
        }
      }
      float bs0 = 0.f, bs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        bs0 += px[i];
        bs1 += py[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        bs0 += __shfl_xor_sync(kFull, bs0, o);
        bs1 += __shfl_xor_sync(kFull, bs1, o);
      }
      const float dx = -(inv00 * bs0 + inv01 * bs1);
      const float dy = -(inv01 * bs0 + inv11 * bs1);
      relx = relx + dx;
      rely = rely + dy;
      ++it;
      if (dx * dx + dy * dy < tab.eps2) break;
    }
    cx = relx + (float)ox;
    cy = rely + (float)oy;
    if (lvl == 0) {
      const float half0 = WIN * 0.5f;
      const bool inb = cx >= half0 && cx < (float)W - half0 && cy >= half0 && cy < (float)H - half0;
      ok = ok && good && inb;
    }
    if (lane == 0) out_iters[(size_t)k * tab.n + lvl] = it;
    __syncwarp();  // every lane's reads of this level's buffers precede the next copies
  }
  if (lane == 0) {
    out_pts[2 * k] = cx;
    out_pts[2 * k + 1] = cy;
    out_ok[k] = (ok && !diverged) ? 1 : 0;
  }
}

// Dynamic shared memory of each route: on the block routes the warps'
// partials, and the patch (and the cache) where the route keeps them; on
// the warp route kCachedWarpBytes for each of `warps` warps.
size_t cached_smem(int route, int win, int slack, int warps) {
  if (route == kCachedWarp) return (size_t)warps * kCachedWarpBytes;
  const size_t S = (size_t)win + 2 * slack + 2;
  const size_t fixed = sizeof(float) * 8 * kWarps;
  if (route == kCachedShared) return fixed + sizeof(float) * (S * S + 3 * (size_t)win * win);
  if (route == kCachedPatch) return fixed + sizeof(float) * S * S;
  return fixed;
}

struct CachedPlan {
  int route, warps, smem;  // warps: keypoints a block (warp route)
};

// lk_cached_kernel's launch plan, a pure function of the window, the
// slack and the opt-in shared memory per block; ops/lk_kernel.py:cached_plan
// is its twin. At kCachedWarpWin px and kCachedWarpSlack the warp route, at
// kCachedWarpBlock warps a block where they fit, else one. At other widths,
// or where not even one warp fits, the first block route whose shared
// memory fits.
CachedPlan plan_cached(int win, int slack, int optin) {
  if (win == kCachedWarpWin && slack == kCachedWarpSlack) {
    for (int w = kCachedWarpBlock; w >= 1; w /= 2) {
      const size_t smem = cached_smem(kCachedWarp, win, slack, w);
      if (smem <= (size_t)optin) return {kCachedWarp, w, (int)smem};
    }
  }
  int route = kCachedShared;
  while (route < kCachedGlobal && cached_smem(route, win, slack, 1) > (size_t)optin) ++route;
  return {route, 1, (int)cached_smem(route, win, slack, 1)};
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int ROUTE>
int launch_cached(const CachedTable& tab, size_t smem, int N, int B, const void* init_pts,
                  const void* valid, void* out_pts, void* out_ok, void* out_iters,
                  cudaStream_t stream) {
  auto kernel = lk_cached_kernel<ROUTE>;
  const int e = set_smem((const void*)kernel, smem);
  if (e != 0) return e;
  kernel<<<dim3(N, B), kThreads, smem, stream>>>(tab, (const float*)init_pts,
                                                  (const uint8_t*)valid, (float*)out_pts,
                                                  (uint8_t*)out_ok, (int32_t*)out_iters);
  return (int)cudaGetLastError();
}

int launch_cached_warp(const CachedTable& tab, const CachedPlan& p, int N, int B,
                       const void* init_pts, const void* valid, void* out_pts, void* out_ok,
                       void* out_iters, cudaStream_t stream) {
  const int e = set_smem((const void*)lk_cached_warp_kernel, p.smem);
  if (e != 0) return e;
  lk_cached_warp_kernel<<<dim3((N + p.warps - 1) / p.warps, B), 32 * p.warps, p.smem, stream>>>(
      tab, (const float*)init_pts, (const uint8_t*)valid, (float*)out_pts, (uint8_t*)out_ok,
      (int32_t*)out_iters);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lk_cache_build_kernel: the keyframe half of the default tracker.
//
// Replaces kimera_vio_tpu/ops/optical_flow.py:build_lk_templates (:323) and
// its level _build_level_template (:235), which XLA runs outside any Pallas
// kernel once a keyframe. The plain PyTorch version is
// ops/optical_flow.py:build_lk_templates; the two compute the same float32
// terms in the same order (-fmad=false): the template, gx and gy windows
// are bit-identical, only the three gradient sums are added in another
// order.
//
// What bounds it. A 752x480 keyframe of 256 keypoints writes 5 levels x 3
// x 576 floats a keypoint (~9 MB) and reads ~1.5 MB of patches: ~3 us at
// 3.35 TB/s. Built with -fmad=false, every multiply and add issues alone,
// and the plain term order costs, per window pixel, Scharr x and y on four
// patch cells (88 operations), three y-then-x blends (27) and the three
// products and sums (6). The first design (a 128-thread block an item,
// each pixel reading its 4x4 neighbourhood from a shared-memory patch)
// issued ~150 instructions a pixel, ~3.5 M warp instructions a keyframe,
// and ran at 30 % of the byte bound; below 100 px its time was issue and
// latency, above it the partial-sector stores of window rows.
//
// The design: one warp sweeps a strip of an item's window, lanes over
// columns, top to bottom, one patch row a step. A lane holds its column's
// value and its two Scharr products (3/32 and 10/32 of it) for the last
// two rows; its neighbours' come by shuffle. So each patch value is read
// once and multiplied twice, each Scharr cell's x and y sums (the nonzero
// taps of _DERIV_X and _DERIV_Y in row-major order, a tap of coefficient
// -c as the negated product of c) are formed once, each row's three column
// lerps once, and a pixel's x-lerp takes its right neighbour's column lerp
// by shuffle. The compiled-in 24 px sweep is 1,517 instructions an item on
// its path, 901 of them the float32 terms, 190 shuffles and 72 stores:
// ~63 a step for a row of 24 pixels, 2.6 warp instructions a pixel
// (scripts/sass_counts.py), ~1.9 M a keyframe, ~2 us of issue on 132 SMs,
// under the byte bound. Items are (keypoint, level, stream); a strip is at
// most kBuildStrip window columns (32 lanes less 3 of halo), and wider
// windows are cut into equal strips, one warp each (past kBuildMaxUnits
// strips, 464 px, the wide route: a warp takes every kBuildMaxUnits-th,
// its own instantiation, so that the others carry no loop). The lanes read the
// keyframe's rows through L1/L2, coalesced, the edge clamp in the column
// each lane reads; rows come kBuildChunk at a time, the next chunk's loads
// in flight during this chunk's steps (the compiled-in window loads all
// its rows at once). At 24 px each window row goes out as one coalesced
// warp store a plane (96 contiguous bytes: three whole 32-byte sectors).
// From kBuildStageFrom px a chunk's rows go to shared memory laid out as
// in global memory, and leave, after a block barrier, as 16-byte stores
// of the whole chunk (a strip's row alone covers parts of sectors). The
// three gradient sums are reduced per warp (butterfly), then one lane an
// item adds its warps' partials and writes the inverse 2x2 and the
// min-eigenvalue gate; an item of one warp needs no block barrier. With
// full-image gradients given (prev_grads) the template, gx and gy windows
// are blended from the three planes through L1/L2, the item's warps taking
// its pixels in turn.
//
// Measured and not kept (scripts/lk_kernel_ab.py, PERF.md): each item's
// patch staged in shared memory by 16-byte cp.async (slower than the L1/L2
// reads at every width: each value is read once); the compiled-in
// window's rows staged and sent by cp.async.bulk (slower than its
// whole-sector stores); two window columns a lane (more registers, spills);
// row bands. The launch plan is `plan_build` (its Python twin
// ops/lk_kernel.py:build_plan); the launcher reports it.
constexpr int kBuildStrip = 29;     // window columns a strip holds at most: 32 lanes less 3 of halo
constexpr int kBuildWarps = 4;      // warps a block of narrow items holds
constexpr int kBuildMaxUnits = 16;  // warps an item may have: a warp a strip up to 16 strips
constexpr int kBuildChunk = 8;      // window rows a warp's lanes load ahead, and stage out
constexpr int kBuildFixedWin = 24;  // the window compiled in (the main path's)
constexpr int kBuildStageFrom = 48;  // windows from this width stage their rows in shared memory
constexpr int kBuildMaxThreads = 32 * kBuildMaxUnits;
constexpr int kBuildMinBlocks = 2;  // launch bounds: ptxas keeps the kernel within 64 registers
constexpr int kBuildReportInts = 7;
enum BuildRoute : int { kBuildSweep = 0, kBuildGrads = 1, kBuildWide = 2 };

struct BuildPlan {
  int route, strips, items, threads, smem;  // items: (keypoint, level) items a block
  int staged;                               // rows leave through shared memory
};

// A window's columns in equal strips of at most kBuildStrip, one warp each.
__host__ __device__ constexpr int build_strip_cols(int win) {
  return (win + (win + kBuildStrip - 1) / kBuildStrip - 1) / ((win + kBuildStrip - 1) / kBuildStrip);
}
__host__ __device__ constexpr int build_strips(int win) {
  return (win + build_strip_cols(win) - 1) / build_strip_cols(win);
}

// Floats of one plane of one buffer of an item's row staging: a chunk of
// kBuildChunk window rows after up to 3 floats of alignment, in whole
// 16-byte units. Bytes of the staging: two buffers of three planes; none
// at the compiled-in window, whose rows go out directly.
__host__ __device__ constexpr int build_stage_plane(int win) {
  return (kBuildChunk * win + 3 + 3) / 4 * 4;
}
__host__ __device__ constexpr size_t build_stage_bytes(int win) {
  return win == kBuildFixedWin ? 0 : 4 * 2 * 3 * (size_t)build_stage_plane(win);
}

// lk_cache_build_kernel's launch plan, a pure function of the window,
// whether full-image gradients are given and the opt-in shared memory per
// block. An item gets one warp a strip; a block holds kBuildWarps / that
// many items, at least one, fewer if their shared memory does not fit: a
// 16-byte slot a warp for its partial sums and, from kBuildStageFrom px
// where it fits, the item's row staging. Past kBuildMaxUnits strips the
// wide route: kBuildMaxUnits warps an item, each taking every
// kBuildMaxUnits-th strip, rows stored directly. With gradients given an
// item gets kBuildWarps warps, which take its pixels in turn.
BuildPlan plan_build(int win, int grads, int optin) {
  const int strips = build_strips(win);
  const int items = strips < kBuildWarps ? kBuildWarps / strips : 1;
  if (grads) return {kBuildGrads, strips, 1, 32 * kBuildWarps, 16 * kBuildWarps, 0};
  if (strips > kBuildMaxUnits)
    return {kBuildWide, strips, 1, 32 * kBuildMaxUnits, 16 * kBuildMaxUnits, 0};
  for (int staged = win >= kBuildStageFrom; staged >= 0; --staged) {
    const size_t item = 16 * (size_t)strips + (staged ? build_stage_bytes(win) : 0);
    for (int i = items; i >= 1; i /= 2) {
      if ((size_t)i * item <= (size_t)optin || (!staged && i == 1))
        return {kBuildSweep, strips, i, 32 * i * strips, (int)((size_t)i * item), staged};
    }
  }
  return {};  // not reached: the unstaged plan always returns
}

struct BuildLevel {
  const float* img;  // stream 0's plane of the keyframe level
  const float* gx;   // full-image gradients, or null: Scharr on the patch
  const float* gy;
  float* tmpl;       // (B, N, win, win)
  float* out_gx;
  float* out_gy;
  float* inv00;      // (B, N)
  float* inv01;
  float* inv11;
  uint8_t* good;
  long long stride;  // elements between streams' planes
  int H, W;
  float div;         // 2^level: the points are divided by it
};

struct BuildTable {
  BuildLevel lv[kMaxLevels];  // the levels a window fits in
  int N, win;
  float min_eig_thresh;
  int units, items;  // the plan: warps an item (its strips, kBuildMaxUnits on the wide route,
                     // or kBuildWarps with gradients)
};

// *p = v of three planes where pred, as predicated stores (no branch
// around them): to global memory (nothing in the kernel reads them), or to
// shared memory at shared-window addresses.
__device__ __forceinline__ void st3_global_if(float* p0, float* p1, float* p2, float v0, float v1,
                                              float v2, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %6, 0;\n @q st.global.f32 [%0], %3;\n"
      " @q st.global.f32 [%1], %4;\n @q st.global.f32 [%2], %5;\n}\n" ::"l"(p0),
      "l"(p1), "l"(p2), "f"(v0), "f"(v1), "f"(v2), "r"((int)pred));
}
__device__ __forceinline__ void st3_shared_if(unsigned a0, unsigned a1, unsigned a2, float v0,
                                              float v1, float v2, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %6, 0;\n @q st.shared.f32 [%0], %3;\n"
      " @q st.shared.f32 [%1], %4;\n @q st.shared.f32 [%2], %5;\n}\n" ::"r"(a0),
      "r"(a1), "r"(a2), "f"(v0), "f"(v1), "f"(v2), "r"((int)pred)
      : "memory");  // the chunk's copy-out reads these after a barrier
}

// One block holds tab.items items (keypoint, level blockIdx.y, stream
// blockIdx.z); warp w works on item w / units as its unit (strip) w %
// units. WIN > 0 fixes the window at compile time (kBuildFixedWin, one
// strip): the sweep then loads all its patch rows at once, unrolls every
// step and stores each row directly (96 contiguous bytes at 24 px: three
// whole sectors). STAGED: the rows leave through shared memory (the plan's
// `staged`). ROUTE kBuildWide: a warp sweeps its strips one after another.
// A block's items past N compute on the stream's first keypoint and write
// nothing, so that every warp meets every barrier.
template <int ROUTE, int WIN, bool STAGED>
__global__ void __launch_bounds__(kBuildMaxThreads, kBuildMinBlocks)
lk_cache_build_kernel(const __grid_constant__ BuildTable tab, const float* __restrict__ pts,
                      const uint8_t* __restrict__ valid) {
  const BuildLevel& L = tab.lv[blockIdx.y];
  const int win = WIN > 0 ? WIN : tab.win, npx = win * win, Sg = win + 4;
  const int units = WIN > 0 ? build_strips(WIN) : tab.units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / units, unit = warp - slot * units;
  const int kn = blockIdx.x * tab.items + slot;
  const bool live = kn < tab.N;
  const size_t b = blockIdx.z;
  const int k = blockIdx.z * tab.N + (live ? kn : 0);  // row of (B, N, ...)
  const float half = (win - 1) * 0.5f;
  const int H = L.H, W = L.W;
  const float* img = L.img + b * L.stride;
  // The template's corner and sub-pixel offset, as the reference takes them.
  const float hx = pts[2 * k] / L.div - half, hy = pts[2 * k + 1] / L.div - half;
  const float cxf = floorf(hx), cyf = floorf(hy);
  const int tx0 = (int)cxf, ty0 = (int)cyf;
  const float fx = hx - cxf, fy = hy - cyf;
  const float omfx = 1.f - fx, omfy = 1.f - fy;
  const size_t o = (size_t)k * npx;

  // Shared memory: a 16-byte slot a warp, then each item's row staging.
  extern __shared__ __align__(16) float smem[];
  float4* part = reinterpret_cast<float4*>(smem);
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  if constexpr (ROUTE == kBuildGrads) {
    // The three planes' (win + 1)^2 corners at the reference's clamped
    // origin in the St-padded planes; the item's warps take its pixels in
    // turn, walked as (r, c).
    const int St = win + 2, pad = St + 2;
    const int oy = clampi(ty0, -pad, H + pad - St), ox = clampi(tx0, -pad, W + pad - St);
    const float* pgx = L.gx + b * L.stride;
    const float* pgy = L.gy + b * L.stride;
    const int step = 32 * units, first = 32 * unit + lane;
    const int dr = step / win, dc = step - dr * win;
    int r = first / win, c = first - (first / win) * win;
    for (int p = first; live && p < npx; p += step) {
      const size_t y0 = (size_t)clampi(oy + r, 0, H - 1) * W, y1 = (size_t)clampi(oy + r + 1, 0, H - 1) * W;
      const int x0 = clampi(ox + c, 0, W - 1), x1 = clampi(ox + c + 1, 0, W - 1);
      const float vt = omfx * (omfy * img[y0 + x0] + fy * img[y1 + x0]) +
                       fx * (omfy * img[y0 + x1] + fy * img[y1 + x1]);
      const float vx = omfx * (omfy * pgx[y0 + x0] + fy * pgx[y1 + x0]) +
                       fx * (omfy * pgx[y0 + x1] + fy * pgx[y1 + x1]);
      const float vy = omfx * (omfy * pgy[y0 + x0] + fy * pgy[y1 + x0]) +
                       fx * (omfy * pgy[y0 + x1] + fy * pgy[y1 + x1]);
      L.tmpl[o + p] = vt;
      L.out_gx[o + p] = vx;
      L.out_gy[o + p] = vy;
      gxx += vx * vx;
      gxy += vx * vy;
      gyy += vy * vy;
      r += dr;
      c += dc;
      if (c >= win) {
        c -= win;
        ++r;
      }
    }
  } else {
    // The reference slices the level padded by `pad`; the slice start is
    // clamped to stay inside it. Patch cell (u, v) is the level's pixel
    // (clamp(oy + u), clamp(ox + v)).
    const int pad = Sg + 2;
    const int oy = clampi(ty0 - 1, -pad, H + pad - Sg), ox = clampi(tx0 - 1, -pad, W + pad - Sg);
    // This warp's strip unit (on the wide route also unit + units, ...: the
    // other routes make one pass, with nothing live past it). A strip holds
    // window columns col0 .. col0 + ncw - 1; lane l holds patch column
    // col0 + l (a window column where l < ncw).
    const int cw = build_strip_cols(win);
    for (int strip = unit;; strip += units) {
      const int col0 = strip * cw, ncw = min(cw, win - col0);
      const int cx = clampi(ox + min(col0 + lane, Sg - 1), 0, W - 1);
      const bool out = lane < ncw;
      auto raw = [&](int t) -> float { return img[(size_t)clampi(oy + t, 0, H - 1) * W + cx]; };
      // Patch rows 0, 1, 2 first: Scharr row 0. Kept of the last two rows
      // (suffix m1, m2): the value x, its products a = 3/32 x and bb = 10/32
      // x, and the neighbours' a2 (column + 2), b1 (+ 1) and b2 (+ 2); sxp,
      // syp: the last Scharr row.
      float xs[WIN > 0 ? WIN : kBuildChunk];
      const float x0 = raw(0), x1 = raw(1), x2 = raw(2);
      if constexpr (WIN > 0) {
#pragma unroll
        for (int j = 0; j < WIN; ++j) xs[j] = raw(3 + j);  // every row of the sweep at once
      }
      const float a_2 = 0.09375f * x0, a_1 = 0.09375f * x1, a_0 = 0.09375f * x2;
      const float bb_2 = 0.3125f * x0, bb_1 = 0.3125f * x1, bb_0 = 0.3125f * x2;
      const float a2_2 = __shfl_down_sync(kFull, a_2, 2);
      float a2m2 = __shfl_down_sync(kFull, a_1, 2);
      float a2m1 = __shfl_down_sync(kFull, a_0, 2);
      const float b1_2 = __shfl_down_sync(kFull, bb_2, 1);
      float b1m2 = __shfl_down_sync(kFull, bb_1, 1);
      float b1m1 = __shfl_down_sync(kFull, bb_0, 1);
      const float b2_1 = __shfl_down_sync(kFull, bb_1, 2);
      float b2m1 = __shfl_down_sync(kFull, bb_0, 2);
      // Scharr x: -a +a2 over row i, -bb +b2 over row i + 1, -a +a2 over row
      // i + 2; y: -a -b1 -a2 over row i, +a +b1 +a2 over row i + 2.
      float sxp = ((((-a_2 + a2_2) + -bb_1) + b2_1) + -a_0) + a2m1;
      float syp = ((((-a_2 + -b1_2) + -a2_2) + a_0) + b1m1) + a2m1;
      float xm2 = x1, xm1 = x2, am2 = a_1, am1 = a_0, bbm1 = bb_0;
      // Where window row j of the current chunk goes, per plane: global
      // memory, or (STAGED) the chunk's staging buffer.
      float *dt, *dx, *dy;
      unsigned st0, st1, st2;
      // Patch row r + 3 gives Scharr row r + 1, then window row r (j rows
      // past d*): its template from patch rows r + 1 and r + 2, its gradients
      // from Scharr rows r and r + 1. No branch: a lane past the strip's
      // columns computes on clamped columns and neither stores nor sums.
      auto step = [&](float x, int j) {
        const float a = 0.09375f * x, bb = 0.3125f * x;
        const float a2 = __shfl_down_sync(kFull, a, 2);
        const float b1 = __shfl_down_sync(kFull, bb, 1);
        const float b2 = __shfl_down_sync(kFull, bb, 2);
        const float sx = ((((-am2 + a2m2) + -bbm1) + b2m1) + -a) + a2;
        const float sy = ((((-am2 + -b1m2) + -a2m2) + a) + b1) + a2;
        const float yt = omfy * xm2 + fy * xm1;
        const float yx = omfy * sxp + fy * sx;
        const float yy = omfy * syp + fy * sy;
        const float yt1 = __shfl_down_sync(kFull, yt, 1);
        const float yt2 = __shfl_down_sync(kFull, yt, 2);
        const float yx1 = __shfl_down_sync(kFull, yx, 1);
        const float yy1 = __shfl_down_sync(kFull, yy, 1);
        const float vt = omfx * yt1 + fx * yt2;
        const float vx = omfx * yx + fx * yx1;
        const float vy = omfx * yy + fx * yy1;
        if constexpr (STAGED) {
          const unsigned d = 4u * j * win;
          st3_shared_if(st0 + d, st1 + d, st2 + d, vt, vx, vy, out);
        } else {
          const size_t d = (size_t)j * win;
          st3_global_if(dt + d, dx + d, dy + d, vt, vx, vy, out && live);
        }
        const float ux = out ? vx : 0.f, uy = out ? vy : 0.f;
        gxx += ux * ux;
        gxy += ux * uy;
        gyy += uy * uy;
        sxp = sx;
        syp = sy;
        xm2 = xm1;
        xm1 = x;
        am2 = am1;
        am1 = a;
        a2m2 = a2m1;
        a2m1 = a2;
        b1m2 = b1m1;
        b1m1 = b1;
        bbm1 = bb;
        b2m1 = b2;
      };
      if constexpr (WIN > 0) {
        dt = L.tmpl + o + col0 + lane;
        dx = L.out_gx + o + col0 + lane;
        dy = L.out_gy + o + col0 + lane;
#pragma unroll
        for (int j = 0; j < WIN; ++j) step(xs[j], j);
      } else {
        // Chunks of kBuildChunk window rows. Their patch rows come into
        // registers, the next chunk's loads issued before this chunk's steps
        // (clamped to the last row: a load past it is never used). Staged,
        // their rows go to one of two buffers, laid out as the window's rows
        // lie in global memory (each plane after up to 3 floats, so that
        // 16-byte units match); after a block barrier the item's threads
        // copy the chunk out as 16-byte stores, unaligned ends as 4-byte
        // ones. Unstaged, each row goes out directly.
        const int SP = build_stage_plane(win);
        float* s_stage = smem + 4 * tab.items * units + (size_t)slot * (build_stage_bytes(win) / 4);
        float* const planes[3] = {L.tmpl + o, L.out_gx + o, L.out_gy + o};
        int sh[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) sh[m] = (int)((reinterpret_cast<uintptr_t>(planes[m]) >> 2) & 3);
        auto target = [&](int buf, int row0) {
          if constexpr (STAGED) {
            st0 = smem_addr(s_stage + (buf * 3 + 0) * SP + sh[0] + col0 + lane);
            st1 = smem_addr(s_stage + (buf * 3 + 1) * SP + sh[1] + col0 + lane);
            st2 = smem_addr(s_stage + (buf * 3 + 2) * SP + sh[2] + col0 + lane);
          } else {
            dt = planes[0] + (size_t)row0 * win + col0 + lane;
            dx = planes[1] + (size_t)row0 * win + col0 + lane;
            dy = planes[2] + (size_t)row0 * win + col0 + lane;
          }
        };
        auto flush = [&](int buf, int row0, int n) {
          if constexpr (!STAGED) return;
          __syncthreads();
          if (!live) return;
          const int E = n * win, tid = 32 * unit + lane, nthr = 32 * units;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            float* g = planes[m] + (size_t)row0 * win;
            const float* s = s_stage + (buf * 3 + m) * SP + sh[m];
            const int head = min((4 - sh[m]) & 3, E), body = (E - head) >> 2;
            if (tid < head) g[tid] = s[tid];
            float4* g4 = reinterpret_cast<float4*>(g + head);
            const float4* s4 = reinterpret_cast<const float4*>(s + head);
            for (int i = tid; i < body; i += nthr) g4[i] = s4[i];
            const int done = head + 4 * body;
            if (tid < E - done) g[done + tid] = s[done + tid];
          }
        };
        const int t_end = win + 2, chunks = win / kBuildChunk;
#pragma unroll
        for (int j = 0; j < kBuildChunk; ++j) xs[j] = raw(min(3 + j, t_end));
        for (int c = 0; c < chunks; ++c) {
          const int t = 3 + (c + 1) * kBuildChunk;
          float xn[kBuildChunk];
#pragma unroll
          for (int j = 0; j < kBuildChunk; ++j) xn[j] = raw(min(t + j, t_end));
          target(c & 1, c * kBuildChunk);
#pragma unroll
          for (int j = 0; j < kBuildChunk; ++j) step(xs[j], j);
          flush(c & 1, c * kBuildChunk, kBuildChunk);
#pragma unroll
          for (int j = 0; j < kBuildChunk; ++j) xs[j] = xn[j];
        }
        const int rest = win - chunks * kBuildChunk;
        if (rest > 0) {
          target(chunks & 1, chunks * kBuildChunk);
          for (int j = 0; j < rest; ++j) step(xs[j], j);
          flush(chunks & 1, chunks * kBuildChunk, rest);
        }
      }
      if (ROUTE != kBuildWide || strip + units >= build_strips(win)) break;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    gxx += __shfl_xor_sync(kFull, gxx, s);
    gxy += __shfl_xor_sync(kFull, gxy, s);
    gyy += __shfl_xor_sync(kFull, gyy, s);
  }
  if (units > 1) {
    // The item's warps' partials, added by its first warp in warp order.
    if (lane == 0) part[warp] = make_float4(gxx, gxy, gyy, 0.f);
    __syncthreads();
    for (int w = 1; unit == 0 && w < units; ++w) {
      const float4 t = part[warp + w];
      gxx += t.x;
      gxy += t.y;
      gyy += t.z;
    }
  }
  if (live && unit == 0 && lane == 0) {
    const float det = gxx * gyy - gxy * gxy;
    const float half_tr = 0.5f * (gxx + gyy);
    const float disc = half_tr * half_tr - det;
    const float min_eig = (half_tr - sqrtf(disc < 0.f ? 0.f : disc)) / (float)npx;
    L.good[k] = (min_eig > tab.min_eig_thresh && valid[k] != 0) ? 1 : 0;
    const float sd = fabsf(det) > 1e-12f ? det : 1.f;
    L.inv00[k] = gyy / sd;
    L.inv01[k] = -gxy / sd;
    L.inv11[k] = gxx / sd;
  }
}

}  // namespace

// planes: 4 pointers per level (prev, gx, gy, cur), coarse to fine, each
// to stream 0's plane; strides: per level the elements from one stream's
// planes to the next's; ints: 5 per level (H, W, mode, clamp_h, keep_ok);
// scales: 1 per level. Points (B, N, 2), valid (B, N). Outputs: pts (B, N,
// 2) float32, ok (B, N) uint8, iters (B, N, n_levels) int32 indexed by level
// number. search_rows is read only when a level takes the
// window rule (modes kVmem and kGather); the gather rule passes 0. Windows
// over kMaxWinWide take the gather rule only (lk_wide_kernel). out_route
// (kReportInts ints) receives the launch report (see `report`).
extern "C" int lk_pyramid_launch(const void* const* planes, const long long* strides,
                                 const int* ints, const float* scales, int n_levels, int H0,
                                 int W0, const void* prev_pts, const void* init_pts,
                                 const void* valid, void* out_pts, void* out_ok,
                                 void* out_iters, int N, int n_streams, int win,
                                 int search_rows, int max_iter, float eps2,
                                 float min_eig_thresh, void* stream, int* out_route) {
  if (n_levels < 1 || n_levels > kMaxLevels || win < 2) return (int)cudaErrorInvalidValue;
  if (n_streams < 1 || n_streams > 65535) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  Table tab = {};
  tab.n = n_levels;
  tab.H0 = H0;
  tab.W0 = W0;
  tab.win = win;
  tab.search_rows = search_rows;
  tab.max_iter = max_iter;
  tab.eps2 = eps2;
  tab.min_eig_thresh = min_eig_thresh;
  bool any_window = false;
  for (int e = 0; e < n_levels; ++e) {
    Level& L = tab.lv[e];
    L.prev = (const float*)planes[4 * e];
    L.gx = (const float*)planes[4 * e + 1];
    L.gy = (const float*)planes[4 * e + 2];
    L.cur = (const float*)planes[4 * e + 3];
    L.stride = strides[e];
    L.H = ints[5 * e];
    L.W = ints[5 * e + 1];
    L.mode = ints[5 * e + 2];
    L.clamp_h = ints[5 * e + 3];
    L.keep_ok = ints[5 * e + 4];
    L.scale = scales[e];
    if (L.mode < kSkip || L.mode > kGather) return (int)cudaErrorInvalidValue;
    any_window = any_window || L.mode == kVmem || L.mode == kGather;
  }
  if (any_window && (search_rows < win + 2 || win > kMaxWinWide))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (win > kMaxWinWide)
    return launch_wide(tab, optin, N, n_streams, prev_pts, init_pts, valid, out_pts, out_ok,
                       out_iters, s, out_route);
  // Shared memory: the warps' partials, the staging buffer, two tile buffers.
  const size_t fixed =
      sizeof(float) * (8 * (size_t)kWarps + 2 * 3 * (size_t)(win + 1) * (win + 1));
  size_t stage = any_window ? (size_t)search_rows * (kLanes + win % 32) : 0;
  if (fixed + sizeof(float) * stage > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  for (int l = 0; l < n_levels; ++l) {
    const Level& L = tab.lv[l];
    const size_t plane = (size_t)L.H * L.W;
    if (L.mode == kXla && plane > stage && fixed + sizeof(float) * plane <= (size_t)optin)
      stage = plane;  // XLA levels that fit are staged whole
  }
  tab.stage_floats = (int)stage;
  const size_t smem = fixed + sizeof(float) * stage;
  if (win == 24 && search_rows == 56)
    return launch<24, 56, 24>(tab, smem, N, n_streams, prev_pts, init_pts, valid, out_pts,
                              out_ok, out_iters, s, kRoute24, optin, out_route);
  if (win <= kMaxWin)
    return launch<0, 0, kMaxWin>(tab, smem, N, n_streams, prev_pts, init_pts, valid, out_pts,
                                 out_ok, out_iters, s, kRouteNarrow, optin, out_route);
  return launch<0, 0, kMaxWinWide>(tab, smem, N, n_streams, prev_pts, init_pts, valid,
                                   out_pts, out_ok, out_iters, s, kRouteWide54, optin,
                                   out_route);
}

// lk_cached_kernel's launcher. ptrs: 8 per level, coarse to fine (cur,
// tmpl, gx, gy, inv00, inv01, inv11, good), each to stream 0's data;
// strides: per level the elements from one stream's plane to the next's;
// ints: 3 per level (H, W, skip); scales: 1 per level. Points (B, N, 2),
// valid (B, N). Outputs: pts (B, N, 2) float32, ok (B, N) uint8, iters (B,
// N, n_levels) int32 indexed by level number. out_route (kCachedReportInts
// ints) receives the route, its dynamic shared memory per block in bytes,
// the opt-in limit read and the keypoints a block. On the warp route the
// template, gx and gy leaves must be 16-byte aligned (the bulk copy's
// rule); a leaf that is not fails the launch.
constexpr int kCachedReportInts = 4;

extern "C" int lk_cached_launch(const void* const* ptrs, const long long* strides,
                                const int* ints, const float* scales, int n_levels,
                                const void* init_pts, const void* valid, void* out_pts,
                                void* out_ok, void* out_iters, int N, int n_streams, int win,
                                int slack, int max_iter, float eps2, void* stream,
                                int* out_route) {
  if (n_levels < 1 || n_levels > kMaxLevels || win < 2 || slack < 0)
    return (int)cudaErrorInvalidValue;
  if (n_streams < 1 || n_streams > 65535) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  CachedTable tab = {};
  tab.n = n_levels;
  tab.win = win;
  tab.slack = slack;
  tab.max_iter = max_iter;
  tab.eps2 = eps2;
  tab.N = N;
  bool aligned = true;
  for (int e = 0; e < n_levels; ++e) {
    CachedLevel& L = tab.lv[e];
    L.cur = (const float*)ptrs[8 * e];
    L.tmpl = (const float*)ptrs[8 * e + 1];
    L.gx = (const float*)ptrs[8 * e + 2];
    L.gy = (const float*)ptrs[8 * e + 3];
    L.inv00 = (const float*)ptrs[8 * e + 4];
    L.inv01 = (const float*)ptrs[8 * e + 5];
    L.inv11 = (const float*)ptrs[8 * e + 6];
    L.good = (const uint8_t*)ptrs[8 * e + 7];
    L.stride = strides[e];
    L.H = ints[3 * e];
    L.W = ints[3 * e + 1];
    L.skip = ints[3 * e + 2];
    L.scale = scales[e];
    if (!L.skip && (L.H < 1 || L.W < 1)) return (int)cudaErrorInvalidValue;
    if (!L.skip)
      aligned = aligned && ((uintptr_t)L.tmpl | (uintptr_t)L.gx | (uintptr_t)L.gy) % 16 == 0;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const CachedPlan p = plan_cached(win, slack, optin);
  const cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (p.route == kCachedWarp)
    rc = aligned ? launch_cached_warp(tab, p, N, n_streams, init_pts, valid, out_pts, out_ok,
                                      out_iters, s)
                 : (int)cudaErrorMisalignedAddress;
  else if (p.route == kCachedShared)
    rc = launch_cached<kCachedShared>(tab, p.smem, N, n_streams, init_pts, valid, out_pts, out_ok,
                                      out_iters, s);
  else if (p.route == kCachedPatch)
    rc = launch_cached<kCachedPatch>(tab, p.smem, N, n_streams, init_pts, valid, out_pts, out_ok,
                                     out_iters, s);
  else
    rc = launch_cached<kCachedGlobal>(tab, p.smem, N, n_streams, init_pts, valid, out_pts, out_ok,
                                      out_iters, s);
  if (rc == 0) {
    const int r[kCachedReportInts] = {p.route, p.smem, optin, p.warps};
    for (int i = 0; i < kCachedReportInts; ++i) out_route[i] = r[i];
  }
  return rc;
}

// lk_cache_build_kernel's launcher: one launch for every level of every
// stream. ptrs: 10 per level the window fits in, in any order (img, gx, gy
// -- both null: Scharr on the patch -- then the outputs tmpl, gx, gy, inv00,
// inv01, inv11, good), each to stream 0's data; strides: per level the
// elements from one stream's plane to the next's; ints: 2 per level (H, W);
// divs: per level 2^level. Points (B, N, 2) at level 0, valid (B, N).
// Outputs per level: (B, N, win, win) float32 tmpl, gx, gy; (B, N) float32
// inv00, inv01, inv11; (B, N) uint8 good. out_report (kBuildReportInts
// ints) receives the dynamic shared memory per block in bytes, then the
// plan (`plan_build`: staged rows, route, strips, items a block, threads a
// block) and the opt-in limit it read.
extern "C" int lk_cache_build_launch(const void* const* ptrs, const long long* strides,
                                     const int* ints, const float* divs, int n_levels,
                                     const void* pts, const void* valid, int N, int n_streams,
                                     int win, float min_eig_thresh, void* stream,
                                     int* out_report) {
  if (n_levels < 0 || n_levels > kMaxLevels || win < 2) return (int)cudaErrorInvalidValue;
  if (n_streams < 1 || n_streams > 65535) return (int)cudaErrorInvalidValue;
  if (N <= 0 || n_levels == 0) return 0;
  BuildTable tab = {};
  tab.N = N;
  tab.win = win;
  tab.min_eig_thresh = min_eig_thresh;
  bool grads = false;
  for (int l = 0; l < n_levels; ++l) {
    BuildLevel& L = tab.lv[l];
    const void* const* q = ptrs + 10 * l;
    L.img = (const float*)q[0];
    L.gx = (const float*)q[1];
    L.gy = (const float*)q[2];
    L.tmpl = (float*)q[3];
    L.out_gx = (float*)q[4];
    L.out_gy = (float*)q[5];
    L.inv00 = (float*)q[6];
    L.inv01 = (float*)q[7];
    L.inv11 = (float*)q[8];
    L.good = (uint8_t*)q[9];
    L.stride = strides[l];
    L.H = ints[2 * l];
    L.W = ints[2 * l + 1];
    L.div = divs[l];
    if (L.H < win + 2 || L.W < win + 2 || (L.gx == nullptr) != (L.gy == nullptr) ||
        (l > 0 && (L.gx == nullptr) != (tab.lv[0].gx == nullptr)))
      return (int)cudaErrorInvalidValue;
    grads = grads || L.gx != nullptr;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const BuildPlan p = plan_build(win, grads, optin);
  tab.units = p.threads / (32 * p.items);
  tab.items = p.items;
  // The instantiation: gradients, the compiled-in window, any other with
  // its rows stored directly or staged, and the wide route.
  const void* const kernels[5] = {
      (const void*)lk_cache_build_kernel<kBuildGrads, 0, false>,
      (const void*)lk_cache_build_kernel<kBuildSweep, kBuildFixedWin, false>,
      (const void*)lk_cache_build_kernel<kBuildSweep, 0, false>,
      (const void*)lk_cache_build_kernel<kBuildSweep, 0, true>,
      (const void*)lk_cache_build_kernel<kBuildWide, 0, false>};
  const int ki = p.route == kBuildGrads  ? 0
                 : p.route == kBuildWide ? 4
                 : win == kBuildFixedWin ? 1
                 : p.staged              ? 3
                                         : 2;
  const int rc = set_smem(kernels[ki], p.smem);
  if (rc != 0) return rc;
  const dim3 grid((N + p.items - 1) / p.items, n_levels, n_streams);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* P = (const float*)pts;
  const uint8_t* V = (const uint8_t*)valid;
  if (ki == 0)
    lk_cache_build_kernel<kBuildGrads, 0, false><<<grid, p.threads, p.smem, s>>>(tab, P, V);
  else if (ki == 1)
    lk_cache_build_kernel<kBuildSweep, kBuildFixedWin, false><<<grid, p.threads, p.smem, s>>>(tab, P, V);
  else if (ki == 2)
    lk_cache_build_kernel<kBuildSweep, 0, false><<<grid, p.threads, p.smem, s>>>(tab, P, V);
  else if (ki == 3)
    lk_cache_build_kernel<kBuildSweep, 0, true><<<grid, p.threads, p.smem, s>>>(tab, P, V);
  else
    lk_cache_build_kernel<kBuildWide, 0, false><<<grid, p.threads, p.smem, s>>>(tab, P, V);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    const int r[kBuildReportInts] = {p.smem, p.staged, p.route, p.strips, p.items, p.threads, optin};
    for (int i = 0; i < kBuildReportInts; ++i) out_report[i] = r[i];
  }
  return (int)e;
}

extern "C" const char* lk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
