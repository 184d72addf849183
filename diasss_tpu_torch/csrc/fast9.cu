// FAST-9 at two thresholds with frame mask and 3x3 non-maximum suppression,
// for every pyramid level of one frame in one launch.  Hopper (sm_90a),
// plain C entry point for ctypes.
//
// Replaces the TPU kernel diasss_tpu/features/fast_pallas.py:_fast_tile_kernel
// (entered through fast_score_pallas) together with the frame mask and NMS
// that the detector applies to its output.  Same function as the plain torch
// version diasss_tpu_torch/features/fast.py:fast_two_threshold_plain: per
// level of shape (n, m) and per threshold t in (ini_t, min_t),
//
//   out_t = nms3(frame_mask(fast_score(img, t)))
//
// fast_score: the 16 Bresenham-circle differences to the centre, min and max
// over every circular 9-of-16 arc, score = max(max_s arc_min, -min_s
// arc_max), zeroed where it is <= t; frame_mask zeroes the 3-px frame of the
// level's own (n, m); nms3 keeps a score that is >= every score of its 3x3
// neighbourhood inside the image (max-pool with -inf padding), else 0.
// Subtraction, min, max and comparisons of float32 are exact and order-free,
// and with the frame zeroed no output depends on pixels past the border, so
// the result equals the plain version bit for bit on the whole map.
//
// Bound: operations.  Per pixel 4 bytes are read and 8 written (both maps),
// against about 160 float32 instructions: 16 differences, 56 prefix and
// suffix min/max and 32 arc min/max (below), 32 for the extrema over the
// 16 arcs, 4 for the score and the 2 thresholds, 18 for NMS (two 3x3 maxima
// and compares).  At 33.5 T instructions/s (67 TFLOP/s counting an FMA as
// two) that is 4.3 us for the 893k pixels of a 600x512 pyramid, against
// 3.2 us for its 10.7 MB at 3.35 TB/s.  At the pyramid's sizes the launch
// itself (a few us) is of the same order, so one launch serves all levels.
//
// Design: one launch per frame.  The entry point takes the levels' pointers
// and shapes from host arrays and passes them by value (a table of at most
// MAX_LEVELS levels, each with its first block index) as a kernel
// parameter: no host-to-device copy, no synchronisation.  A 1-D grid of
// blocks, each a 32x32 output tile of one level; a block finds its level by
// an unrolled scan of the table.  256 threads (32x8) per block:
//   1. stage the (32+8) x (32+8) input tile (4-px halo: 3 for the circle, 1
//      for NMS) in shared memory, zeros past the image;
//   2. compute the score once for the (32+2) x (32+2) tile that NMS needs
//      (13% recomputed ring) and store both thresholded values as a float2,
//      0 in the frame and -inf past the image;
//   3. each thread suppresses 4 consecutive output rows of one column at
//      both thresholds, from the 3-wide maxima of 6 score rows that the 4
//      share, and writes both maps; warps write 128-B rows.
// Each score keeps its 16 differences in registers.  The 16 circular 9-arcs
// are cut at two blocks of 8: the arc from s is the suffix of s's block from
// s and the prefix of the other block up to s + 8, so its min and max are
// one operation each on running prefix and suffix extrema (88 operations
// for all arc extrema instead of 128 for a 2 -> 4 -> 8 -> 9 log tree).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TW = 32;             // output tile width (one warp)
constexpr int TH = 32;             // output tile height
constexpr int BY = 8;              // thread rows: TH / BY outputs per thread
constexpr int HALO = 4;            // 3 for the circle + 1 for NMS
constexpr int IW = TW + 2 * HALO;  // input tile
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;         // score tile (1-px NMS ring)
constexpr int SH = TH + 2;
constexpr int FRAME = 3;

struct Level {
  const float* img;
  float* out;  // s_hi (n*m floats), then s_lo (n*m floats)
  int n, m, tiles_x, first_block;
};

struct Levels {
  Level l[MAX_LEVELS];
  int count;
};

// circle offsets (dx, dy), clockwise from 12 o'clock: fast.CIRCLE
__device__ __forceinline__ int circle_dx(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}
__device__ __forceinline__ int circle_dy(int k) {
  constexpr int dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return dy[k];
}

// FAST-9 score of the pixel at (cy, cx) of the input tile, not thresholded
__device__ __forceinline__ float segment_score(float (*tile)[IW], int cy, int cx) {
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[cy + circle_dy(k)][cx + circle_dx(k)] - c;
  // The circle as two blocks of 8: the 9-arc from s is the suffix of s's
  // block from s and the prefix of the other block up to s + 8 (the same
  // offset), so its extrema come from prefix and suffix extrema.
  float pmn[16], pmx[16], smn[16], smx[16];
#pragma unroll
  for (int b = 0; b < 16; b += 8) {
    pmn[b] = pmx[b] = d[b];
    smn[b + 7] = smx[b + 7] = d[b + 7];
#pragma unroll
    for (int o = 1; o < 8; ++o) {
      pmn[b + o] = fminf(pmn[b + o - 1], d[b + o]);
      pmx[b + o] = fmaxf(pmx[b + o - 1], d[b + o]);
      smn[b + 7 - o] = fminf(smn[b + 8 - o], d[b + 7 - o]);
      smx[b + 7 - o] = fmaxf(smx[b + 8 - o], d[b + 7 - o]);
    }
  }
  float bright = -INFINITY;  // max_s arc_min
  float dark = INFINITY;     // min_s arc_max
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright = fmaxf(bright, fminf(smn[k], pmn[(k + 8) & 15]));
    dark = fminf(dark, fmaxf(smx[k], pmx[(k + 8) & 15]));
  }
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(TW * BY)
fast9_two_threshold_kernel(const __grid_constant__ Levels p, float ini_t, float min_t) {
  __shared__ float tile[IH][IW];
  __shared__ float2 score[SH][SW];  // (s_hi, s_lo) before NMS

  // this block's level: the last one whose first block is <= blockIdx.x
  // (unrolled, so the table stays in the parameter bank)
  const int b = blockIdx.x;
  Level lv = p.l[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < p.count && b >= p.l[i].first_block) lv = p.l[i];
  const int n = lv.n, m = lv.m;
  const int t = b - lv.first_block;
  const int y0 = (t / lv.tiles_x) * TH;
  const int x0 = (t % lv.tiles_x) * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < IH * IW; i += TW * BY) {
    const int ty = i / IW, tx = i - (i / IW) * IW;
    const int gy = y0 - HALO + ty, gx = x0 - HALO + tx;
    tile[ty][tx] = (gy >= 0 && gy < n && gx >= 0 && gx < m) ? lv.img[static_cast<size_t>(gy) * m + gx] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < SH * SW; i += TW * BY) {
    const int sy = i / SW, sx = i - (i / SW) * SW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float2 v;
    if (gy < 0 || gy >= n || gx < 0 || gx >= m) {
      v = make_float2(-INFINITY, -INFINITY);  // NMS ignores pixels past the image
    } else if (gy < FRAME || gy >= n - FRAME || gx < FRAME || gx >= m - FRAME) {
      v = make_float2(0.0f, 0.0f);
    } else {
      const float s = segment_score(tile, sy + HALO - 1, sx + HALO - 1);
      v = make_float2(s > ini_t ? s : 0.0f, s > min_t ? s : 0.0f);
    }
    score[sy][sx] = v;
  }
  __syncthreads();

  // NMS: thread (tx, ty) takes the 4 output rows 4 ty .. 4 ty + 3 of column
  // tx; the 3-wide row maxima of score rows 4 ty .. 4 ty + 5 serve all four
  const int gx = x0 + threadIdx.x;
  if (gx >= m) return;
  constexpr int RPT = TH / BY;  // output rows per thread
  float2 c[RPT + 2], hmax[RPT + 2];
#pragma unroll
  for (int r = 0; r < RPT + 2; ++r) {
    const float2 a = score[RPT * threadIdx.y + r][threadIdx.x];
    c[r] = score[RPT * threadIdx.y + r][threadIdx.x + 1];
    const float2 e = score[RPT * threadIdx.y + r][threadIdx.x + 2];
    hmax[r] = make_float2(fmaxf(fmaxf(a.x, c[r].x), e.x), fmaxf(fmaxf(a.y, c[r].y), e.y));
  }
  const size_t plane = static_cast<size_t>(n) * m;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int gy = y0 + RPT * threadIdx.y + j;
    if (gy >= n) break;
    const float mhi = fmaxf(fmaxf(hmax[j].x, hmax[j + 1].x), hmax[j + 2].x);
    const float mlo = fmaxf(fmaxf(hmax[j].y, hmax[j + 1].y), hmax[j + 2].y);
    const size_t at = static_cast<size_t>(gy) * m + gx;
    lv.out[at] = c[j + 1].x >= mhi ? c[j + 1].x : 0.0f;
    lv.out[plane + at] = c[j + 1].y >= mlo ? c[j + 1].y : 0.0f;
  }
}

}  // namespace

// Launch one grid for all L levels on `stream` (a cudaStream_t passed as
// void*); returns cudaGetLastError().  img[l]: (n[l], m[l]) float32; out[l]:
// 2 * n[l] * m[l] float32 (s_hi, then s_lo); pointers as 64-bit integers.
extern "C" int fast9_two_threshold(int L, const long long* img, const long long* out, const int* n,
                                   const int* m, float ini_t, float min_t, void* stream) {
  if (L < 1 || L > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Levels p = {};
  long long blocks = 0;
  for (int l = 0; l < L; ++l) {
    if (n[l] < 0 || m[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles_x = (m[l] + TW - 1) / TW;
    const int tiles_y = (n[l] + TH - 1) / TH;
    p.l[l] = Level{reinterpret_cast<const float*>(img[l]), reinterpret_cast<float*>(out[l]), n[l], m[l],
                   tiles_x > 0 ? tiles_x : 1, static_cast<int>(blocks)};
    blocks += static_cast<long long>(tiles_x) * tiles_y;
  }
  p.count = L;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fast9_two_threshold_kernel<<<static_cast<unsigned>(blocks), dim3(TW, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      p, ini_t, min_t);
  return static_cast<int>(cudaGetLastError());
}
