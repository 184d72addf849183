// FAST-9 corner score for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the TPU kernel diasss_tpu/features/fast_pallas.py:_fast_tile_kernel
// (entered through fast_score_pallas).  Same math as the plain torch version
// diasss_tpu_torch/features/fast.py:fast_score_plain: for each pixel the 16
// Bresenham-circle differences to the centre, the min and max over every
// circular 9-of-16 arc, score = max(max_s arc_min, -min_s arc_max), zeroed
// where it is <= threshold.  Subtraction, min and max of float32 are exact and
// order-free, so the result equals the plain version bit for bit wherever the
// circle stays inside the image; the 3-px frame differs (this kernel clamps
// the halo at the borders, the plain version wraps) and the detector zeroes
// that frame.
//
// Bound: device memory.  Each pixel is read once from DRAM (4 B) and written
// once (4 B); the ~130 float ops per pixel are far below the compute roof.
// Design: one thread per output pixel in 32x8 blocks; each block stages its
// (8+6) x (32+6) halo tile in shared memory with clamped indices, so the 17
// taps per pixel hit shared memory, not DRAM.  Warps read consecutive columns
// (coalesced rows).  Each thread keeps its 16 differences in registers and
// forms the 9-long arc extrema with the log tree 2 -> 4 -> 8 -> 9.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BW = 32;
constexpr int BH = 8;
constexpr int HALO = 3;
constexpr int TW = BW + 2 * HALO;
constexpr int TH = BH + 2 * HALO;

// circle offsets (dx, dy), clockwise from 12 o'clock: fast.CIRCLE
__device__ __forceinline__ int circle_dx(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}
__device__ __forceinline__ int circle_dy(int k) {
  constexpr int dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return dy[k];
}

__global__ void __launch_bounds__(BW * BH)
fast9_kernel(const float* __restrict__ img, float* __restrict__ out, int n, int m, float thr) {
  __shared__ float tile[TH][TW];
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.y * BW + threadIdx.x;
  for (int i = tid; i < TH * TW; i += BW * BH) {
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int gy = min(max(y0 + ty - HALO, 0), n - 1);
    const int gx = min(max(x0 + tx - HALO, 0), m - 1);
    tile[ty][tx] = img[static_cast<size_t>(gy) * m + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= m || y >= n) return;
  const int cy = threadIdx.y + HALO;
  const int cx = threadIdx.x + HALO;
  const float c = tile[cy][cx];

  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[cy + circle_dy(k)][cx + circle_dx(k)] - c;

  // arc extrema over d[s..s+8] (circular): windows of 2, 4, 8, then 9
  float mn2[16], mx2[16], mn4[16], mx4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn2[k] = fminf(d[k], d[(k + 1) & 15]);
    mx2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn4[k] = fminf(mn2[k], mn2[(k + 2) & 15]);
    mx4[k] = fmaxf(mx2[k], mx2[(k + 2) & 15]);
  }
  float bright = -INFINITY;  // max_s arc_min
  float dark = INFINITY;     // min_s arc_max
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float mn9 = fminf(fminf(mn4[k], mn4[(k + 4) & 15]), d[(k + 8) & 15]);
    const float mx9 = fmaxf(fmaxf(mx4[k], mx4[(k + 4) & 15]), d[(k + 8) & 15]);
    bright = fmaxf(bright, mn9);
    dark = fminf(dark, mx9);
  }
  const float score = fmaxf(bright, -dark);
  out[static_cast<size_t>(y) * m + x] = score > thr ? score : 0.0f;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*); returns cudaGetLastError().
extern "C" int fast9_score(const float* img, float* out, int n, int m, float thr, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH);
  const dim3 grid((m + BW - 1) / BW, (n + BH - 1) / BH);
  fast9_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, n, m, thr);
  return static_cast<int>(cudaGetLastError());
}
