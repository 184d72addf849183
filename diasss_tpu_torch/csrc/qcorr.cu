// Dense-NCC q-correlation for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the TPU kernel diasss_tpu/matching/dense_pallas.py:_qcorr_kernel
// (entered through qcorr_pallas).  Same function as the plain torch version
// diasss_tpu_torch/matching/dense.py:qcorr_plain: for every keypoint r and
// every output cell (t1, t2) of the (T, T) stride-1 offset grid,
//
//   A[r, t1, t2] = sum_{g < k*k} q[r, g] * Wvh[r, t1 + g / k, t2 + g % k]
//   B[r, t1, t2] = sum_{g < k*k} q[r, g] * Wh [r, t1 + g / k, t2 + g % k]
//
// with S = T + k - 1.  Every output cell sums over g in ascending order, as
// the plain version does, but each step is one fused multiply-add (fmaf)
// where the plain version rounds the product and the sum separately.  The
// two differ by a few ulp of the sums: at most 2e-5 in absolute value for
// windows in [0, 1] and unit-norm q (289 steps at k = 17, every term
// |q_g W_g| <= 1), the tolerance the tests and the smoke test hold.
//
// Bound: operations.  4 K T^2 k^2 float32 flops (an FMA counts as two, two
// maps) against 4 K (2 S^2 + k^2 + 2 T^2) bytes read once and written once:
// at the automatic profile's round 0 (K = 12000, k = 17, T = 43) 25.6 GFLOP,
// 0.38 ms at 67 TFLOP/s, against 526 MB, 0.16 ms at 3.35 TB/s.
//
// No tensor cores.  As a matrix product the correlation is a Toeplitz GEMM:
// per keypoint and map, (T^2 x k^2) times k^2, or, row by row, T shifted
// copies of an S-wide window row against k taps, which wastes about S/k =
// 3.5x of its products on structural zeros.  TF32 keeps about 3 decimal
// digits, enough to flip NCC argmaxes between near-equal offsets, and the
// 3xTF32 split that restores float32 accuracy costs 3x the products again:
// at 3.5 x 3 = 10.5x the work it cannot beat the float32 FMA bound.
//
// Design: one CTA per keypoint (K CTAs).  The keypoint's two windows and
// its q are staged once in shared memory by 4-byte cp.async copies, all in
// flight before one wait (staging through registers waited on every
// load).  The windows are zero-padded to
// SW = ceil(T/R)*R + k - 1 rows at a row stride SP = SW rounded up to 4
// floats, so every row is 16-byte aligned and the last tiles read zeros
// instead of running past S (at T = 43 the tiles cover 44 x 44 cells; only
// cells below T are stored).  q is then rearranged as a table qq[yy][dx] of
// R floats, qq[yy][dx][r] = q[yy - r][dx] (0 where yy - r is not a patch
// row), so that one 16-byte broadcast load gives the q value of every row
// of a tile.
//
// Each thread owns an R x C = 4 x 4 block of output cells of both maps (32
// accumulators).  It walks the input rows yy = 0 .. R + k - 2 relative to
// its tile: for each it loads the C + k - 1 window values of both maps that
// the tile's columns reach (16-byte loads; 8 consecutive threads mostly hit
// 8 distinct 4-bank groups), then for each dx loads the R q values and does
// R * C fused multiply-adds per map, output row r taking patch row dy =
// yy - r, so every cell still sums g ascending.  Per 32 FMAs that is one
// shared 16-byte load of q (a warp-uniform broadcast) and, per input row,
// 2 * (C + k - 1) / 4 = 10 window loads for 17 * 32 FMAs.  k is a template
// parameter (k = 17, the production patch): the dx loop unrolls and the
// window stays in registers.  The first and last R - 1 input rows feed
// fewer than R output rows; a warp-uniform branch sends each row to an
// instantiation that knows its output rows at compile time (no
// multiply-add by a zero q), inside one row loop that is not unrolled, so
// that only one row's window is live (unrolled, far more registers).  A
// generic instantiation serves any other k (the tests use k = 3 and 5): it
// slides a C-wide register window along the shared row, one new value per
// map per dx, and multiplies by the zero entries of qq instead of
// branching.  Consecutive threads take consecutive tiles of a tile row; the
// block has as many threads as there are tiles, rounded up to a warp, at
// most 128 for k = 17 (121 of 128 at T = 43, 25 of 32 at T = 19) and 256
// otherwise.  Windows larger than the default 48 KB of dynamic shared
// memory opt in up to the card's limit (227 KB on H100: S <= 168 at
// k = 17); beyond it the launch is refused.

#include <cuda_runtime.h>

namespace {

constexpr int R = 4;  // output rows per thread tile (one float4 of q)
constexpr int C = 4;  // output columns per thread tile
constexpr int MAX_THREADS = 256;  // generic k
constexpr int FIXED_THREADS = 128;  // k = 17: a T = 43 keypoint's 121 tiles
constexpr int K_FIXED = 17;  // the production patch, 2 * geopatch_half + 1

struct Geometry {
  int nt;  // tiles per side
  int sw;  // padded window side (rows, and columns reached)
  int sp;  // row stride, floats
};

__host__ __device__ inline Geometry geometry(int T, int k) {
  Geometry g;
  g.nt = (T + R - 1) / R;
  g.sw = g.nt * R + k - 1;
  g.sp = (g.sw + 3) / 4 * 4;
  return g;
}

__host__ inline size_t smem_bytes(int T, int k) {
  const Geometry g = geometry(T, k);
  // q table (R floats per (yy, dx)), the two padded windows, the raw patch
  return sizeof(float) *
         (static_cast<size_t>(R + k - 1) * k * R + 2 * static_cast<size_t>(g.sw) * g.sp + static_cast<size_t>(k) * k);
}

typedef float Acc[R][C];

// One input row of a tile with k = KT, feeding output rows RLO..RHI: load the
// row's C + KT - 1 values of both maps into registers, then KT steps of
// (RHI - RLO + 1) * C fused multiply-adds per map.
template <int KT, int RLO, int RHI>
__device__ __forceinline__ void row_fixed(const float* __restrict__ rv, const float* __restrict__ rh,
                                          const float4* __restrict__ qrow, Acc& acc_a, Acc& acc_b) {
  constexpr int NV = (C + KT - 1 + 3) / 4;
  float v[4 * NV], h[4 * NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 a = reinterpret_cast<const float4*>(rv)[j];
    const float4 b = reinterpret_cast<const float4*>(rh)[j];
    v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z, v[4 * j + 3] = a.w;
    h[4 * j] = b.x, h[4 * j + 1] = b.y, h[4 * j + 2] = b.z, h[4 * j + 3] = b.w;
  }
#pragma unroll
  for (int dx = 0; dx < KT; ++dx) {
    const float4 q4 = qrow[dx];
    const float qr[R] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int r = RLO; r <= RHI; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc_a[r][c] = fmaf(qr[r], v[dx + c], acc_a[r][c]);
        acc_b[r][c] = fmaf(qr[r], h[dx + c], acc_b[r][c]);
      }
    }
  }
}

// All input rows of one tile, k = KT fixed: ramp-up rows yy < R - 1 feed
// output rows 0..yy, the steady rows all R, the ramp-down rows yy >= KT feed
// rows yy - KT + 1..R-1.  One row per iteration of a loop that is not
// unrolled, with a warp-uniform branch to the row's instantiation, so that
// the compiler keeps one row's window in registers at a time.
template <int KT>
__device__ __forceinline__ void tile_fixed(const float* rv, const float* rh, const float4* qq, int sp, Acc& acc_a,
                                           Acc& acc_b) {
  static_assert(R == 4 && KT >= R - 1, "the peeled rows assume R = 4 and k >= R - 1");
#pragma unroll 1
  for (int yy = 0; yy < KT + R - 1; ++yy) {
    const float* v = rv + yy * sp;
    const float* h = rh + yy * sp;
    const float4* qrow = qq + yy * KT;
    if (yy >= R - 1 && yy < KT) {
      row_fixed<KT, 0, 3>(v, h, qrow, acc_a, acc_b);
    } else if (yy == 0) {
      row_fixed<KT, 0, 0>(v, h, qrow, acc_a, acc_b);
    } else if (yy == 1) {
      row_fixed<KT, 0, 1>(v, h, qrow, acc_a, acc_b);
    } else if (yy == 2) {
      row_fixed<KT, 0, 2>(v, h, qrow, acc_a, acc_b);
    } else if (yy == KT) {
      row_fixed<KT, 1, 3>(v, h, qrow, acc_a, acc_b);
    } else if (yy == KT + 1) {
      row_fixed<KT, 2, 3>(v, h, qrow, acc_a, acc_b);
    } else {
      row_fixed<KT, 3, 3>(v, h, qrow, acc_a, acc_b);
    }
  }
}

// All input rows of one tile, any k: a C-wide register window slides along
// each shared row; q entries of rows outside the patch are zero.
__device__ __forceinline__ void tile_generic(const float* rv, const float* rh, const float4* qq, int sp, int k,
                                             Acc& acc_a, Acc& acc_b) {
  for (int yy = 0; yy < R + k - 1; ++yy) {
    const float* sv = rv + yy * sp;
    const float* sh = rh + yy * sp;
    float v[C], h[C];
#pragma unroll
    for (int c = 0; c < C - 1; ++c) v[c] = sv[c], h[c] = sh[c];
    for (int dx = 0; dx < k; ++dx) {
      v[C - 1] = sv[dx + C - 1];
      h[C - 1] = sh[dx + C - 1];
      const float4 q4 = qq[yy * k + dx];
      const float qr[R] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc_a[r][c] = fmaf(qr[r], v[c], acc_a[r][c]);
          acc_b[r][c] = fmaf(qr[r], h[c], acc_b[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C - 1; ++c) v[c] = v[c + 1], h[c] = h[c + 1];
    }
  }
}

// 4-byte asynchronous copy global -> shared (no register round trip); zeros
// where `in` is false (then `src` is not read).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int KT>
__global__ void __launch_bounds__(KT > 0 ? FIXED_THREADS : MAX_THREADS)
qcorr_kernel(const float* __restrict__ wvh, const float* __restrict__ wh, const float* __restrict__ q,
             float* __restrict__ a, float* __restrict__ b, int S, int k_arg, int T) {
  extern __shared__ float4 smem4[];
  const int k = KT > 0 ? KT : k_arg;
  const Geometry g = geometry(T, k);
  float4* qq = smem4;  // (R + k - 1) * k entries
  float* sv = reinterpret_cast<float*>(smem4 + (R + k - 1) * k);
  float* sh = sv + g.sw * g.sp;
  float* sq = sh + g.sw * g.sp;  // the raw k * k patch
  const size_t r0 = blockIdx.x;
  const float* gv = wvh + r0 * S * S;
  const float* gh = wh + r0 * S * S;
  const float* gq = q + r0 * k * k;

  // windows (one warp per row, zeros past S) and q, all copies in flight at once
  const int lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
  for (int y = threadIdx.x >> 5; y < g.sw; y += warps) {
    for (int x = lane; x < g.sp; x += 32) {
      const bool in = y < S && x < S;
      const int at = in ? y * S + x : 0;
      cp_async_f32(sv + y * g.sp + x, gv + at, in);
      cp_async_f32(sh + y * g.sp + x, gh + at, in);
    }
  }
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) cp_async_f32(sq + i, gq + i, true);
  cp_async_wait_all();
  __syncthreads();
  // q table: qq[yy * k + dx] = (q[yy][dx], q[yy - 1][dx], q[yy - 2][dx], q[yy - 3][dx]), 0 outside the patch
  for (int i = threadIdx.x; i < (R + k - 1) * k; i += blockDim.x) {
    const int yy = i / k;
    const int dx = i - yy * k;
    float e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) e[r] = (yy - r >= 0 && yy - r < k) ? sq[(yy - r) * k + dx] : 0.0f;
    qq[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  __syncthreads();

  float* ga = a + r0 * T * T;
  float* gb = b + r0 * T * T;
  for (int w = threadIdx.x; w < g.nt * g.nt; w += blockDim.x) {
    const int t1 = (w / g.nt) * R;
    const int t2 = (w % g.nt) * C;
    Acc acc_a, acc_b;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc_a[r][c] = acc_b[r][c] = 0.0f;
    }
    const float* rv = sv + t1 * g.sp + t2;
    const float* rh = sh + t1 * g.sp + t2;
    if constexpr (KT > 0) {
      tile_fixed<KT>(rv, rh, qq, g.sp, acc_a, acc_b);
    } else {
      tile_generic(rv, rh, qq, g.sp, k, acc_a, acc_b);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (t1 + r < T && t2 + c < T) {
          ga[(t1 + r) * T + t2 + c] = acc_a[r][c];
          gb[(t1 + r) * T + t2 + c] = acc_b[r][c];
        }
      }
    }
  }
}

template <int KT>
int launch(const float* wvh, const float* wh, const float* q, float* a, float* b, int K, int S, int k, int T,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(qcorr_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = geometry(T, k).nt * geometry(T, k).nt;
  const int warps_up = (tiles + 31) / 32 * 32;
  const int cap = KT > 0 ? FIXED_THREADS : MAX_THREADS;
  const int threads = warps_up < cap ? warps_up : cap;
  qcorr_kernel<KT><<<K, threads, smem, stream>>>(wvh, wh, q, a, b, S, k, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one keypoint's CTA needs for windows of S x S and
// k x k patches.
extern "C" long long qcorr_smem_bytes(int S, int k) {
  return static_cast<long long>(smem_bytes(S - k + 1, k));
}

// The largest dynamic shared memory a block may opt in to on the current device.
extern "C" long long qcorr_smem_limit(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return optin;
}

// Launch on `stream` (a cudaStream_t passed as void*); returns cudaGetLastError().
// wvh, wh: (K, S, S); q: (K, k*k); a, b: (K, T, T); all float32, contiguous.
extern "C" int qcorr(const float* wvh, const float* wh, const float* q, float* a, float* b,
                     int K, int S, int k, int T, void* stream) {
  if (K <= 0 || k <= 0 || T <= 0 || S != T + k - 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T, k);
  const long long limit = qcorr_smem_limit();
  if (limit < 0 || static_cast<long long>(smem) > limit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == K_FIXED) return launch<K_FIXED>(wvh, wh, q, a, b, K, S, k, T, smem, s);
  return launch<0>(wvh, wh, q, a, b, K, S, k, T, smem, s);
}
