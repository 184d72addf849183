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
// with S = T + k - 1.  The sum runs over g in ascending order and every step
// rounds the product and the sum separately (__fmul_rn, __fadd_rn: no fused
// multiply-add), exactly as the plain version's `A = A + q_g * W_g`, so the
// kernel agrees with it bit for bit.
//
// Bound: operations.  4 K T^2 k^2 float32 flops (multiply and add, two maps)
// against 4 K (2 S^2 + k^2 + 2 T^2) bytes read once and written once: at the
// automatic profile's round 0 (K = 12000, k = 17, T = 43) 25.6 GFLOP, 0.38 ms
// at 67 TFLOP/s, against 526 MB, 0.16 ms at 3.35 TB/s.  Without fused
// multiply-adds this kernel can reach at most half of the float32 peak.
//
// Design: one CTA per keypoint.  The keypoint's two (S, S) windows and its
// k*k q values are staged once in shared memory (row stride SP = S rounded up
// to odd, so a warp reading one column of 32 consecutive rows hits 32 banks).
// Each thread owns strips of C = 4 adjacent output cells of one row; for each
// patch row dy it slides a C-wide register window along the shared-memory row
// (one new value per window per dx, C multiply-adds per window), keeping the
// 2C accumulators in registers, and writes each cell once.  Consecutive
// threads take consecutive output rows.  The block has as many threads as
// there are strips (rounded up to a warp, at most 256).  Windows larger than
// the default 48 KB of dynamic shared memory opt in up to the card's limit
// (227 KB on H100: S <= 169 at k = 17); beyond it the launch is refused.

#include <cuda_runtime.h>

namespace {

constexpr int C = 4;          // output cells per thread strip
constexpr int MAX_THREADS = 256;

__host__ __device__ inline int row_stride(int S) { return S | 1; }

__host__ inline size_t smem_bytes(int S, int k) {
  // two windows, q, and C floats of tail slack for the last row's strip reads
  return sizeof(float) * (2 * static_cast<size_t>(S) * row_stride(S) + static_cast<size_t>(k) * k + C);
}

__global__ void __launch_bounds__(MAX_THREADS)
qcorr_kernel(const float* __restrict__ wvh, const float* __restrict__ wh, const float* __restrict__ q,
             float* __restrict__ a, float* __restrict__ b, int S, int k, int T) {
  extern __shared__ float smem[];
  const int SP = row_stride(S);
  float* sv = smem;
  float* sh = sv + S * SP;
  float* sq = sh + S * SP;
  const size_t r = blockIdx.x;
  const float* gv = wvh + r * S * S;
  const float* gh = wh + r * S * S;
  const float* gq = q + r * k * k;

  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int y = i / S;
    const int x = i - y * S;
    sv[y * SP + x] = gv[i];
    sh[y * SP + x] = gh[i];
  }
  for (int i = threadIdx.x; i < k * k + C; i += blockDim.x) sq[i] = i < k * k ? gq[i] : 0.0f;
  for (int i = threadIdx.x; i < S * (SP - S); i += blockDim.x) {  // odd-stride pad column
    const int y = i / (SP - S);
    sv[y * SP + S + (i - y * (SP - S))] = 0.0f;
    sh[y * SP + S + (i - y * (SP - S))] = 0.0f;
  }
  __syncthreads();

  const int n_strips = (T + C - 1) / C;
  float* ga = a + r * T * T;
  float* gb = b + r * T * T;
  for (int w = threadIdx.x; w < T * n_strips; w += blockDim.x) {
    const int t1 = w % T;
    const int t2 = (w / T) * C;
    float acc_a[C], acc_b[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc_a[c] = acc_b[c] = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      // cells past T read past the row end (into the next row, or the tail
      // slack after the last one); they are never stored
      const float* rv = sv + (t1 + dy) * SP + t2;
      const float* rh = sh + (t1 + dy) * SP + t2;
      const float* qrow = sq + dy * k;
      float bv[C], bh[C];
#pragma unroll
      for (int c = 0; c < C - 1; ++c) {
        bv[c] = rv[c];
        bh[c] = rh[c];
      }
      for (int dx = 0; dx < k; ++dx) {
        bv[C - 1] = rv[dx + C - 1];
        bh[C - 1] = rh[dx + C - 1];
        const float qg = qrow[dx];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc_a[c] = __fadd_rn(acc_a[c], __fmul_rn(qg, bv[c]));
          acc_b[c] = __fadd_rn(acc_b[c], __fmul_rn(qg, bh[c]));
        }
#pragma unroll
        for (int c = 0; c < C - 1; ++c) {
          bv[c] = bv[c + 1];
          bh[c] = bh[c + 1];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (t2 + c < T) {
        ga[t1 * T + t2 + c] = acc_a[c];
        gb[t1 * T + t2 + c] = acc_b[c];
      }
    }
  }
}

}  // namespace

// Dynamic shared memory one keypoint's CTA needs for windows of S x S and
// k x k patches.
extern "C" long long qcorr_smem_bytes(int S, int k) { return static_cast<long long>(smem_bytes(S, k)); }

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
  const size_t smem = smem_bytes(S, k);
  const long long limit = qcorr_smem_limit();
  if (limit < 0 || static_cast<long long>(smem) > limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(qcorr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = T * ((T + C - 1) / C);
  const int warps_up = (strips + 31) / 32 * 32;
  const int threads = warps_up < MAX_THREADS ? warps_up : MAX_THREADS;
  qcorr_kernel<<<K, threads, smem, static_cast<cudaStream_t>(stream)>>>(wvh, wh, q, a, b, S, k, T);
  return static_cast<int>(cudaGetLastError());
}
