// GroupNorm statistics and elementwise passes for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of e_osvos_tpu/ops/pallas_group_norm.py:
//   K1 `_stats_kernel` (per-channel sum(x), sum(x^2) over M of x[N, M, C])
//   K2 `_pair_sums_kernel` (per-channel sum(dy), sum(dy*x) from one read of
//      (dy, x))
// plus the two elementwise passes that XLA fused around them on the TPU:
//   y  = x * a + b            (forward apply, a/b per (n, c))
//   dx = dy * A + x * B + D   (backward, A/B/D per (n, c))
//
// Bound: every pass is memory-bound. On an H100 SXM (3.35 TB/s) the stats
// pass reads x once, the pair-sums pass reads dy and x once, and the two
// elementwise passes read one or two tensors and write one. The arithmetic
// is one or two FMAs per element, far below the 295 operations per byte at
// which the card's compute becomes the limit.
//
// Design: the TPU kernels walk M as a sequential grid axis and accumulate
// into one output block. Blocks on the GPU run in no order, so here a block
// owns (n, 32-channel slice, chunk of ROWS_PER_CHUNK rows): threads run
// along C so a warp reads 32 neighbouring channels of one row, a loop inside
// the block walks the chunk's rows, and the block writes one f32 partial per
// channel. A second small launch sums the partials of each (n, c) in chunk
// order, so the result is deterministic (no atomics). Rows past M are never
// read. The elementwise passes take a 2-D grid (elements of one sample, n)
// so the per-(n, c) coefficient index needs only 32-bit arithmetic.
//
// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes); every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannelsPerBlock = 32;  // threadIdx.x: neighbouring channels
constexpr int kRowLanes = 8;           // threadIdx.y: rows read in parallel
constexpr int kRowsPerChunk = 256;     // rows of one block's partial sum
constexpr int kElementwiseThreads = 256;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// partial[n, chunk, c] = (sum a, sum a*b) over the chunk's rows, with b = a
// for the stats pass (K1) and b = x for the pair-sums pass (K2, a = dy).
template <typename T, bool kPair>
__global__ void partial_sums_kernel(const T* __restrict__ a,
                                    const T* __restrict__ b,
                                    float2* __restrict__ partial, int M, int C,
                                    int chunks) {
  const int c = blockIdx.x * kChannelsPerBlock + threadIdx.x;
  const int chunk = blockIdx.y;
  const int n = blockIdx.z;
  const int m_begin = chunk * kRowsPerChunk;
  const int m_end = min(m_begin + kRowsPerChunk, M);
  float s1 = 0.f;
  float s2 = 0.f;
  if (c < C) {
    const size_t base = (size_t)n * M * C + c;
    for (int m = m_begin + threadIdx.y; m < m_end; m += kRowLanes) {
      const size_t off = base + (size_t)m * C;
      const float va = to_float(a[off]);
      const float vb = kPair ? to_float(b[off]) : va;
      s1 += va;
      s2 += va * vb;
    }
  }
  __shared__ float sh1[kRowLanes][kChannelsPerBlock];
  __shared__ float sh2[kRowLanes][kChannelsPerBlock];
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f;
    float t2 = 0.f;
#pragma unroll
    for (int r = 0; r < kRowLanes; ++r) {
      t1 += sh1[r][threadIdx.x];
      t2 += sh2[r][threadIdx.x];
    }
    partial[((size_t)n * chunks + chunk) * C + c] = make_float2(t1, t2);
  }
}

// out1[n, c], out2[n, c] = sums of the partials over chunks, in chunk order.
__global__ void combine_partials_kernel(const float2* __restrict__ partial,
                                        float* __restrict__ out1,
                                        float* __restrict__ out2, int N, int C,
                                        int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int n = i / C;
  const int c = i - n * C;
  const float2* p = partial + (size_t)n * chunks * C + c;
  float t1 = 0.f;
  float t2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float2 v = p[(size_t)k * C];
    t1 += v.x;
    t2 += v.y;
  }
  out1[i] = t1;
  out2[i] = t2;
}

// y[n, m, c] = x * a[n, c] + b[n, c]; grid = (blocks over M*C, N).
template <typename T>
__global__ void affine_kernel(const T* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ b, T* __restrict__ y,
                              int MC, int C) {
  const int n = blockIdx.y;
  const size_t base = (size_t)n * MC;
  const float* an = a + (size_t)n * C;
  const float* bn = b + (size_t)n * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MC;
       i += gridDim.x * blockDim.x) {
    const int c = i % C;
    y[base + i] = from_float<T>(to_float(x[base + i]) * an[c] + bn[c]);
  }
}

// dx[n, m, c] = dy * A[n, c] + x * B[n, c] + D[n, c].
template <typename T>
__global__ void affine_dx_kernel(const T* __restrict__ dy,
                                 const T* __restrict__ x,
                                 const float* __restrict__ A,
                                 const float* __restrict__ B,
                                 const float* __restrict__ D,
                                 T* __restrict__ dx, int MC, int C) {
  const int n = blockIdx.y;
  const size_t base = (size_t)n * MC;
  const float* An = A + (size_t)n * C;
  const float* Bn = B + (size_t)n * C;
  const float* Dn = D + (size_t)n * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MC;
       i += gridDim.x * blockDim.x) {
    const int c = i % C;
    const float v = to_float(dy[base + i]) * An[c] +
                    to_float(x[base + i]) * Bn[c] + Dn[c];
    dx[base + i] = from_float<T>(v);
  }
}

int chunks_for(int M) { return (M + kRowsPerChunk - 1) / kRowsPerChunk; }

dim3 elementwise_grid(int MC, int N) {
  int blocks = (MC + kElementwiseThreads - 1) / kElementwiseThreads;
  blocks = blocks < 65535 ? blocks : 65535;  // the loop covers the rest
  return dim3(blocks, N);
}

template <typename T>
void launch_sums(const void* a, const void* b, void* partial, float* out1,
                 float* out2, int N, int M, int C, bool pair,
                 cudaStream_t stream) {
  const int chunks = chunks_for(M);
  const dim3 block(kChannelsPerBlock, kRowLanes);
  const dim3 grid((C + kChannelsPerBlock - 1) / kChannelsPerBlock, chunks, N);
  if (pair) {
    partial_sums_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<float2*>(partial), M, C, chunks);
  } else {
    partial_sums_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(a),
        static_cast<float2*>(partial), M, C, chunks);
  }
  const int threads = 256;
  combine_partials_kernel<<<(N * C + threads - 1) / threads, threads, 0,
                            stream>>>(static_cast<const float2*>(partial), out1,
                                      out2, N, C, chunks);
}

}  // namespace

extern "C" {

// Rows per partial sum; the caller sizes the float2 scratch as
// [N, ceil(M / rows), C].
int gn_rows_per_chunk() { return kRowsPerChunk; }

// K1 (pair = 0): out1 = sum x, out2 = sum x*x.  K2 (pair = 1, a = dy,
// b = x): out1 = sum dy, out2 = sum dy*x.  Sums over M, per (n, c), f32.
int gn_channel_sums(const void* a, const void* b, void* partial, float* out1,
                    float* out2, int N, int M, int C, int dtype, int pair,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    launch_sums<__nv_bfloat16>(a, b, partial, out1, out2, N, M, C, pair != 0,
                               s);
  } else if (dtype == kFloat32) {
    launch_sums<float>(a, b, partial, out1, out2, N, M, C, pair != 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int gn_affine(const void* x, const float* a, const float* b, void* y, int N,
              int M, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int MC = M * C;
  const dim3 grid = elementwise_grid(MC, N);
  if (dtype == kBFloat16) {
    affine_kernel<__nv_bfloat16><<<grid, kElementwiseThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, b,
        static_cast<__nv_bfloat16*>(y), MC, C);
  } else if (dtype == kFloat32) {
    affine_kernel<float><<<grid, kElementwiseThreads, 0, s>>>(
        static_cast<const float*>(x), a, b, static_cast<float*>(y), MC, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int gn_affine_dx(const void* dy, const void* x, const float* A, const float* B,
                 const float* D, void* dx, int N, int M, int C, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int MC = M * C;
  const dim3 grid = elementwise_grid(MC, N);
  if (dtype == kBFloat16) {
    affine_dx_kernel<__nv_bfloat16><<<grid, kElementwiseThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), A, B, D,
        static_cast<__nv_bfloat16*>(dx), MC, C);
  } else if (dtype == kFloat32) {
    affine_dx_kernel<float><<<grid, kElementwiseThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), A, B, D,
        static_cast<float*>(dx), MC, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
