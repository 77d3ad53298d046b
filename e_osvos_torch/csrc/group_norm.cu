// GroupNorm passes for Hopper (sm_90a): statistics with their group algebra,
// and the elementwise apply and dx passes.
//
// Replaces the two Pallas TPU kernels of e_osvos_tpu/ops/pallas_group_norm.py
// together with the [N, C] / [N, G] algebra XLA ran around them:
//   K1 `_stats_kernel` (per-channel sum(x), sum(x^2) over M of x[N, M, C])
//      + `_group_stats` and the a/b coefficients of `_fwd`;
//   K2 `_pair_sums_kernel` (per-channel sum(dy), sum(dy*x) from one read of
//      (dy, x)) + the backward algebra of `_bwd` (A, B, D, dgamma, dbeta);
// and the two elementwise passes that XLA fused around them:
//   y  = x * a + b            (forward apply, a/b per (n, c))
//   dx = dy * A + x * B + D   (backward, A/B/D per (n, c))
//
// Bound: every pass is memory-bound. On an H100 SXM (3.35 TB/s) the stats
// pass reads x once, the pair-sums pass reads dy and x once, and the two
// elementwise passes read one or two tensors and write one. The arithmetic
// is one or two FMAs per element, far below the 295 operations per byte at
// which the card's compute becomes the limit. The [N, C] algebra is tiny;
// what it costs is launches and host time, so it lives in one small launch.
//
// Design. A GroupNorm forward is three launches (partial sums, finalize,
// apply), a backward three (pair partial sums, finalize, dx):
//   * Sweep tiling, shared by the partial-sums and the elementwise kernels:
//     a block of 256 threads owns (image n, slice of C, chunk of rows). Each
//     thread reads 16 bytes a row (8 bf16 or 4 f32 neighbouring channels;
//     `lanes` threads span the slice, a power of two up to 256), so a warp
//     reads 512 contiguous bytes, and several rows are in flight per thread
//     (unrolled). The thread's channels never change, so the elementwise
//     passes load their per-(n, c) coefficients into registers once. A C
//     that is not a multiple of the vector width (or a base that is not
//     16-byte aligned) takes the same kernels with VEC = 1. The chunk rows
//     are set in Python (ops/cuda_group_norm.py) so the grid is about one
//     wave of four 256-thread blocks on every SM.
//   * Partial sums: per-thread f32 sums, a warp-shuffle butterfly over the
//     rows a warp holds, then shared memory over the warps; one f32 pair per
//     (n, chunk, c) goes to a scratch buffer.
//   * Finalize: a block owns whole groups (about 32 channels) and sums the
//     chunk partials of each channel in a fixed order (8 chunk lanes, then
//     the lanes in order); then the group algebra. Forward, the JAX formula
//     mean = S/m, var = max(S2/m - mean^2, 0), rstd = rsqrt(var + eps),
//     a = rstd*gamma, b = beta - mean*a, with a block for each image.
//     Backward, Sum dy*xhat, c1, c2, A, B, D, and dgamma/dbeta summed over
//     n in order, so one block walks every image. No atomics: two calls on
//     the same input give the same bits.
// A thread-block cluster (at most 16 blocks sharing shared memory) cannot
// cover M = 102,480 rows at three images and still fill 132 SMs, so the
// partials go through global memory (they stay in L2) instead.
// What is left between a call and its byte bound (PERF.md): the launch
// and tail of a one-wave sweep, and the finalize, whose steps are dependent
// L2 round trips (about 3 us an image; the backward walks the images in
// turn).

// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes); every entry point takes the launch geometry as a pointer to the
// struct Geometry below, launches on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry it cannot run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // every kernel's block
constexpr int kMinBlocksPerSM = 4; // the Python tiling targets 4 blocks/SM
constexpr int kMaxLanes = 256;     // threads along C in one block
constexpr int kMaxFinalizeSmem = 48 * 1024;

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

// VEC neighbouring channels of one row: one 16-byte access for the vector
// widths, one element for VEC = 1.
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) {
    v[0] = to_float(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = from_float<T>(v[0]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The sweep tiling of one thread: its vector of channels, its first row and
// the rows between its steps. grid = (chunks, C slices, N).
struct Sweep {
  int vec_index;  // vector of channels along C (past C / VEC: idle)
  int m;          // first row of this thread
  int m_end;      // end of the block's chunk
  int step;       // rows between a thread's consecutive rows
  size_t base;    // offset of (n, row 0, first channel)

  __device__ Sweep(int M, int C, int VEC, int lanes, int rows_per_chunk) {
    const int lane = threadIdx.x & (lanes - 1);
    const int chunk = blockIdx.x;
    vec_index = (int)blockIdx.y * lanes + lane;
    step = kThreads / lanes;
    m = chunk * rows_per_chunk + (int)threadIdx.x / lanes;
    m_end = min((chunk + 1) * rows_per_chunk, M);
    base = (size_t)blockIdx.z * M * C + (size_t)vec_index * VEC;
  }
};

// partial[n, chunk, c] = (sum a, sum a*b) over the chunk's rows, with b = a
// for the stats pass (K1) and b = x for the pair-sums pass (K2, a = dy).
template <typename T, int VEC, bool kPair, int UNROLL>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    partial_sums_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        float2* __restrict__ partial, int M, int C, int lanes,
                        int rows_per_chunk) {
  const Sweep sw(M, C, VEC, lanes, rows_per_chunk);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  if (sw.vec_index < C / VEC) {
    const T* pa = a + sw.base;
    const T* pb = b + sw.base;
    int m = sw.m;
    for (; m + (UNROLL - 1) * sw.step < sw.m_end; m += UNROLL * sw.step) {
      float va[UNROLL][VEC], vb[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t off = (size_t)(m + u * sw.step) * C;
        Vec<T, VEC>::load(pa + off, va[u]);
        if (kPair) Vec<T, VEC>::load(pb + off, vb[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s1[k] += va[u][k];
          s2[k] += va[u][k] * (kPair ? vb[u][k] : va[u][k]);
        }
      }
    }
    for (; m < sw.m_end; m += sw.step) {
      float va[VEC], vb[VEC];
      const size_t off = (size_t)m * C;
      Vec<T, VEC>::load(pa + off, va);
      if (kPair) Vec<T, VEC>::load(pb + off, vb);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += va[k];
        s2[k] += va[k] * (kPair ? vb[k] : va[k]);
      }
    }
  }
  // A warp holds 32 / lanes rows of the same channels when lanes < 32: a
  // butterfly over the lane bits above `lanes` sums them in a fixed order.
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
      s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
    }
  }
  // Then shared memory over the row groups left: the warps (lanes < 32) or
  // the row lanes (lanes >= 32). At most 8 * 16 * 8 or 256 * 8 entries.
  __shared__ float2 red[kThreads * 8];
  const bool narrow = lanes < 32;
  const int groups = narrow ? kThreads / 32 : kThreads / lanes;
  const int group = narrow ? threadIdx.x / 32 : threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  if (!narrow || (threadIdx.x & 31) < lanes) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      red[(group * VEC + k) * lanes + lane] = make_float2(s1[k], s2[k]);
  }
  __syncthreads();
  const int width = lanes * VEC;  // channels of this block's slice
  const int c0 = blockIdx.y * width;
  float2* out = partial + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * C;
  for (int j = threadIdx.x; j < width && c0 + j < C; j += kThreads) {
    const int k = j % VEC;
    const int l = j / VEC;
    float2 t = red[k * lanes + l];
    for (int g = 1; g < groups; ++g) {
      const float2 r = red[(g * VEC + k) * lanes + l];
      t.x += r.x;
      t.y += r.y;
    }
    out[c0 + j] = t;
  }
}

// Sums the chunk partials of every channel of a block's groups in a fixed
// order, then the group algebra. A block owns `groups_per_block` whole
// groups; grid = (group blocks, N) forward, (group blocks, 1) backward,
// where one block walks every n so dgamma/dbeta sum over n in order.
//   forward:  mean, rstd [N, G] out; a = rstd*gamma, b = beta - mean*a.
//   backward: mean, rstd in; A = rstd*gamma, B, D [N, C]; dgamma, dbeta [C].
template <bool kBackward>
__global__ void __launch_bounds__(kThreads)
    group_finalize_kernel(const float2* __restrict__ partial, int N, int C,
                          int chunks, int G, int groups_per_block,
                          float m_per_group, float eps,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, float* mean,
                          float* rstd, float* __restrict__ out_a,
                          float* __restrict__ out_b, float* __restrict__ out_d,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta) {
  extern __shared__ float smem[];
  __shared__ float2 red[kThreads / 32][32];
  const int gs = C / G;
  const int g0 = (int)blockIdx.x * groups_per_block;
  const int ng = min(groups_per_block, G - g0);
  const int c0 = g0 * gs;
  const int cw = ng * gs;
  float* S1 = smem;  // per-channel sums of the current n
  float* S2 = S1 + groups_per_block * gs;
  float* Gm = S2 + groups_per_block * gs;  // per-group values
  float* Gr = Gm + groups_per_block;
  float* Gb = Gr + groups_per_block;
  float* Gd = Gb + groups_per_block;
  const int tx = threadIdx.x & 31;  // channel
  const int ty = threadIdx.x / 32;  // chunk lane
  const int n_begin = kBackward ? 0 : (int)blockIdx.y;
  const int n_end = kBackward ? N : n_begin + 1;
  for (int n = n_begin; n < n_end; ++n) {
    const float2* p = partial + (size_t)n * chunks * C + c0;
    for (int j0 = 0; j0 < cw; j0 += 32) {
      // 8 chunk lanes each sum every 8th chunk of 32 channels (a warp reads
      // 256 contiguous bytes), then lane 0 sums the lanes in order
      const int j = j0 + tx;
      float2 t = make_float2(0.f, 0.f);
      if (j < cw) {
#pragma unroll 4
        for (int k = ty; k < chunks; k += kThreads / 32) {
          const float2 v = p[(size_t)k * C + j];
          t.x += v.x;
          t.y += v.y;
        }
      }
      red[ty][tx] = t;
      __syncthreads();
      if (ty == 0 && j < cw) {
        for (int r = 1; r < kThreads / 32; ++r) {
          t.x += red[r][tx].x;
          t.y += red[r][tx].y;
        }
        S1[j] = t.x;
        S2[j] = t.y;
      }
      __syncthreads();
    }
    const size_t nc = (size_t)n * C + c0;
    if (!kBackward) {
      for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
        float t1 = 0.f, t2 = 0.f;
        for (int i = 0; i < gs; ++i) {
          t1 += S1[gl * gs + i];
          t2 += S2[gl * gs + i];
        }
        const float mu = t1 / m_per_group;
        const float var = fmaxf(t2 / m_per_group - mu * mu, 0.f);
        const float r = rsqrtf(var + eps);
        mean[n * G + g0 + gl] = mu;
        rstd[n * G + g0 + gl] = r;
        Gm[gl] = mu;
        Gr[gl] = r;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < cw; j += kThreads) {
        const int gl = j / gs;
        const float av = Gr[gl] * gamma[c0 + j];
        out_a[nc + j] = av;
        out_b[nc + j] = beta[c0 + j] - Gm[gl] * av;
      }
    } else {
      for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
        Gm[gl] = mean[n * G + g0 + gl];
        Gr[gl] = rstd[n * G + g0 + gl];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < cw; j += kThreads) {
        const int gl = j / gs;
        const float s1 = S1[j];
        const float sdx = Gr[gl] * (S2[j] - Gm[gl] * s1);  // sum dy * xhat
        // the same thread owns channel j for every n: a sum in n order
        dgamma[c0 + j] = n == 0 ? sdx : dgamma[c0 + j] + sdx;
        dbeta[c0 + j] = n == 0 ? s1 : dbeta[c0 + j] + s1;
        S1[j] = gamma[c0 + j] * s1;
        S2[j] = gamma[c0 + j] * sdx;
      }
      __syncthreads();
      for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
        float c1 = 0.f, c2 = 0.f;  // sum dy*gamma, sum dy*gamma*xhat
        for (int i = 0; i < gs; ++i) {
          c1 += S1[gl * gs + i];
          c2 += S2[gl * gs + i];
        }
        const float r = Gr[gl];
        // dx = rstd*gamma*dy - rstd/m*(c1 + xhat*c2) = A*dy + B*x + D
        Gb[gl] = -(r * r) * c2 / m_per_group;
        Gd[gl] = (r * r * c2 * Gm[gl] - r * c1) / m_per_group;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < cw; j += kThreads) {
        const int gl = j / gs;
        out_a[nc + j] = Gr[gl] * gamma[c0 + j];
        out_b[nc + j] = Gb[gl];
        out_d[nc + j] = Gd[gl];
      }
    }
    __syncthreads();  // S1/S2 and the group values are reused for n + 1
  }
}

// y[n, m, c] = x * a[n, c] + b[n, c], on the sweep tiling.
template <typename T, int VEC, int UNROLL>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    affine_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, T* __restrict__ y, int M, int C,
                  int lanes, int rows_per_chunk) {
  const Sweep sw(M, C, VEC, lanes, rows_per_chunk);
  if (sw.vec_index >= C / VEC) return;
  const size_t coef = (size_t)blockIdx.z * C + (size_t)sw.vec_index * VEC;
  float av[VEC], bv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    av[k] = a[coef + k];
    bv[k] = b[coef + k];
  }
  const T* px = x + sw.base;
  T* py = y + sw.base;
  int m = sw.m;
  for (; m + (UNROLL - 1) * sw.step < sw.m_end; m += UNROLL * sw.step) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      Vec<T, VEC>::load(px + (size_t)(m + u * sw.step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[u][k] = v[u][k] * av[k] + bv[k];
      Vec<T, VEC>::store(py + (size_t)(m + u * sw.step) * C, v[u]);
    }
  }
  for (; m < sw.m_end; m += sw.step) {
    float v[VEC];
    Vec<T, VEC>::load(px + (size_t)m * C, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = v[k] * av[k] + bv[k];
    Vec<T, VEC>::store(py + (size_t)m * C, v);
  }
}

// dx[n, m, c] = dy * A[n, c] + x * B[n, c] + D[n, c], on the sweep tiling.
template <typename T, int VEC, int UNROLL>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    affine_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ D, T* __restrict__ dx, int M,
                     int C, int lanes, int rows_per_chunk) {
  const Sweep sw(M, C, VEC, lanes, rows_per_chunk);
  if (sw.vec_index >= C / VEC) return;
  const size_t coef = (size_t)blockIdx.z * C + (size_t)sw.vec_index * VEC;
  float Av[VEC], Bv[VEC], Dv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    Av[k] = A[coef + k];
    Bv[k] = B[coef + k];
    Dv[k] = D[coef + k];
  }
  const T* pdy = dy + sw.base;
  const T* px = x + sw.base;
  T* pdx = dx + sw.base;
  int m = sw.m;
  for (; m + (UNROLL - 1) * sw.step < sw.m_end; m += UNROLL * sw.step) {
    float vd[UNROLL][VEC], vx[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t off = (size_t)(m + u * sw.step) * C;
      Vec<T, VEC>::load(pdy + off, vd[u]);
      Vec<T, VEC>::load(px + off, vx[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        vd[u][k] = vd[u][k] * Av[k] + vx[u][k] * Bv[k] + Dv[k];
      Vec<T, VEC>::store(pdx + (size_t)(m + u * sw.step) * C, vd[u]);
    }
  }
  for (; m < sw.m_end; m += sw.step) {
    float vd[VEC], vx[VEC];
    const size_t off = (size_t)m * C;
    Vec<T, VEC>::load(pdy + off, vd);
    Vec<T, VEC>::load(px + off, vx);
#pragma unroll
    for (int k = 0; k < VEC; ++k) vd[k] = vd[k] * Av[k] + vx[k] * Bv[k] + Dv[k];
    Vec<T, VEC>::store(pdx + off, vd);
  }
}

// The launch geometry the Python side computed (ops/cuda_group_norm.py
// `Geometry`: the same fields in the same order), checked before any launch.
struct Geometry {
  int N, M, C, G, dtype;
  int vec, lanes, cslices, rows_per_chunk, chunks;  // the sweep tiling
  int groups_per_block;                             // the finalize tiling

  bool valid() const {
    const int wide = dtype == kBFloat16 ? 8 : 4;
    return (dtype == kFloat32 || dtype == kBFloat16) && N >= 1 &&
           N <= 65535 && M >= 1 && C >= 1 && (long long)M * C < (1LL << 31) &&
           (vec == 1 || (vec == wide && C % vec == 0)) && lanes >= 1 &&
           lanes <= kMaxLanes && (lanes & (lanes - 1)) == 0 &&
           (long long)cslices * lanes * vec >= C && cslices <= 65535 &&
           rows_per_chunk >= 1 && chunks >= 1 &&
           (long long)chunks * rows_per_chunk >= M &&
           (long long)(chunks - 1) * rows_per_chunk < M;
  }
  // the finalize's groups and its dynamic shared memory
  bool finalize_fits(size_t* smem) const {
    if (G < 1 || C % G != 0 || groups_per_block < 1) return false;
    *smem = (size_t)(2 * groups_per_block * (C / G) + 4 * groups_per_block) *
            sizeof(float);
    return *smem <= (size_t)kMaxFinalizeSmem;
  }
  dim3 grid() const { return dim3(chunks, cslices, N); }
  dim3 finalize_grid(bool backward) const {
    return dim3((G + groups_per_block - 1) / groups_per_block,
                backward ? 1 : N);
  }
  size_t partial_floats() const { return (size_t)N * chunks * C * 2; }
  float m_per_group() const { return (float)((long long)M * (C / G)); }
};

// Rows in flight per thread: four loads of x, or two each of dy and x, keep
// 64 KB a SM in flight at four blocks a SM and stay within 64 registers.
template <bool kPair, typename T, int VEC>
void launch_partial(const void* a, const void* b, float* partial,
                    const Geometry& g, cudaStream_t s) {
  partial_sums_kernel<T, VEC, kPair, kPair ? 2 : 4>
      <<<g.grid(), kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          reinterpret_cast<float2*>(partial), g.M, g.C, g.lanes,
          g.rows_per_chunk);
}

template <bool kPair>
void dispatch_partial(const void* a, const void* b, float* partial,
                      const Geometry& g, cudaStream_t s) {
  if (g.dtype == kBFloat16 && g.vec == 8) {
    launch_partial<kPair, __nv_bfloat16, 8>(a, b, partial, g, s);
  } else if (g.dtype == kBFloat16) {
    launch_partial<kPair, __nv_bfloat16, 1>(a, b, partial, g, s);
  } else if (g.vec == 4) {
    launch_partial<kPair, float, 4>(a, b, partial, g, s);
  } else {
    launch_partial<kPair, float, 1>(a, b, partial, g, s);
  }
}

template <typename T, int VEC>
void launch_affine(const void* x, const float* a, const float* b, void* y,
                   const Geometry& g, cudaStream_t s) {
  affine_kernel<T, VEC, 4><<<g.grid(), kThreads, 0, s>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(y), g.M, g.C, g.lanes,
      g.rows_per_chunk);
}

// dx keeps A, B and D in registers: two rows in flight for the vectors.
template <typename T, int VEC>
void launch_affine_dx(const void* dy, const void* x, const float* A,
                      const float* B, const float* D, void* dx,
                      const Geometry& g, cudaStream_t s) {
  affine_dx_kernel<T, VEC, VEC == 1 ? 4 : 2><<<g.grid(), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), A, B, D,
      static_cast<T*>(dx), g.M, g.C, g.lanes, g.rows_per_chunk);
}

}  // namespace

extern "C" {

// K1 + forward algebra, two launches: partial sums of x, then the finalize.
// ws: partial [N, chunks, C, 2] | a [N, C] | b [N, C] | mean [N, G] |
// rstd [N, G], f32.
int gn_group_stats(const void* x, const float* gamma, const float* beta,
                   float* ws, const void* geometry, float eps,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry& g = *static_cast<const Geometry*>(geometry);
  size_t smem = 0;
  if (!g.valid() || !g.finalize_fits(&smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t nc = (size_t)g.N * g.C, ng = (size_t)g.N * g.G;
  float* a = ws + g.partial_floats();
  float* b = a + nc;
  float* mean = b + nc;
  float* rstd = mean + ng;
  dispatch_partial<false>(x, x, ws, g, s);
  group_finalize_kernel<false><<<g.finalize_grid(false), kThreads, smem, s>>>(
      reinterpret_cast<const float2*>(ws), g.N, g.C, g.chunks, g.G,
      g.groups_per_block, g.m_per_group(), eps, gamma, beta, mean, rstd, a, b,
      nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K2 + backward algebra, two launches: pair partial sums of (dy, x), then
// the finalize, with the forward's mean/rstd [N, G].
// ws: partial [N, chunks, C, 2] | A | B | D [N, C] | dgamma | dbeta [C], f32.
int gn_group_grad_coeffs(const void* dy, const void* x, const float* gamma,
                         const float* mean, const float* rstd, float* ws,
                         const void* geometry, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry& g = *static_cast<const Geometry*>(geometry);
  size_t smem = 0;
  if (!g.valid() || !g.finalize_fits(&smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t nc = (size_t)g.N * g.C;
  float* A = ws + g.partial_floats();
  float* B = A + nc;
  float* D = B + nc;
  float* dgamma = D + nc;
  float* dbeta = dgamma + g.C;
  dispatch_partial<true>(dy, x, ws, g, s);
  group_finalize_kernel<true><<<g.finalize_grid(true), kThreads, smem, s>>>(
      reinterpret_cast<const float2*>(ws), g.N, g.C, g.chunks, g.G,
      g.groups_per_block, g.m_per_group(), 0.f, gamma, nullptr,
      const_cast<float*>(mean), const_cast<float*>(rstd), A, B, D, dgamma,
      dbeta);
  return static_cast<int>(cudaGetLastError());
}

// y = x * a + b; a, b f32 [N, C].
int gn_affine(const void* x, const float* a, const float* b, void* y,
              const void* geometry, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry& g = *static_cast<const Geometry*>(geometry);
  if (!g.valid()) return static_cast<int>(cudaErrorInvalidValue);
  if (g.dtype == kBFloat16 && g.vec == 8) {
    launch_affine<__nv_bfloat16, 8>(x, a, b, y, g, s);
  } else if (g.dtype == kBFloat16) {
    launch_affine<__nv_bfloat16, 1>(x, a, b, y, g, s);
  } else if (g.vec == 4) {
    launch_affine<float, 4>(x, a, b, y, g, s);
  } else {
    launch_affine<float, 1>(x, a, b, y, g, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = dy * A + x * B + D; A, B, D f32 [N, C].
int gn_affine_dx(const void* dy, const void* x, const float* A, const float* B,
                 const float* D, void* dx, const void* geometry,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry& g = *static_cast<const Geometry*>(geometry);
  if (!g.valid()) return static_cast<int>(cudaErrorInvalidValue);
  if (g.dtype == kBFloat16 && g.vec == 8) {
    launch_affine_dx<__nv_bfloat16, 8>(dy, x, A, B, D, dx, g, s);
  } else if (g.dtype == kBFloat16) {
    launch_affine_dx<__nv_bfloat16, 1>(dy, x, A, B, D, dx, g, s);
  } else if (g.vec == 4) {
    launch_affine_dx<float, 4>(dy, x, A, B, D, dx, g, s);
  } else {
    launch_affine_dx<float, 1>(dy, x, A, B, D, dx, g, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
