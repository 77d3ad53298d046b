// Padded greedy non-maximum suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nms_kernel` of
// e_osvos_tpu/ops/pallas_nms.py (K3): for each image, max_out rounds of
//   take the alive box of highest score (ties: the lowest index),
//   record it (or -1 / false once nothing is alive),
//   kill every alive box whose IoU with it exceeds the threshold, and it.
// Alive at the start: valid & (score > -inf). The IoU is computed exactly as
// the TPU kernel and the plain PyTorch twin compute it:
//   union > 0 ? inter / max(union, 1e-9) : 0,   union = area + area_w - inter
// and a box stays alive iff iou <= threshold. Scores compare as floats, so
// -0.0 ties with +0.0 and the lower index wins.
//
// Bound: the bytes (21 a box read, 5 a slot written) and the operations
// (about 15 a box a round) both give microseconds; what a greedy NMS really
// pays is the chain of max_out dependent picks. Two routes, picked per call
// in ops/cuda_nms.py from (N, max_out):
//
// Route S, few picks (nms_few_kernel): one block an image of round_up(N, 32)
// threads, at most 1024; each thread keeps its ITEMS boxes (16-byte loads),
// areas and order keys in registers. The boxes are also copied once into
// shared memory (N <= 4096, 64 KB), so every thread reads the winner's box
// from there, with no broadcast step (above 4096 boxes, from device memory
// through the caches). A round is a thread-local arg-max, a
// warp arg-max in two __reduce_*_sync (max of the key, then min of the index
// among the lanes holding it), the warp's result into a slot double-buffered
// by round parity, ONE __syncthreads, and every warp reducing the 32 slots
// itself. The last round records its pick and skips the IoU pass. The key
// is the order-preserving bits of the score with -0.0 made +0.0 (so a -0/+0
// tie still goes to the lowest index); 0 means not alive.
//
// Route L, many picks: the O(N^2) IoU work leaves the serial chain and is
// spread over all SMs, in three launches:
//   (a) nms_rank_kernel: each alive box's place in the (score descending,
//       index ascending) order is the number of alive boxes that beat it,
//       counted by blocks of 32 boxes against all scores staged in shared
//       memory; it writes the boxes and their indices in that order, and the
//       alive count. Deterministic, no atomics, no sort.
//   (b) nms_mask_kernel: for every pair i < j in that order one bit,
//       !(iou(i, j) <= thr), in ceil(N/64) 64-bit words a row; one block per
//       (row tile, column tile >= row tile), four threads a row, the column
//       tile's boxes in shared memory. The IoU takes box i as the winner,
//       with the operands in the twin's order.
//   (c) nms_scan_kernel: one block an image walks the sorted boxes in chunks
//       of 64 with a "removed" bit-vector in shared memory. Inside a chunk
//       warp 0 keeps at once every live box in no conflict with another
//       live box of the chunk, and walks the rest in order with register
//       bit operations on the chunk's diagonal words; then the block ORs the
//       kept rows' later words into the removed words (shared-memory
//       atomicOr: the OR does not depend on the order) and loads the next
//       chunk's diagonal. It stops at max_out picks or at the end of the
//       alive boxes, then writes the -1 / false padding.
// The workspace of route L (sorted boxes, sorted indices, counts, mask) comes
// from the wrapper (torch.empty); ops/cuda_nms.py::workspace_layout.
//
// Built with -fmad=false: a fused multiply-add in the IoU would round
// differently from the twin's separate multiply and add, and the suppression
// decision is discontinuous at the threshold.
//
// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes); the entry points launch on the caller's stream and return the
// first error of cudaFuncSetAttribute or cudaGetLastError after each launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 16384;
constexpr int kMaxThreads = 1024;
constexpr int kSmemBoxes = 4096;  // route S stages the boxes up to this N
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kTile = 64;  // route L: boxes a mask word, a tile, a chunk
constexpr int kMaskLanes = 4;  // threads a mask row, each a quarter of it
constexpr int kRankBoxes = 32;
constexpr int kRankWarps = 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxImages = 65535;  // grid.y of the route L launches

// NaN-propagating max/min (one instruction each since sm_80), as
// torch.maximum/minimum and jnp.maximum/minimum. Where the two differ only in
// the sign of a zero result, the suppression decision does not: a zero width
// or height makes inter 0 and the IoU 0 whatever its sign.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  return max_nan(b.z - b.x, 0.f) * max_nan(b.w - b.y, 0.f);
}

// True when the winner w kills box b: !(iou(w, b) <= thresh), rounded as the
// twin's iou_one_vs_all(w, b). An inter of 0 gives an IoU of 0 either way,
// and a NaN inter makes the union NaN (IoU 0), so the division runs only
// for an inter > 0.
__device__ __forceinline__ bool suppresses(float4 w, float warea, float4 b,
                                           float area, float thresh) {
  const float iw = max_nan(min_nan(b.z, w.z) - max_nan(b.x, w.x), 0.f);
  const float ih = max_nan(min_nan(b.w, w.w) - max_nan(b.y, w.y), 0.f);
  const float inter = iw * ih;
  float iou = 0.f;
  if (inter > 0.f) {
    const float uni = area + warea - inter;
    if (uni > 0.f) iou = inter / max_nan(uni, 1e-9f);
  }
  return !(iou <= thresh);
}

// Order-preserving bits of an alive score (> -inf, not NaN): a larger score
// gives a larger key, -0.0 the key of +0.0, and every alive key is above 0,
// which stands for "not alive".
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ---------------------------------------------------------------- route S

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads, 1)
    nms_few_kernel(const float4* __restrict__ boxes,
                   const float* __restrict__ scores,
                   const uint8_t* __restrict__ valid, int N, float thresh,
                   int max_out, int32_t* __restrict__ out_idx,
                   uint8_t* __restrict__ out_keep) {
  constexpr bool kSmem = ITEMS <= kSmemBoxes / kMaxThreads;
  extern __shared__ float4 sbox[];  // N boxes when kSmem
  __shared__ uint32_t slot_key[2][32];
  __shared__ int slot_idx[2][32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const size_t b = blockIdx.x;
  boxes += b * N;
  scores += b * N;
  valid += b * N;
  out_idx += b * max_out;
  out_keep += b * max_out;

  float4 bx[ITEMS];
  float area[ITEMS];
  uint32_t key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * nthreads + t;
    key[j] = 0u;
    area[j] = 0.f;
    bx[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < N) {
      bx[j] = boxes[i];
      if (kSmem) sbox[i] = bx[j];
      area[j] = box_area(bx[j]);
      const float s = scores[i];
      if (valid[i] && s > -INFINITY) key[j] = score_key(s);
    }
  }

  for (int r = 0; r < max_out; ++r) {
    // this thread's best; j ascending keeps the lowest index on ties
    uint32_t k = 0u;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (key[j] > k) {
        k = key[j];
        bi = j * nthreads + t;
      }
    }
    const uint32_t wk = __reduce_max_sync(0xffffffffu, k);
    const int wi = __reduce_min_sync(0xffffffffu, k == wk ? bi : INT_MAX);
    const int p = r & 1;
    if (lane == 0) {
      slot_key[p][warp] = wk;
      slot_idx[p][warp] = wi;
    }
    // the one barrier of the round (the first also publishes sbox); slots
    // p are written again two rounds on, after every warp read them here
    __syncthreads();
    const uint32_t ck = lane < nwarps ? slot_key[p][lane] : 0u;
    const int ci = lane < nwarps ? slot_idx[p][lane] : INT_MAX;
    const uint32_t K = __reduce_max_sync(0xffffffffu, ck);
    const int I = __reduce_min_sync(0xffffffffu, ck == K ? ci : INT_MAX);
    if (K == 0u) {  // nothing alive: this and every later round
      for (int q = r + t; q < max_out; q += nthreads) {
        out_idx[q] = -1;
        out_keep[q] = 0;
      }
      return;
    }
    if (t == 0) {
      out_idx[r] = I;
      out_keep[r] = 1;
    }
    if (r + 1 == max_out) break;  // no later round reads the alive keys
    const float4 w = kSmem ? sbox[I] : boxes[I];
    const float warea = box_area(w);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (key[j] && (j * nthreads + t == I ||
                     suppresses(w, warea, bx[j], area[j], thresh))) {
        key[j] = 0u;
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes` where that is
// above the default; the setting holds for the current device only, so it
// is made on every such launch. Returns the error of a refused setting.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int ITEMS>
int launch_few(const float4* boxes, const float* scores, const uint8_t* valid,
               int B, int N, int threads, float thresh, int max_out,
               int32_t* idx, uint8_t* keep, cudaStream_t stream) {
  constexpr bool kSmem = ITEMS <= kSmemBoxes / kMaxThreads;
  const size_t smem = kSmem ? static_cast<size_t>(N) * sizeof(float4) : 0;
  const cudaError_t e = allow_smem(nms_few_kernel<ITEMS>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_few_kernel<ITEMS><<<B, threads, smem, stream>>>(
      boxes, scores, valid, N, thresh, max_out, idx, keep);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- route L

template <bool GE>
__device__ __forceinline__ int count_beating(const float* s, int from, int to,
                                             float si) {
  int c = 0;
#pragma unroll 4
  for (int j = from; j < to; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s + j);
    if (GE) {
      c += (v.x >= si) + (v.y >= si) + (v.z >= si) + (v.w >= si);
    } else {
      c += (v.x > si) + (v.y > si) + (v.z > si) + (v.w > si);
    }
  }
  return c;
}

// grid (ceil(N / 32), B), 1024 threads; dynamic shared memory: round_up(N,
// 4) scores, NaN where not alive (NaN compares false, so only alive boxes
// count). Lane l of every warp ranks box i0 + l; warp w counts the boxes of
// its 32nd of the scores: a box j beats i when s_j > s_i, or s_j == s_i and
// j < i (s_j >= s_i below the block's 32 boxes, s_j > s_i above them).
__global__ void __launch_bounds__(kRankBoxes* kRankWarps)
    nms_rank_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const uint8_t* __restrict__ valid, int N,
                    float4* __restrict__ sorted_box,
                    int32_t* __restrict__ sorted_idx,
                    int32_t* __restrict__ count) {
  extern __shared__ float s_sc[];
  __shared__ int part[kRankWarps][kRankBoxes];
  __shared__ int alive_part[kRankWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t b = blockIdx.y;
  const int n4 = (N + 3) & ~3;
  boxes += b * N;
  scores += b * N;
  valid += b * N;

  int alive = 0;
#pragma unroll 4
  for (int j = t; j < n4; j += blockDim.x) {
    float s = __int_as_float(0x7fffffff);
    if (j < N) {
      const float sj = scores[j];
      if (valid[j] && sj > -INFINITY) {
        s = sj;
        ++alive;
      }
    }
    s_sc[j] = s;
  }
  alive = __reduce_add_sync(0xffffffffu, alive);
  if (lane == 0) alive_part[warp] = alive;
  __syncthreads();

  const int i0 = blockIdx.x * kRankBoxes;
  const int i = i0 + lane;
  const float si = i < N ? s_sc[i] : __int_as_float(0x7fffffff);
  const int slice = (((n4 + kRankWarps - 1) / kRankWarps) + 3) & ~3;
  const int lo = min(n4, warp * slice);
  const int hi = min(n4, lo + slice);
  const int d0 = i0, d1 = min(n4, i0 + kRankBoxes);  // the block's own boxes
  int c = count_beating<true>(s_sc, lo, min(hi, d0), si);
  c += count_beating<false>(s_sc, max(lo, d1), hi, si);
  for (int j = max(lo, d0); j < min(hi, d1); ++j) {
    const float sj = s_sc[j];
    c += (sj > si) || (sj == si && j < i);
  }
  part[warp][lane] = c;
  __syncthreads();
  if (warp == 0) {
    if (i < N && si == si) {  // alive
      int rank = 0;
#pragma unroll
      for (int w = 0; w < kRankWarps; ++w) rank += part[w][lane];
      sorted_box[b * N + rank] = boxes[i];
      sorted_idx[b * N + rank] = i;
    }
    if (blockIdx.x == 0 && lane == 0) {
      int m = 0;
#pragma unroll
      for (int w = 0; w < kRankWarps; ++w) m += alive_part[w];
      count[b] = m;
    }
  }
}

// The upper triangle of T x T tiles, row by row: pair p -> (row r, column
// c >= r). Row r starts at r*T - r*(r-1)/2. The route L tests
// (tests/test_torch_port_nms_routes.py) check the same map in Python.
__device__ __forceinline__ void tile_pair(int p, int T, int* r_out,
                                          int* c_out) {
  const double a = 2.0 * T + 1.0;
  int r = static_cast<int>((a - sqrt(a * a - 8.0 * p)) * 0.5);
  r = max(0, min(T - 1, r));
  while (r > 0 && r * T - r * (r - 1) / 2 > p) --r;
  while (r + 1 < T && (r + 1) * T - (r + 1) * r / 2 <= p) ++r;
  *r_out = r;
  *c_out = r + (p - (r * T - r * (r - 1) / 2));
}

// grid (W*(W+1)/2, B), 256 threads. Threads 4t .. 4t+3 own row i = 64*r + t
// of the sorted order, thread 4t + q the columns q, q + 4, ..., q + 60 (no
// bank conflict on the shared boxes); together they write its word c: bit k
// set when box 64*c + k (> i, in the alive range) is killed by box i.
__global__ void __launch_bounds__(kTile* kMaskLanes)
    nms_mask_kernel(const float4* __restrict__ sorted_box,
                    const int32_t* __restrict__ count, int N, int W,
                    float thresh, uint64_t* __restrict__ mask) {
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  int r, c;
  tile_pair(blockIdx.x, W, &r, &c);
  const size_t b = blockIdx.y;
  const int M = count[b];
  const int row0 = r * kTile, col0 = c * kTile;
  if (row0 >= M) return;  // the whole block: no row of this tile is alive
  sorted_box += b * N;
  const int t = threadIdx.x;
  if (t < kTile && col0 + t < M) {
    const float4 v = sorted_box[col0 + t];
    cbox[t] = v;
    carea[t] = box_area(v);
  }
  __syncthreads();
  const int row = t / kMaskLanes, q = t % kMaskLanes;
  const int i = row0 + row;
  const bool has = i < M;
  const float4 w = has ? sorted_box[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float warea = box_area(w);
  const int lo = c == r ? row + 1 : 0;
  const int hi = has ? min(kTile, M - col0) : 0;
  uint64_t part = 0;  // bit 4*kk: column 4*kk + q
#pragma unroll
  for (int kk = 0; kk < kTile / kMaskLanes; ++kk) {
    const int k = kk * kMaskLanes + q;
    if (k >= lo && k < hi &&
        suppresses(w, warea, cbox[k], carea[k], thresh)) {
      part |= 1ull << (kk * kMaskLanes);
    }
  }
  unsigned long long bits = part << q;
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  if (q == 0 && has) mask[(b * N + i) * W + c] = bits;
}

// grid B, 1024 threads; dynamic shared memory: W removed words.
__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const uint64_t* __restrict__ mask,
                    const int32_t* __restrict__ sorted_idx,
                    const int32_t* __restrict__ count, int N, int W,
                    int max_out, int32_t* __restrict__ out_idx,
                    uint8_t* __restrict__ out_keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ uint64_t diag[kTile];
  __shared__ int chunk_idx[kTile];
  __shared__ int kept[kTile];
  __shared__ int s_kept, s_picks;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t b = blockIdx.x;
  const int M = count[b];
  mask += b * N * W;
  sorted_idx += b * N;
  out_idx += b * max_out;
  out_keep += b * max_out;

  for (int w = t; w < W; w += blockDim.x) removed[w] = 0ull;
  if (t < kTile) {
    diag[t] = t < M ? mask[static_cast<size_t>(t) * W] : 0ull;
    chunk_idx[t] = t < M ? sorted_idx[t] : -1;
  }
  __syncthreads();

  const int chunks = (M + kTile - 1) / kTile;
  int picks = 0;
  for (int c = 0; c < chunks; ++c) {
    const int base = c * kTile;
    if (warp == 0) {
      // Warp 0 resolves the chunk: lane l looks at positions l and l + 32.
      // A live box that no live box of the chunk hits, and that hits none,
      // is kept; the boxes in a conflict are walked in order, one pick an
      // iteration, each killing the later ones its row hits.
      const int n = min(kTile, M - base);
      const uint64_t live =
          (n == kTile ? ~0ull : (1ull << n) - 1) & ~removed[c];
      const uint64_t h0 = (live >> lane) & 1 ? diag[lane] & live : 0ull;
      const uint64_t h1 = (live >> (lane + 32)) & 1 ? diag[lane + 32] & live
                                                   : 0ull;
      unsigned long long involved = h0 | h1;  // boxes hit, and boxes that hit
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        involved |= __shfl_xor_sync(0xffffffffu, involved, off);
      }
      involved |= __ballot_sync(0xffffffffu, h0 != 0) |
                  static_cast<uint64_t>(__ballot_sync(0xffffffffu, h1 != 0))
                      << 32;
      uint64_t keep = live & ~involved;
      uint64_t todo = live & involved;
      while (todo) {
        const int k = __ffsll(static_cast<long long>(todo)) - 1;
        keep |= 1ull << k;
        todo &= ~diag[k];  // bits above k only
        todo &= todo - 1;  // k itself, still the lowest bit
      }
      // the picks in order: slot = picks + kept boxes before this one
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = lane + 32 * h;
        if ((keep >> pos) & 1) {
          const int j = __popcll(keep & ((1ull << pos) - 1));
          kept[j] = base + pos;
          if (picks + j < max_out) {
            out_idx[picks + j] = chunk_idx[pos];
            out_keep[picks + j] = 1;
          }
        }
      }
      if (lane == 0) {
        s_kept = __popcll(keep);
        s_picks = min(max_out, picks + __popcll(keep));
      }
    }
    __syncthreads();
    const int nk = s_kept;
    picks = s_picks;
    if (picks >= max_out || c + 1 == chunks) break;
    // the kept rows' later words into the removed words, one OR a word and
    // warp; and the next chunk's diagonal
    for (int w = c + 1 + lane; w < W; w += 32) {
      uint64_t acc = 0;
      for (int k = warp; k < nk; k += nwarps) {
        acc |= mask[static_cast<size_t>(kept[k]) * W + w];
      }
      if (acc) atomicOr(&removed[w], static_cast<unsigned long long>(acc));
    }
    if (t < kTile) {
      const int p = base + kTile + t;
      diag[t] = p < M ? mask[static_cast<size_t>(p) * W + c + 1] : 0ull;
      chunk_idx[t] = p < M ? sorted_idx[p] : -1;
    }
    __syncthreads();
  }
  for (int q = picks + t; q < max_out; q += blockDim.x) {
    out_idx[q] = -1;
    out_keep[q] = 0;
  }
}

}  // namespace

extern "C" {

int nms_max_boxes() { return kMaxBoxes; }

// Route S. boxes [B, N, 4] f32 xyxy (16-byte aligned), scores [B, N] f32,
// valid [B, N] bool (1 byte), all contiguous; writes idx [B, max_out] int32
// and keep [B, max_out] bool.
int nms_few(const void* boxes, const void* scores, const void* valid, int B,
            int N, float thresh, int max_out, void* idx, void* keep,
            void* stream) {
  if (B < 1 || N < 1 || N > kMaxBoxes || max_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* bx = static_cast<const float4*>(boxes);
  auto* sc = static_cast<const float*>(scores);
  auto* va = static_cast<const uint8_t*>(valid);
  auto* oi = static_cast<int32_t*>(idx);
  auto* ok = static_cast<uint8_t*>(keep);
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = N > kMaxThreads ? kMaxThreads : (N + 31) / 32 * 32;
  const int items = (N + threads - 1) / threads;
  if (items <= 1) return launch_few<1>(bx, sc, va, B, N, threads, thresh, max_out, oi, ok, s);
  if (items <= 2) return launch_few<2>(bx, sc, va, B, N, threads, thresh, max_out, oi, ok, s);
  if (items <= 4) return launch_few<4>(bx, sc, va, B, N, threads, thresh, max_out, oi, ok, s);
  if (items <= 8) return launch_few<8>(bx, sc, va, B, N, threads, thresh, max_out, oi, ok, s);
  return launch_few<16>(bx, sc, va, B, N, threads, thresh, max_out, oi, ok, s);
}

// Route L: the same operands and outputs, and the workspace: sorted_box
// [B, N] float4, sorted_idx [B, N] int32, count [B] int32, mask
// [B, N, ceil(N/64)] uint64.
int nms_many(const void* boxes, const void* scores, const void* valid, int B,
             int N, float thresh, int max_out, void* idx, void* keep,
             void* sorted_box, void* sorted_idx, void* count, void* mask,
             void* stream) {
  if (B < 1 || B > kMaxImages || N < 1 || N > kMaxBoxes || max_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* sbx = static_cast<float4*>(sorted_box);
  auto* sid = static_cast<int32_t*>(sorted_idx);
  auto* cnt = static_cast<int32_t*>(count);
  auto* msk = static_cast<uint64_t*>(mask);
  const int W = (N + kTile - 1) / kTile;

  const size_t rank_smem = static_cast<size_t>((N + 3) & ~3) * sizeof(float);
  cudaError_t e = allow_smem(nms_rank_kernel, rank_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_rank_kernel<<<dim3((N + kRankBoxes - 1) / kRankBoxes, B),
                    kRankBoxes * kRankWarps, rank_smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), N, sbx, sid, cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  nms_mask_kernel<<<dim3(W * (W + 1) / 2, B), kTile * kMaskLanes, 0, s>>>(
      sbx, cnt, N, W, thresh, msk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  nms_scan_kernel<<<B, kScanThreads, W * sizeof(unsigned long long), s>>>(
      msk, sid, cnt, N, W, max_out, static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
