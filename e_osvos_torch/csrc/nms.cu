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
// and a box stays alive iff iou <= threshold (a NaN IoU kills it).
//
// Bound: the bytes (24 a box, read once) and the operations (about 15 a box
// a round) both give microseconds. The real floor is latency: max_out
// dependent rounds, each a block-wide arg-max reduction and a broadcast, so
// the kernel is bound by round latency, not by the memory or the ALUs.
//
// Design: one block of 1024 threads per image (grid = images). Thread t
// holds the boxes t, t + 1024, t + 2048, ... (ITEMS = ceil(N / 1024),
// rounded up to a power of two, at most 16) in registers for all rounds, with
// their alive flags as bits of one register; nothing is re-read from device
// memory. A round is a thread-local arg-max, a warp arg-max with
// __shfl_xor_sync, a 32-entry arg-max across warps in shared memory, the
// owning thread's broadcast of the winner's coordinates through shared
// memory, and the alive update in registers: three __syncthreads a round. Once
// nothing is alive the remaining outputs are written as -1 / false and the
// block exits (every later round would find nothing). No atomics. At 16 items
// a thread (N > 8192) the boxes no longer fit the 64 registers a thread has
// at 1024 threads, and ptxas spills to local memory (L1-cached).
//
// Built with -fmad=false: a fused multiply-add in the IoU would round
// differently from the twin's separate multiply and add, and the suppression
// decision is discontinuous at the threshold.
//
// Plain C interface (built with nvcc into a shared library and loaded with
// ctypes); the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one cross-warp entry per lane
constexpr int kMaxItems = 16;          // N <= 16384

// NaN-propagating max/min, as torch.maximum/minimum and jnp.maximum/minimum
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// (s, i) beats (s2, i2): higher score, then lower index
__device__ __forceinline__ bool beats(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads, 1)
    nms_kernel(const float* __restrict__ boxes,
               const float* __restrict__ scores,
               const uint8_t* __restrict__ valid, int N, float thresh,
               int max_out, int32_t* __restrict__ out_idx,
               uint8_t* __restrict__ out_keep) {
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_s;
  __shared__ int win_i;
  __shared__ float win_box[4];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t b = blockIdx.x;
  boxes += b * N * 4;
  scores += b * N;
  valid += b * N;
  out_idx += b * max_out;
  out_keep += b * max_out;

  float x1[ITEMS], y1[ITEMS], x2[ITEMS], y2[ITEMS], sc[ITEMS];
  uint32_t alive = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * kThreads + t;
    if (i < N) {
      x1[j] = boxes[4 * i];
      y1[j] = boxes[4 * i + 1];
      x2[j] = boxes[4 * i + 2];
      y2[j] = boxes[4 * i + 3];
      sc[j] = scores[i];
      if (valid[i] && sc[j] > -INFINITY) alive |= 1u << j;
    } else {
      x1[j] = y1[j] = x2[j] = y2[j] = 0.f;
      sc[j] = -INFINITY;
    }
  }

  for (int r = 0; r < max_out; ++r) {
    // arg-max over this thread's alive boxes; j ascending keeps the lowest
    // index on ties
    float bs = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (((alive >> j) & 1u) && sc[j] > bs) {
        bs = sc[j];
        bi = j * kThreads + t;
      }
    }
    warp_argmax(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
      warp_argmax(bs, bi);
      if (lane == 0) {
        win_s = bs;
        win_i = bi;
      }
    }
    __syncthreads();
    bs = win_s;
    bi = win_i;
    if (!(bs > -INFINITY)) {  // nothing alive: this and every later round
      for (int k = r + t; k < max_out; k += kThreads) {
        out_idx[k] = -1;
        out_keep[k] = 0;
      }
      return;
    }
    if (t == bi % kThreads) {
      const int jb = bi / kThreads;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (j == jb) {
          win_box[0] = x1[j];
          win_box[1] = y1[j];
          win_box[2] = x2[j];
          win_box[3] = y2[j];
        }
      }
    }
    if (t == 0) {
      out_idx[r] = bi;
      out_keep[r] = 1;
    }
    __syncthreads();
    const float bx1 = win_box[0], by1 = win_box[1];
    const float bx2 = win_box[2], by2 = win_box[3];
    const float barea = max_nan(bx2 - bx1, 0.f) * max_nan(by2 - by1, 0.f);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if ((alive >> j) & 1u) {
        const float area =
            max_nan(x2[j] - x1[j], 0.f) * max_nan(y2[j] - y1[j], 0.f);
        const float iw =
            max_nan(min_nan(x2[j], bx2) - max_nan(x1[j], bx1), 0.f);
        const float ih =
            max_nan(min_nan(y2[j], by2) - max_nan(y1[j], by1), 0.f);
        const float inter = iw * ih;
        const float uni = area + barea - inter;
        const float iou = uni > 0.f ? inter / max_nan(uni, 1e-9f) : 0.f;
        if (!(iou <= thresh) || j * kThreads + t == bi) alive &= ~(1u << j);
      }
    }
  }
}

template <int ITEMS>
void launch(const float* boxes, const float* scores, const uint8_t* valid,
            int B, int N, float thresh, int max_out, int32_t* idx,
            uint8_t* keep, cudaStream_t stream) {
  nms_kernel<ITEMS><<<B, kThreads, 0, stream>>>(boxes, scores, valid, N,
                                                 thresh, max_out, idx, keep);
}

}  // namespace

extern "C" {

int nms_max_boxes() { return kThreads * kMaxItems; }

// boxes [B, N, 4] f32 xyxy, scores [B, N] f32, valid [B, N] bool (1 byte),
// all contiguous; writes idx [B, max_out] int32 and keep [B, max_out] bool.
int nms_greedy(const void* boxes, const void* scores, const void* valid,
               int B, int N, float thresh, int max_out, void* idx, void* keep,
               void* stream) {
  if (B < 1 || N < 1 || N > kThreads * kMaxItems || max_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* bx = static_cast<const float*>(boxes);
  auto* sc = static_cast<const float*>(scores);
  auto* va = static_cast<const uint8_t*>(valid);
  auto* oi = static_cast<int32_t*>(idx);
  auto* ok = static_cast<uint8_t*>(keep);
  auto s = static_cast<cudaStream_t>(stream);
  const int items = (N + kThreads - 1) / kThreads;
  if (items <= 1) {
    launch<1>(bx, sc, va, B, N, thresh, max_out, oi, ok, s);
  } else if (items <= 2) {
    launch<2>(bx, sc, va, B, N, thresh, max_out, oi, ok, s);
  } else if (items <= 4) {
    launch<4>(bx, sc, va, B, N, thresh, max_out, oi, ok, s);
  } else if (items <= 8) {
    launch<8>(bx, sc, va, B, N, thresh, max_out, oi, ok, s);
  } else {
    launch<16>(bx, sc, va, B, N, thresh, max_out, oi, ok, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
