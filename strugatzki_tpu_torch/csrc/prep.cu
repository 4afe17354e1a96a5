// Fused feature-database preparation for Hopper (sm_90a).
//
// Replaces strugatzki_tpu/kernels/pallas_prep.py::_prep_kernel together with
// the XLA shift reduction it is fed by, _group_shifts.  For features
// x [B, C, T] f32, a per-channel (min, max) norm [C, 2] f32 and per-file valid
// lengths lens [B] i32:
//
//   y        = (x - min_c) / (max_c - min_c)       unclipped: a degenerate
//                                                  range keeps its inf/NaN
//   shift_g  = sum over valid frames and the rows of group g of y,
//              divided by max(n * rows(g), 1)       g = temporal (c < nt) or
//                                                  spectral (c >= nt)
//   out      = (t < len_b ? y : 0) - (c < nt ? shift_t : shift_s)
//
// The shift is chosen with a select, never a blend, so a NaN or inf shift in
// one group cannot reach the other group's rows.  Frames at or past len_b
// become -shift.
//
// What bounds it on this card: HBM bytes.  Each element costs a subtract and
// a divide; the data is [B, C, T] f32 (21 MB for a 32-file chunk).  The design
// reads x twice and writes it once:
//   pass 1, prep_group_shifts: a (T-segment, file) grid; each block reduces the
//     masked group sums of its segment in double and writes one partial pair;
//   pass 2, prep_apply: a (T-tile, channel, file) grid; each block folds its
//     file's partials in a fixed order (deterministic, no atomics) and fuses
//     normalize, group shift and the tail mask into the one write pass.
// Both grids give a 32-file chunk enough blocks to fill the 132 SMs, and every
// load and store is coalesced along T.  The TPU kernel took one file per grid
// step with the whole [C, T] block resident in VMEM, which capped T; here T is
// tiled and any length works.
//
// Build without --use_fast_math: the division must be IEEE so that x/0 keeps
// its inf/NaN, as in the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // frames per prep_apply block

// Sum of v over the block; the result is valid on thread 0.
__device__ __forceinline__ double block_sum(double v, double* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  double r = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) r += smem[w];
  }
  __syncthreads();  // smem is reused by the next call
  return r;
}

__global__ void __launch_bounds__(kThreads)
prep_group_shifts(const float* __restrict__ x, const float* __restrict__ norm,
                  const int* __restrict__ lens, int C, int T, int nt,
                  int seg_len, double* __restrict__ partial) {
  __shared__ double smem[kThreads / 32];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int S = gridDim.x;
  const int t0 = s * seg_len;
  const int t1 = min(min(t0 + seg_len, T), lens[b]);  // empty when lens <= t0
  double acc_t = 0.0;
  double acc_s = 0.0;
  for (int c = 0; c < C; ++c) {
    const float mn = norm[2 * c];
    const float rng = norm[2 * c + 1] - mn;
    const float* row = x + (static_cast<size_t>(b) * C + c) * T;
    double acc = 0.0;
    for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
      acc += static_cast<double>((row[t] - mn) / rng);
    }
    if (c < nt) {
      acc_t += acc;
    } else {
      acc_s += acc;
    }
  }
  acc_t = block_sum(acc_t, smem);
  acc_s = block_sum(acc_s, smem);
  if (threadIdx.x == 0) {
    double* p = partial + (static_cast<size_t>(b) * S + s) * 2;
    p[0] = acc_t;
    p[1] = acc_s;
  }
}

__global__ void __launch_bounds__(kThreads)
prep_apply(const float* __restrict__ x, const float* __restrict__ norm,
           const int* __restrict__ lens, const double* __restrict__ partial,
           int S, int C, int T, int nt, float* __restrict__ out,
           float* __restrict__ shift_t, float* __restrict__ shift_s) {
  __shared__ float shifts[2];
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int n = lens[b];
  if (threadIdx.x == 0) {
    double st = 0.0;
    double ss = 0.0;
    const double* p = partial + static_cast<size_t>(b) * S * 2;
    for (int s = 0; s < S; ++s) {
      st += p[2 * s];
      ss += p[2 * s + 1];
    }
    shifts[0] = static_cast<float>(st / static_cast<double>(max(n * nt, 1)));
    shifts[1] = static_cast<float>(
        ss / static_cast<double>(max(n * (C - nt), 1)));
    if (blockIdx.x == 0 && c == 0) {
      shift_t[b] = shifts[0];
      shift_s[b] = shifts[1];
    }
  }
  __syncthreads();
  const float shift = c < nt ? shifts[0] : shifts[1];
  const float mn = norm[2 * c];
  const float rng = norm[2 * c + 1] - mn;
  const size_t base = (static_cast<size_t>(b) * C + c) * T;
  const int tile0 = blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kTile / kThreads; ++k) {
    const int t = tile0 + k * kThreads + threadIdx.x;
    if (t < T) {
      const float y = (x[base + t] - mn) / rng;
      out[base + t] = (t < n ? y : 0.0f) - shift;
    }
  }
}

}  // namespace

// Launches both passes on `stream` (a cudaStream_t of `device`).  `partial`
// is caller-allocated scratch of B * ceil(T / seg_len) * 2 doubles.  Returns
// the first non-zero cudaGetLastError() code, or 0.
extern "C" int prep_launch(const float* x, const float* norm, const int* lens,
                           float* out, float* shift_t, float* shift_s,
                           double* partial, int B, int C, int T, int nt,
                           int seg_len, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (T + seg_len - 1) / seg_len;
  prep_group_shifts<<<dim3(S, B), kThreads, 0, st>>>(x, norm, lens, C, T, nt,
                                                      seg_len, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prep_apply<<<dim3((T + kTile - 1) / kTile, C, B), kThreads, 0, st>>>(
      x, norm, lens, partial, S, C, T, nt, out, shift_t, shift_s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
