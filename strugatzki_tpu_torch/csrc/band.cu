// The punch's band maximum for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this function as XLA ops
// in strugatzki_tpu/parallel/database.py::_punch_one_from_spectra, and the
// port ran it as eager PyTorch ops (kernels/band.py::band_max_reference,
// about 85 launches a files step, each level of the doubling two shifted
// copies and two selects over [B, W_in + Tp]).  For a files step of B rows,
// punch-in traces sims_in [B, W_in], punch-out traces sims_out [B, W_out]
// (f32) and file lengths lens [B] (i32), with w_pad = W_in + Tp:
//
//   out[o]   = o < W_out and o < lens - L_out + 1 ? (sims_out[o], o)
//              : (-inf, o < w_pad ? o : 0)
//   level 0  = out; level j+1 at o combines level j at o and o + 2^j,
//              taking the right one only where its value is strictly greater
//   best     = the same combine of level j_sel at t + s2 over t + s1
//   band_sim = t < lens - min_punch - L_in + 1 and sims_in > 0 and
//              best > -inf and sims_in * best > 0 ? sqrt(sims_in * best)
//              : -inf
//   best_j   = index(best) - min_punch - t
//
// for every t < W_in, masked positions included (the top-k returns masked
// positions when a file has fewer than k windows).  s1 and s2 are the two
// power blocks' starts min_punch and min_punch + S - 2^j_sel (S the band),
// clamped to [0, Tp] as _window clamps them.  The strict > is not
// associative once a NaN is present (sims_out is NaN where a window's group
// is constant), so the kernel runs the same levels, with the same operand
// order, as the plain version: the bits are the same by construction.  No
// monotone deque or van Herk/Gil-Werman scan would give them.
//
// What bounds it on this card: HBM bytes, one read of sims_in and sims_out
// and one write of band_sim and best_j: 72.8 MB for a files step of 455
// two-minute files (W_in 9,892, W_out 10,322), 21.7 us at 3.35 TB/s.
//
// The design keeps all j_sel levels in shared memory.  One CTA takes a tile
// of t of one row.  It loads the out positions its tile needs, the tile
// plus a halo of |s2 - s1| + 2^j_sel - 1, as (value, index) pairs with
// 16-byte loads (a row's start need not be aligned: the loads start at the
// aligned address at or before the first position, up to three pairs
// earlier, and what lies before the first position is never read, since a
// level only ever reads to the right).  Positions past a file's valid
// windows load as -inf without a read.  Each level is computed in place, in
// chunks of kThreads * kPer positions: every thread reads its pairs into
// registers, the CTA synchronises, every thread writes them; a chunk only
// reads positions at or after its own start, so no chunk reads what an
// earlier one wrote.  The epilogue reads both blocks' pairs from shared
// memory and writes band_sim and best_j coalesced.  kernels/band.py's
// band_plan sizes the tile: 4,096 offsets, 38.3 KB, at S = 690; the tile
// shrinks as S grows.  A band whose halo does not fit 227 KB beside a tile
// of 256 (S over about 28,700 frames, five and a half minutes) takes the
// wide path instead: band_fill_kernel writes level 0 of every row into a
// global scratch of B x w_pad pairs, one band_level_kernel launch a level
// ping-pongs it into a second scratch (the same combine, so the same
// bits), and band_finish_kernel runs the same epilogue: j_sel + 2 launches.
//
// Build without --use_fast_math: sqrtf must be IEEE, as torch.sqrt is.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;  // positions a thread holds in registers a chunk
constexpr int kWideThreads = 256;  // threads a CTA of the wide path

struct __align__(8) Pair {
  float v;
  int a;
};

__device__ __forceinline__ Pair combine(Pair x, Pair y) {
  return y.v > x.v ? y : x;
}

// The gate, the score and the offset of offset t of the row at `at`, from
// the band's best out pair.
__device__ __forceinline__ void emit(Pair best, int t, long long in_end,
                                     int min_punch,
                                     const float* __restrict__ sims_in,
                                     float* __restrict__ band_sim,
                                     int* __restrict__ best_j, size_t at) {
  const float si = sims_in[at + t];
  const float prod = (t < in_end && si > 0.0f && best.v > -INFINITY)
                         ? si * best.v
                         : -INFINITY;
  band_sim[at + t] = prod > 0.0f ? sqrtf(prod) : -INFINITY;
  best_j[at + t] = best.a - min_punch - t;
}

__global__ void __launch_bounds__(kThreads)
    band_max_kernel(const float* __restrict__ sims_in,
                    const float* __restrict__ sims_out,
                    const int* __restrict__ lens, float* __restrict__ band_sim,
                    int* __restrict__ best_j, int W_in, int W_out, int w_pad,
                    int L_in, int L_out, int min_punch, int j_sel, int s1,
                    int s2, int tile, int tiles) {
  extern __shared__ float4 smem[];
  Pair* s = reinterpret_cast<Pair*>(smem);

  const int row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * tile;
  const int n = min(tile, W_in - t0);  // offsets of this tile
  const int lo = min(s1, s2);
  const int hi = max(s1, s2);
  const int tid = threadIdx.x;
  const int len = lens[row];

  // the out positions [g0, g0 + n0) the tile needs; valid below vend
  const int g0 = t0 + lo;
  const int n0 = n + (hi - lo) + (1 << j_sel) - 1;
  const int vend = min(W_out, max(0, len - (L_out - 1)));
  const float* out_row = sims_out + static_cast<size_t>(row) * W_out;
  const int m = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out_row + g0) >> 2) & 3);
  const float4* aligned = reinterpret_cast<const float4*>(out_row + g0 - m);
  const int chunks = (m + n0 + 3) >> 2;
  for (int c = tid; c < chunks; c += kThreads) {
    const int e0 = g0 - m + 4 * c;  // the position of the chunk's lane 0
    float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    // only a chunk that holds a valid position is read: its 16 aligned
    // bytes lie inside the row's allocation
    if (max(e0, g0) < vend) q = aligned[c];
    const float qv[4] = {q.x, q.y, q.z, q.w};
    float4 w[2];
    float* wf = reinterpret_cast<float*>(w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k;
      wf[2 * k] = (e >= g0 && e < vend) ? qv[k] : -INFINITY;
      wf[2 * k + 1] = __int_as_float(e < w_pad ? e : 0);
    }
    smem[2 * c] = w[0];
    smem[2 * c + 1] = w[1];
  }
  __syncthreads();

  // level j+1 at i from level j at i and i + 2^j, for i < n_j - 2^j
  int valid = m + n0;
  for (int j = 0; j < j_sel; ++j) {
    const int sh = 1 << j;
    valid -= sh;
    for (int base = 0; base < valid; base += kThreads * kPer) {
      Pair r[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < valid) r[k] = combine(s[i], s[i + sh]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < valid) s[i] = r[k];
      }
    }
    __syncthreads();
  }

  const long long in_end =
      static_cast<long long>(len) - min_punch - (L_in - 1);
  const size_t at = static_cast<size_t>(row) * W_in;
  for (int q = tid; q < n; q += kThreads) {
    const int t = t0 + q;
    emit(combine(s[m + q + (s1 - lo)], s[m + q + (s2 - lo)]), t, in_end,
         min_punch, sims_in, band_sim, best_j, at);
  }
}

// The wide path, one thread a position.  Level 0 of row r at o < w_pad:
// (sims_out or -inf, o), as the plain version pads it.
__global__ void band_fill_kernel(const float* __restrict__ sims_out,
                                 const int* __restrict__ lens,
                                 Pair* __restrict__ lv, long long total,
                                 int W_out, int w_pad, int L_out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / w_pad;
    const int o = static_cast<int>(i - row * w_pad);
    const int vend = min(W_out, max(0, lens[row] - (L_out - 1)));
    lv[i] = Pair{o < vend ? sims_out[row * W_out + o] : -INFINITY, o};
  }
}

// One level: dst[o] = src[o] combined with src[o + sh] where that lies in
// the row (past it the plain version shifts in (-inf, 0), which never wins).
__global__ void band_level_kernel(const Pair* __restrict__ src,
                                  Pair* __restrict__ dst, long long total,
                                  int w_pad, int sh) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(i % w_pad);
    dst[i] = o < w_pad - sh ? combine(src[i], src[i + sh]) : src[i];
  }
}

// The epilogue of the wide path over level j_sel in lv, one thread a t.
__global__ void band_finish_kernel(const Pair* __restrict__ lv,
                                   const float* __restrict__ sims_in,
                                   const int* __restrict__ lens,
                                   float* __restrict__ band_sim,
                                   int* __restrict__ best_j, long long total,
                                   int W_in, int w_pad, int L_in,
                                   int min_punch, int s1, int s2) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / W_in;
    const int t = static_cast<int>(i - row * W_in);
    const Pair* r = lv + row * w_pad;
    const long long in_end =
        static_cast<long long>(lens[row]) - min_punch - (L_in - 1);
    emit(combine(r[t + s1], r[t + s2]), t, in_end, min_punch, sims_in,
         band_sim, best_j, static_cast<size_t>(row) * W_in);
  }
}

// Makes `device` current for the life of the guard and puts back the device
// that was current before, on success and on error (as in prep.cu).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess) {
      prev_ = -1;
      return;
    }
    if (prev_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace

// Launches band_max_kernel on `stream` (a cudaStream_t of `device`): one
// CTA a tile, `tiles` a row, B rows.  The plan (j_sel, s1, s2, tile, tiles,
// pairs) is kernels/band.py's band_plan.  Returns the first non-zero CUDA
// error code, or 0.
extern "C" int band_max_launch(const float* sims_in, const float* sims_out,
                               const int* lens, float* band_sim, int* best_j,
                               int B, int W_in, int W_out, int w_pad,
                               int L_in, int L_out, int min_punch, int j_sel,
                               int s1, int s2, int tile, int tiles, int pairs,
                               int device, void* stream) {
  if (B < 1 || tile < 1 || tiles < 1 || j_sel < 0 || j_sel > 30 ||
      pairs < 1 || static_cast<long long>(tile) * tiles < W_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_bytes = static_cast<size_t>(pairs) * sizeof(Pair);
  err = cudaFuncSetAttribute(band_max_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_max_kernel<<<static_cast<unsigned>(B) * tiles, kThreads, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      sims_in, sims_out, lens, band_sim, best_j, W_in, W_out, w_pad, L_in,
      L_out, min_punch, j_sel, s1, s2, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Runs the wide path on `stream`: `scratch` holds 2 x B x w_pad pairs of
// 8 bytes.  Returns the first non-zero CUDA error code, or 0.
extern "C" int band_max_wide_launch(const float* sims_in,
                                    const float* sims_out, const int* lens,
                                    float* band_sim, int* best_j,
                                    void* scratch, int B, int W_in,
                                    int W_out, int w_pad, int L_in, int L_out,
                                    int min_punch, int j_sel, int s1, int s2,
                                    int device, void* stream) {
  if (B < 1 || W_in < 1 || w_pad < W_in || j_sel < 0 || j_sel > 30 ||
      s1 < 0 || s2 < 0 || W_in - 1 + std::max(s1, s2) >= w_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto blocks = [](long long total) {
    return static_cast<unsigned>(
        std::min((total + kWideThreads - 1) / kWideThreads, 1LL << 20));
  };
  const long long positions = static_cast<long long>(B) * w_pad;
  Pair* lv[2] = {static_cast<Pair*>(scratch),
                 static_cast<Pair*>(scratch) + positions};
  band_fill_kernel<<<blocks(positions), kWideThreads, 0, st>>>(
      sims_out, lens, lv[0], positions, W_out, w_pad, L_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int j = 0; j < j_sel; ++j) {
    band_level_kernel<<<blocks(positions), kWideThreads, 0, st>>>(
        lv[j & 1], lv[(j + 1) & 1], positions, w_pad, 1 << j);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long outs = static_cast<long long>(B) * W_in;
  band_finish_kernel<<<blocks(outs), kWideThreads, 0, st>>>(
      lv[j_sel & 1], sims_in, lens, band_sim, best_j, outs, W_in, w_pad,
      L_in, min_punch, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
