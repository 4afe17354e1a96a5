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
//   out      = t < len_b ? y - shift_g : -shift_g
//
// The shift is chosen with a select, never a blend, so a NaN or inf shift in
// one group cannot reach the other group's rows.  Frames at or past len_b
// become -shift.  Group sums are taken in double.
//
// What bounds it on this card: HBM bytes.  Each element costs a subtract and
// a divide; the data is [B, C, T] f32 (21 MB for a 32-file chunk, 1.2 GB for
// a 2048-file staging slab), so the least traffic is one read and one write
// of it.  Two kernels:
//
//   prep_one_pass (the rule): one thread-block cluster per file.  Its CTAs
//     split the file's contiguous [C, T] block and bring their parts into
//     shared memory with bulk copies (cp.async.bulk, completed on mbarriers,
//     kStages copies per CTA so the arithmetic starts on the first part while
//     the rest arrives).  Each CTA normalizes its part in place and sums its
//     masked group partials in double; after a cluster barrier every CTA
//     folds all the cluster's partials in rank order through distributed
//     shared memory, so the shifts have the same bits in every CTA and on
//     every run (no atomics), and writes y - shift from shared memory with
//     16-byte stores.  x is read from HBM once.  Bulk copies need 16-byte
//     addresses and sizes: the inner part boundaries sit on 16-byte
//     boundaries, and a file that starts or ends off one (an odd T) loads and
//     stores its few unaligned head and tail elements one by one.  A file
//     must fit the cluster's shared memory (8 CTAs of at most 227 KB); the
//     wrapper (kernels/prep.py) sizes the cluster so that three CTAs share a
//     SM, and doubles it for a launch of one wave.  On an H100 SXM at 700 W
//     it prepares a [2048, 14, 10752] staging slab in 1.08 ms, 68% of the
//     one-read-one-write bound (chip_smoke.py, PERF.md).
//   prep_group_shifts + prep_apply (files too long for a cluster): a masked-
//     group-sum pass in double over a (T-segment, file) grid writing one
//     partial pair per block, then a (T-tile, channel, file) pass that folds
//     its file's partials in a fixed order and fuses normalize, group shift
//     and the tail mask into the one write pass.  It reads x twice.
//
// Build without --use_fast_math: the division must be IEEE so that x/0 keeps
// its inf/NaN, as in the reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// the one-pass cluster kernel
// ---------------------------------------------------------------------------

constexpr int kOneThreads = 256;
constexpr int kStages = 4;       // bulk copies (and mbarriers) per CTA
constexpr int kMaxCluster = 16;  // above 8 only as a non-portable cluster

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Row c and frame t of file element fr (0 <= fr + T, fr < 2^24): a float
// reciprocal and one correction, cheaper than an integer division.
__device__ __forceinline__ void row_frame(int fr, int T, float inv_t, int& c,
                                          int& t) {
  c = static_cast<int>(static_cast<float>(fr) * inv_t);
  t = fr - c * T;
  if (t < 0) {
    --c;
    t += T;
  } else if (t >= T) {
    ++c;
    t -= T;
  }
}

__device__ __forceinline__ float prepared(float y, int c, int t, int n,
                                          int nt, float sh_t, float sh_s) {
  const float shift = c < nt ? sh_t : sh_s;
  return t < n ? y - shift : -shift;
}

// One cluster of nc CTAs per file.  Offsets are 32-bit and relative to the
// file: element fr of file b sits at u = fr + ph, where ph = (b·C·T) mod 4,
// so u is 16-byte aligned exactly where the element's address is (x and
// out are).  A CTA's part is [lo, hi) in u; buf[i] holds element base + i.
__global__ void __launch_bounds__(kOneThreads)
prep_one_pass(const float* __restrict__ x, const float* __restrict__ norm,
              const int* __restrict__ lens, int C, int T, int nt,
              float* __restrict__ out, float* __restrict__ shift_t,
              float* __restrict__ shift_s) {
  extern __shared__ __align__(16) float buf[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ double part[2];  // this CTA's group sums, read by its cluster
  __shared__ double warp_sums[2][kOneThreads / 32];
  __shared__ float shifts[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nc;
  const int n = lens[b];
  const int CT = C * T;
  const long long f0 = static_cast<long long>(b) * CT;
  const int ph = static_cast<int>(f0 & 3);
  const float* xa = x + (f0 - ph);  // 16-byte aligned
  float* oa = out + (f0 - ph);
  const float inv_t = 1.0f / static_cast<float>(T);
  // the part's bounds: inner ones round up to 16 bytes
  const int chunk = (CT + nc - 1) / nc;
  const int lo = r == 0 ? ph : min(ph + CT, (ph + r * chunk + 3) & ~3);
  const int hi = r == nc - 1 ? ph + CT
                             : min(ph + CT, (ph + (r + 1) * chunk + 3) & ~3);
  const int base = lo & ~3;
  const int a_lo = min((lo + 3) & ~3, hi);
  const int a_hi = max(hi & ~3, a_lo);
  // the bulk-copied span [a_lo, a_hi) in kStages pieces of whole 16 bytes
  const int groups = (a_hi - a_lo) / 4;
  const int per_stage = (groups + kStages - 1) / kStages;
  auto stage_start = [&](int s) { return a_lo + 4 * min(s * per_stage, groups); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the unaligned head and tail, one element per thread
  for (int u = lo + threadIdx.x; u < a_lo; u += kOneThreads) buf[u - base] = xa[u];
  for (int u = a_hi + threadIdx.x; u < hi; u += kOneThreads) buf[u - base] = xa[u];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int p0 = stage_start(s);
      const uint32_t bytes = static_cast<uint32_t>(4 * (stage_start(s + 1) - p0));
      const uint32_t bar = smem_addr(&bars[s]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
          "r"(bytes)
          : "memory");
      if (bytes > 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf + (p0 - base))),
            "l"(xa + p0), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
  }

  // normalize each piece in place as it lands and sum the valid elements
  double acc_t = 0.0;
  double acc_s = 0.0;
  int cur_c = -1;
  float mn = 0.0f, rng = 1.0f;
  for (int s = 0; s < kStages; ++s) {
    mbar_wait(smem_addr(&bars[s]), 0);
    const int q0 = s == 0 ? lo : stage_start(s);
    const int q1 = s == kStages - 1 ? hi : stage_start(s + 1);
    // an empty piece may still share its 16 bytes with another piece
    if (q0 >= q1) continue;
    for (int u0 = (q0 & ~3) + 4 * threadIdx.x; u0 < q1; u0 += 4 * kOneThreads) {
      float4 v = *reinterpret_cast<float4*>(buf + (u0 - base));
      float vs[4] = {v.x, v.y, v.z, v.w};
      int c, t;
      row_frame(u0 - ph, T, inv_t, c, t);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (u0 + k >= q0 && u0 + k < q1) {
          if (c != cur_c) {
            cur_c = c;
            mn = norm[2 * c];
            rng = norm[2 * c + 1] - mn;
          }
          const float y = (vs[k] - mn) / rng;
          vs[k] = y;
          const double yd = t < n ? static_cast<double>(y) : 0.0;
          if (c < nt) {
            acc_t += yd;
          } else {
            acc_s += yd;
          }
        }
        if (++t == T) {
          t = 0;
          ++c;
        }
      }
      *reinterpret_cast<float4*>(buf + (u0 - base)) =
          make_float4(vs[0], vs[1], vs[2], vs[3]);
    }
  }

  // this CTA's partials: warps, then the warps in order
  for (int o = 16; o > 0; o >>= 1) {
    acc_t += __shfl_down_sync(0xffffffffu, acc_t, o);
    acc_s += __shfl_down_sync(0xffffffffu, acc_s, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[0][warp] = acc_t;
    warp_sums[1][warp] = acc_s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double st = 0.0;
    double ss = 0.0;
    for (int w = 0; w < kOneThreads / 32; ++w) {
      st += warp_sums[0][w];
      ss += warp_sums[1][w];
    }
    part[0] = st;
    part[1] = ss;
  }
  cluster.sync();  // every CTA's partials are written and visible
  if (threadIdx.x == 0) {
    double st = 0.0;
    double ss = 0.0;
    for (int q = 0; q < nc; ++q) {  // rank order: the same bits in every CTA
      const double* p = cluster.map_shared_rank(part, q);
      st += p[0];
      ss += p[1];
    }
    shifts[0] = static_cast<float>(st / static_cast<double>(max(n * nt, 1)));
    shifts[1] = static_cast<float>(
        ss / static_cast<double>(max(n * (C - nt), 1)));
    if (r == 0) {
      shift_t[b] = shifts[0];
      shift_s[b] = shifts[1];
    }
  }
  __syncthreads();
  // done reading the other CTAs' shared memory; wait for them before exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float sh_t = shifts[0];
  const float sh_s = shifts[1];

  for (int u = lo + threadIdx.x; u < a_lo; u += kOneThreads) {
    int c, t;
    row_frame(u - ph, T, inv_t, c, t);
    oa[u] = prepared(buf[u - base], c, t, n, nt, sh_t, sh_s);
  }
  for (int u = a_hi + threadIdx.x; u < hi; u += kOneThreads) {
    int c, t;
    row_frame(u - ph, T, inv_t, c, t);
    oa[u] = prepared(buf[u - base], c, t, n, nt, sh_t, sh_s);
  }
  for (int u0 = a_lo + 4 * threadIdx.x; u0 < a_hi; u0 += 4 * kOneThreads) {
    const float4 v = *reinterpret_cast<const float4*>(buf + (u0 - base));
    float vs[4] = {v.x, v.y, v.z, v.w};
    int c, t;
    row_frame(u0 - ph, T, inv_t, c, t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vs[k] = prepared(vs[k], c, t, n, nt, sh_t, sh_s);
      if (++t == T) {
        t = 0;
        ++c;
      }
    }
    *reinterpret_cast<float4*>(oa + u0) =
        make_float4(vs[0], vs[1], vs[2], vs[3]);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Dynamic shared memory of one CTA of a cluster of `nc` over a [C, T] file:
// its part plus the alignment slack of both ends, in whole 16 bytes.
size_t one_pass_smem(int C, int T, int nc) {
  const long long CT = static_cast<long long>(C) * T;
  const long long chunk = (CT + nc - 1) / nc;
  return static_cast<size_t>(((chunk + 12 + 3) / 4) * 16);
}

// ---------------------------------------------------------------------------
// the two-pass kernels, for files too long for a cluster
// ---------------------------------------------------------------------------

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

namespace {

// Makes `device` current for the life of the guard, and puts back the device
// that was current before when the guard goes out of scope, so an entry point
// leaves the caller's current device as it found it on success and on error.
// (PyTorch's own device guard does not see a switch made here: it would keep
// the launch's device current after the call.)
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

// Sets the attributes the one-pass kernel needs for clusters of `nc` over
// [C, T] files, and fills `cfg` and `attr` for a grid of `blocks` CTAs.
cudaError_t one_pass_config(int C, int T, int nc, unsigned blocks,
                            cudaStream_t stream, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
  const size_t smem = one_pass_smem(C, T, nc);
  cudaError_t err = cudaFuncSetAttribute(
      prep_one_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory: three 75 KB CTAs a SM
  err = cudaFuncSetAttribute(
      prep_one_pass, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  if (nc > 8) {
    err = cudaFuncSetAttribute(
        prep_one_pass, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kOneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nc;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Launches the one-pass kernel on `stream` (a cudaStream_t of `device`), one
// cluster of `nc` CTAs per file.  x and out must be 16-byte aligned and a
// CTA's part must fit its shared memory (one_pass_smem); a cluster the card
// cannot place is refused by the launch.  Returns the first non-zero CUDA
// error code, or 0.
extern "C" int prep_one_pass_launch(const float* x, const float* norm,
                                    const int* lens, float* out,
                                    float* shift_t, float* shift_s, int B,
                                    int C, int T, int nt, int nc, int device,
                                    void* stream) {
  if (nc < 1 || nc > kMaxCluster ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
              16 !=
          0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = one_pass_config(C, T, nc, static_cast<unsigned>(B) * nc,
                        static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, prep_one_pass, x, norm, lens, C, T, nt, out,
                           shift_t, shift_s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `nc` one-pass CTAs over a [C, T] file the card holds
// at once (cudaOccupancyMaxActiveClusters) in *clusters.  Returns the CUDA
// error code, or 0.
extern "C" int prep_one_pass_clusters(int C, int T, int nc, int device,
                                      int* clusters) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = one_pass_config(C, T, nc, static_cast<unsigned>(nc), nullptr, cfg,
                        attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, prep_one_pass, &cfg));
}

// Launches both passes of the two-pass kernel on `stream` (a cudaStream_t of
// `device`).  `partial` is caller-allocated scratch of
// B * ceil(T / seg_len) * 2 doubles.  Returns the first non-zero
// cudaGetLastError() code, or 0.
extern "C" int prep_launch(const float* x, const float* norm, const int* lens,
                           float* out, float* shift_t, float* shift_s,
                           double* partial, int B, int C, int T, int nt,
                           int seg_len, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
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
