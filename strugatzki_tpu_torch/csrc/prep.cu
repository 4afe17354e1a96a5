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
// a 2048-file staging slab), so the least traffic is one read of the valid
// frames (t < len_b: nothing else reaches the result) and one write of all
// of it.
//
// prep_long, one persistent cooperative launch of as many CTAs as the card
// holds at once, takes files of every length.  A global ticket hands out
// row tiles: first every file's tiles that hold valid frames ("reduce"
// tiles), file by file, then every file's tiles of padding alone, whose
// shifts are then long published.  A reduce tile brings its valid frames
// into shared memory with bulk copies (cp.async.bulk, completed on
// mbarriers), normalizes them in place, sums them in double and publishes
// its partial; the last of the file's reduce tiles to arrive folds the
// partials in a fixed order (the same bits on every run) and publishes the
// shifts with release semantics.  Where a file's tiles all fit the resident
// CTAs, each reduce tile waits for the shifts (an acquire load) and writes
// its frames from shared memory, so x is read once; otherwise (a file over
// about 454,000 frames, 88 minutes, at C = 14) the reduce tiles are
// dispensed once more at the end of the queue to be read again and
// written.  A tile only ever waits on tiles dispensed before it, held by
// running CTAs that never wait before they publish, so no file length can
// deadlock it (tests/test_torch_prep.py simulates the queue).  Padding is
// never read: frames t >= len_b become -shift.  On an NVIDIA H100 80GB HBM3
// at a 700 W limit it prepares a [2048, 14, 10752] staging slab of
// two-minute files in 1.03 ms, 70% of the bound, a song library's
// [2048, 14, 36352] slab in 2.78 ms, 70%, a -c chunk holding an hour-long
// file, [32, 14, 338990], in 0.250 ms, 79%, and eight 1-2 hour broadcasts,
// [8, 14, 662092], read twice, in 0.273 ms, 55% (chip_smoke.py, PERF.md).
//
// Build without --use_fast_math: the division must be IEEE so that x/0 keeps
// its inf/NaN, as in the reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

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

constexpr int kThreads = 256;
constexpr int kStages = 2;  // bulk copies (and mbarriers) per tile
constexpr unsigned kMaxSpins = 1u << 27;  // at least 64 ns each: > 8 s

// What a ticket asks of its CTA (kernels/prep.py::long_queue mirrors the
// decode of long_slot below).
enum SlotKind : int {
  kHold = 0,    // reduce a tile of valid frames, wait, write it (resident)
  kReduce = 1,  // reduce a tile of valid frames only (re-read plan)
  kTail = 2,    // write a tile of padding alone as -shift
  kReread = 3,  // read a tile of valid frames again and write it
};

struct Slot {
  int kind, b, c, k;  // file b, row c, tile k of the row
  int nv;             // the file's tiles of valid frames a row
};

// Tiles of valid frames in a row of a file of n frames.
__device__ __forceinline__ int valid_tiles(int n, int T, int TT) {
  return (min(max(n, 0), T) + TT - 1) / TT;
}

// The largest b in [0, B) with key(b) <= t, where key is nondecreasing,
// key(0) = 0 <= t < key(B).
template <typename Key>
__device__ __forceinline__ int last_at_most(long long t, int B, Key key) {
  int lo = 0;
  int hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (key(mid) <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Ticket t of the queue.  prefix[b] = C·(nv_0 + ... + nv_{b-1}) counts the
// reduce tiles of the files before b, so R = prefix[B] is all of them:
//   [0, R)             every file's reduce tiles, file by file, row-major
//   [R, B·C·NT)        every file's tiles of padding alone, likewise
//   [B·C·NT, + R)      re-read plan only: the reduce tiles' frames again
// A tile of padding waits on its file's reduce tiles, all dispensed before
// it; a held reduce tile waits on its own file's, which fit the grid.
__device__ __forceinline__ Slot long_slot(long long t, const int* prefix,
                                          int B, int C, int NT,
                                          bool resident) {
  const int R = prefix[B];
  const long long CN = static_cast<long long>(C) * NT;
  Slot s;
  long long o;
  if (t >= R && t < B * CN) {
    // the tiles of padding of the files before b: b·C·NT - prefix[b]
    const long long u = t - R;
    s.b = last_at_most(u, B, [&](int b) { return b * CN - prefix[b]; });
    s.nv = (prefix[s.b + 1] - prefix[s.b]) / C;
    o = u - (s.b * CN - prefix[s.b]);
    const int m = NT - s.nv;
    s.kind = kTail;
    s.c = static_cast<int>(o / m);
    s.k = s.nv + static_cast<int>(o % m);
    return s;
  }
  const long long u = t < R ? t : t - B * CN;
  s.b = last_at_most(u, B, [&](int b) { return prefix[b]; });
  s.nv = (prefix[s.b + 1] - prefix[s.b]) / C;
  o = u - prefix[s.b];
  s.kind = t >= R ? kReread : resident ? kHold : kReduce;
  s.c = static_cast<int>(o / s.nv);
  s.k = static_cast<int>(o % s.nv);
  return s;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Persistent: CTA 0 first writes prefix (see long_slot) and the grid syncs;
// then each CTA takes tickets until the queue is empty.  Thread 0 asks for
// its next ticket as soon as the current tile can no longer wait, so the
// atomic's round trip overlaps the tile's stores (a CTA never holds an
// unstarted ticket while it waits).  A file's counter arrived[b] counts its
// reduce tiles in; the one that makes it C·nv folds the partials and adds
// one more, which publishes the shifts.  partial[t] is reduce ticket t's
// sum, so a file's partials are partial[prefix[b] .. prefix[b + 1]), its
// temporal rows' first.  Offsets inside a tile are 32-bit and relative to
// the tile's first element rounded down to 16 bytes: buf[u] holds element
// base + u (x and out are 16-byte aligned).
__global__ void __launch_bounds__(kThreads, 4)
prep_long(const float* __restrict__ x, const float* __restrict__ norm,
          const int* __restrict__ lens, int B, int C, int T, int nt, int TT,
          int NT, int resident, float* __restrict__ out,
          float* __restrict__ shift_t, float* __restrict__ shift_s,
          double* __restrict__ partial, unsigned long long* __restrict__ ticket,
          int* __restrict__ prefix, unsigned* __restrict__ arrived) {
  extern __shared__ __align__(16) float buf[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ double warp_sums[kThreads / 32];
  __shared__ int scan[kThreads];
  __shared__ long long s_ticket;
  __shared__ int s_last;
  __shared__ float s_shift;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x == 0) {
    // prefix over the files: each thread a run of files, then a block scan
    const int per = (B + kThreads - 1) / kThreads;
    const int b0 = min(B, static_cast<int>(threadIdx.x) * per);
    const int b1 = min(B, b0 + per);
    int sum = 0;
    for (int b = b0; b < b1; ++b) sum += valid_tiles(lens[b], T, TT);
    scan[threadIdx.x] = sum;
    __syncthreads();
    for (int o = 1; o < kThreads; o <<= 1) {
      const int v = threadIdx.x >= o ? scan[threadIdx.x - o] : 0;
      __syncthreads();
      scan[threadIdx.x] += v;
      __syncthreads();
    }
    int run = scan[threadIdx.x] - sum;
    for (int b = b0; b < b1; ++b) {
      prefix[b] = C * run;
      run += valid_tiles(lens[b], T, TT);
    }
    if (threadIdx.x == kThreads - 1) prefix[B] = C * run;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cg::this_grid().sync();  // prefix is written and visible

  const long long CN = static_cast<long long>(C) * NT;
  const long long total = B * CN + (resident ? 0 : __ldcg(prefix + B));
  uint32_t parity = 0;
  unsigned long long next = 0;
  if (threadIdx.x == 0) next = atomicAdd(ticket, 1ULL);

  for (;;) {
    if (threadIdx.x == 0) s_ticket = static_cast<long long>(next);
    __syncthreads();
    const long long tk = s_ticket;
    // every thread has its ticket and is done with the last tile's buffer
    __syncthreads();
    if (tk >= total) break;
    const Slot sl = long_slot(tk, prefix, B, C, NT, resident != 0);
    const int b = sl.b;
    const int n = min(max(lens[b], 0), T);
    const int t0 = sl.k * TT;
    const int len = min(TT, T - t0);
    const int valid = sl.kind == kTail ? 0 : min(len, n - t0);
    const long long g0 = (static_cast<long long>(b) * C + sl.c) * T + t0;
    const int ph = static_cast<int>(g0 & 3);
    const float* xa = x + (g0 - ph);  // 16-byte aligned
    float* oa = out + (g0 - ph);

    if (valid > 0) {
      // the valid frames [ph, hi): unaligned ends one by one, the rest in
      // kStages bulk copies of whole 16 bytes
      const int hi = ph + valid;
      const int a_lo = min((ph + 3) & ~3, hi);
      const int a_hi = max(hi & ~3, a_lo);
      const int groups = (a_hi - a_lo) / 4;
      const int per_stage = (groups + kStages - 1) / kStages;
      auto stage_start = [&](int s) {
        return a_lo + 4 * min(s * per_stage, groups);
      };
      for (int u = ph + threadIdx.x; u < a_lo; u += kThreads) buf[u] = xa[u];
      for (int u = a_hi + threadIdx.x; u < hi; u += kThreads) buf[u] = xa[u];
      if (threadIdx.x == 0) {
        // the last tile's generic accesses to buf before these async writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int s = 0; s < kStages; ++s) {
          const int p0 = stage_start(s);
          const uint32_t bytes =
              static_cast<uint32_t>(4 * (stage_start(s + 1) - p0));
          const uint32_t bar = smem_addr(&bars[s]);
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  bar),
              "r"(bytes)
              : "memory");
          if (bytes > 0) {
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
                "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf + p0)),
                "l"(xa + p0), "r"(bytes), "r"(bar)
                : "memory");
          }
        }
      }
      __syncthreads();  // the unaligned ends are in buf

      const float mn = norm[2 * sl.c];
      const float rng = norm[2 * sl.c + 1] - mn;
      double acc = 0.0;
      for (int s = 0; s < kStages; ++s) {
        mbar_wait(smem_addr(&bars[s]), parity);
        const int q0 = s == 0 ? ph : stage_start(s);
        const int q1 = s == kStages - 1 ? hi : stage_start(s + 1);
        // an empty piece may still share its 16 bytes with another piece
        if (q0 >= q1) continue;
        for (int u0 = (q0 & ~3) + 4 * threadIdx.x; u0 < q1;
             u0 += 4 * kThreads) {
          float4 v = *reinterpret_cast<float4*>(buf + u0);
          float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (u0 + e >= q0 && u0 + e < q1) {
              vs[e] = (vs[e] - mn) / rng;
              acc += static_cast<double>(vs[e]);
            }
          }
          *reinterpret_cast<float4*>(buf + u0) =
              make_float4(vs[0], vs[1], vs[2], vs[3]);
        }
      }
      parity ^= 1;

      if (sl.kind == kHold || sl.kind == kReduce) {
        // the tile's sum: warps, then the warps in order
        for (int o = 16; o > 0; o >>= 1) {
          acc += __shfl_down_sync(0xffffffffu, acc, o);
        }
        if (lane == 0) warp_sums[warp] = acc;
        __syncthreads();
        const int cv = C * sl.nv;
        if (threadIdx.x == 0) {
          double sum = 0.0;
          for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
          __stcg(partial + tk, sum);
          s_last = atom_add_acq_rel(arrived + b, 1u) ==
                   static_cast<unsigned>(cv - 1);
        }
        __syncthreads();
        if (s_last && warp == 0) {
          // the file's partials in a fixed order: lane l takes l, l + 32,
          // ... of each group, then a fixed tree over the lanes
          const double* p = partial + prefix[b];
          const int split = min(nt, C) * sl.nv;
          double st = 0.0;
          double ss = 0.0;
          for (int i = lane; i < split; i += 32) st += __ldcg(p + i);
          for (int i = split + lane; i < cv; i += 32) ss += __ldcg(p + i);
          for (int o = 16; o > 0; o >>= 1) {
            st += __shfl_down_sync(0xffffffffu, st, o);
            ss += __shfl_down_sync(0xffffffffu, ss, o);
          }
          if (lane == 0) {
            __stcg(shift_t + b, static_cast<float>(
                                    st / static_cast<double>(
                                             max(lens[b] * nt, 1))));
            __stcg(shift_s + b,
                   static_cast<float>(ss / static_cast<double>(
                                               max(lens[b] * (C - nt), 1))));
            red_release(arrived + b, 1u);  // publishes the shifts
          }
        }
        if (sl.kind == kReduce) {
          if (threadIdx.x == 0) next = atomicAdd(ticket, 1ULL);
          continue;
        }
      }
    }

    // the file's shift for this row: published by its last reduce tile, or
    // 0 for a file with no valid frame
    if (threadIdx.x == 0) {
      float sh_t = 0.0f;
      float sh_s = 0.0f;
      if (sl.nv > 0) {
        const unsigned done = static_cast<unsigned>(C * sl.nv + 1);
        // a wait is microseconds; one of seconds means a broken queue, and
        // the launch fails rather than hang the card
        for (unsigned spins = 0; ld_acquire(arrived + b) != done; ++spins) {
          if (spins == kMaxSpins) __trap();
          __nanosleep(64);
        }
        sh_t = __ldcg(shift_t + b);
        sh_s = __ldcg(shift_s + b);
      } else if (sl.c == 0 && sl.k == 0) {
        shift_t[b] = 0.0f;
        shift_s[b] = 0.0f;
      }
      s_shift = sl.c < nt ? sh_t : sh_s;
      next = atomicAdd(ticket, 1ULL);  // used after the stores
    }
    __syncthreads();
    const float shift = s_shift;

    // write [ph, ph + len): valid frames y - shift from buf, padding -shift
    const int vend = ph + valid;
    const int end = ph + len;
    const int s_lo = min((ph + 3) & ~3, end);
    const int s_hi = max(end & ~3, s_lo);
    for (int u = ph + threadIdx.x; u < s_lo; u += kThreads) {
      oa[u] = u < vend ? buf[u] - shift : -shift;
    }
    for (int u = s_hi + threadIdx.x; u < end; u += kThreads) {
      oa[u] = u < vend ? buf[u] - shift : -shift;
    }
    for (int u0 = s_lo + 4 * threadIdx.x; u0 < s_hi; u0 += 4 * kThreads) {
      float4 v = make_float4(-shift, -shift, -shift, -shift);
      if (u0 < vend) {
        const float4 y = *reinterpret_cast<const float4*>(buf + u0);
        v.x = y.x - shift;
        if (u0 + 1 < vend) v.y = y.y - shift;
        if (u0 + 2 < vend) v.z = y.z - shift;
        if (u0 + 3 < vend) v.w = y.w - shift;
      }
      __stcs(reinterpret_cast<float4*>(oa + u0), v);
    }
  }
}

// Dynamic shared memory of one prep_long CTA for tiles of TT frames: the
// tile plus the alignment slack of both ends, in whole 16 bytes.
size_t long_smem(int TT) {
  return static_cast<size_t>(((static_cast<long long>(TT) + 12 + 3) / 4) * 16);
}

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

// Sets the shared memory prep_long needs for tiles of TT frames.
cudaError_t long_config(int TT) {
  cudaError_t err = cudaFuncSetAttribute(
      prep_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(long_smem(TT)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      prep_long, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

}  // namespace

// How many prep_long CTAs for tiles of TT frames the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs) in *ctas.
// Returns the CUDA error code, or 0.
extern "C" int prep_long_ctas(int TT, int device, int* ctas) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = long_config(TT);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prep_long, kThreads, long_smem(TT));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas = per_sm * sms;
  return 0;
}

// Launches prep_long on `stream` (a cudaStream_t of `device`) as a
// cooperative launch of `grid` CTAs, which the card runs all at once or
// refuses: the CTAs that wait on each other are all resident, so the queue
// cannot stall.  The plan (TT, NT, resident, grid) is kernels/prep.py's
// long_plan.  `partial` is scratch of B·C·NT doubles; `scratch` is 2B + 3
// zeroed 32-bit words: the ticket (two), one arrival counter a file, and
// the prefix of B + 1.  x and out must be 16-byte aligned.  Returns the
// first non-zero CUDA error code, or 0.
extern "C" int prep_long_launch(const float* x, const float* norm,
                                const int* lens, float* out, float* shift_t,
                                float* shift_s, double* partial,
                                void* scratch, int B, int C, int T, int nt,
                                int TT, int NT, int resident, int grid,
                                int device, void* stream) {
  if (grid < 1 || TT < 1 || NT < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(scratch)) %
              16 !=
          0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = long_config(TT);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = long_smem(TT);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto* ticket = static_cast<unsigned long long*>(scratch);
  auto* arrived = reinterpret_cast<unsigned*>(ticket + 1);
  auto* prefix = reinterpret_cast<int*>(arrived + B);
  err = cudaLaunchKernelEx(&cfg, prep_long, x, norm, lens, B, C, T, nt, TT,
                           NT, resident, out, shift_t, shift_s, partial,
                           ticket, prefix, arrived);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
