// A files step's sliding template correlations for Hopper (sm_90a): the
// two kernels around the one inverse FFT of a trace group.
//
// Replaces no TPU kernel: the JAX package computes these traces as XLA ops
// in strugatzki_tpu/kernels/corr.py::correlation_trace_from_spectra (and
// ::correlation_trace_from_sums), which XLA fuses.  The port ran them as
// eager PyTorch ops (kernels/corr.py, the plain version): per template and
// files step, ~75 launches, the [B, C, N/2+1] template product written out
// before its channel sum, the template-free channel sums taken again for
// every template, and six inverse FFTs, each behind a copy of its input.
//
// A trace group is the templates traced over the same files in one step,
// at most two: a query's template, or a punch's punch-in and punch-out.  For B files
// with spectra X [B, C, F] (complex64, F = N/2 + 1 bins) and group power
// spectra Xsq [B, 2, F], kernels/corr.py::trace_plan lays out R complex
// rows a file:
//
//   for each distinct template length L (full spectra cache only), rows
//     sum_{c<nt} X_c * conj(1_L),  Xsq_0 * conj(1_L),
//     sum_{c>=nt} X_c * conj(1_L), Xsq_1 * conj(1_L)   [, X_0 * conj(1_L)]
//   (the last when nt != 1), 1_L the spectrum of a length-L ones kernel;
//   for each template, the dots sum_{c<nt} conj(ta_c) X_c and
//     sum_{c>=nt} conj(ta_c) X_c, each only where the blend weighs it.
//
// trace_spectra_kernel writes those rows.  One thread owns one bin of one
// file: it walks the C channels once, reading each X once, takes both
// channel sums and every template's two dots in registers, and writes each
// row once; the template spectra, read again for every file, stay in the
// L2.  (Holding a bin of 2, 4 or 8 files a thread, to read each template
// bin once for them all, was no faster at the serving steps: the registers
// it takes cost more occupancy than the L2 reads it saves.)
// torch.fft.irfft then transforms all B * R rows in one call, unscaled
// (norm="forward", so no pass of its own multiplies them by 1/N), and
// trace_epilogue_kernel reads each template's real rows' first W = Tp - L +
// 1 columns, scaling each by 1/N as it loads it (N is a power of two, so
// that product is exact, as the scaled transform's), or on the compact
// cache's path the window sums from a prefix table P [B, 4|5, Tp + 1]:
// P[L + t] - P[t].  It computes the window means and deviations of both
// groups, the blend, the boost and its gate in one pass, writing sims and
// boosts [B, W] float32.
//
// What bounds it on this card: HBM bytes.  The spectra kernel reads X and
// Xsq once and writes the rows once (a punch step of the serving
// deployment, 455 files at F = 8,193 and 12 rows: 835 MB, 0.25 ms at 3.35
// TB/s); the epilogue reads each template's rows once and writes its two
// traces once.
//
// Rounding.  The channel sums run in channel order, so the rows differ from
// the eager reductions' in the last bits.  The epilogue repeats the plain
// version's float32 operations one for one, in its order, each rounded
// (__fmul_rn and friends, so nothing contracts into an FMA); a division by
// a host scalar is a product with the float32 reciprocal that the wrapper
// passes, as the eager ops compute it on a card; logf, expf and sqrtf are
// the accurate ones (no --use_fast_math).  Fed the same real rows, it
// gives the plain version's bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTemplates = 2;  // kernels/corr.py::TRACE_MAX_TEMPLATES
constexpr int kBins = 128;        // bins of one file a CTA of the spectra kernel
constexpr int kEpiThreads = 256;  // window offsets a CTA of the epilogue
constexpr int kConsts = 12;       // float32 scalars a template

struct RowsArgs {
  const float2* ones[kMaxTemplates];   // 1_L spectra, one a block
  const float2* tspec[kMaxTemplates];  // conj(ta) [C, F], one a template
  int dot_t[kMaxTemplates];            // rows of the dots, or -1
  int dot_s[kMaxTemplates];
  int n_ones;                          // window-sum blocks
  int n_sum;                           // rows a block: 4, or 5
};

struct EpiTemplate {
  float* sims;
  float* boosts;
  int L, W, base, dot_t, dot_s;
  // 1/n_t, 1/n_s, 1/L, n_t, n_s, a_std_t, a_std_s, w, 1 - w, ln_avg,
  // max_boost, 1/0.6: float32, as kernels/corr.py::_trace_finish rounds them
  float inv_nt, inv_ns, inv_L, n_t, n_s, a_std_t, a_std_s, w_t, w_s, ln_avg,
      max_boost, inv_06;
};

struct EpiArgs {
  EpiTemplate t[kMaxTemplates];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

template <int G>
__global__ void __launch_bounds__(kBins)
    trace_spectra_kernel(const float2* __restrict__ X,
                         const float2* __restrict__ Xsq,
                         float2* __restrict__ rows, RowsArgs a, int C, int F,
                         int nt, int R) {
  const int k = blockIdx.x * kBins + threadIdx.x;
  if (k >= F) return;
  const int b = blockIdx.y;
  const float2* x = X + static_cast<size_t>(b) * C * F + k;
  const float2 zero = make_float2(0.0f, 0.0f);

  float2 sum_t = zero, sum_s = zero, dot_t[G], dot_s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dot_t[g] = dot_s[g] = zero;
  for (int c = 0; c < nt; ++c) {
    const size_t at = static_cast<size_t>(c) * F;
    const float2 xc = x[at];
    sum_t = cadd(sum_t, xc);
#pragma unroll
    for (int g = 0; g < G; ++g)
      dot_t[g] = cadd(dot_t[g], cmul(a.tspec[g][at + k], xc));
  }
  for (int c = nt; c < C; ++c) {
    const size_t at = static_cast<size_t>(c) * F;
    const float2 xc = x[at];
    sum_s = cadd(sum_s, xc);
#pragma unroll
    for (int g = 0; g < G; ++g)
      dot_s[g] = cadd(dot_s[g], cmul(a.tspec[g][at + k], xc));
  }

  float2* out = rows + static_cast<size_t>(b) * R * F + k;
  if (a.n_ones > 0) {
    const float2* q = Xsq + static_cast<size_t>(b) * 2 * F + k;
    const float2 q0 = q[0];
    const float2 q1 = q[F];
#pragma unroll
    for (int l = 0; l < kMaxTemplates; ++l) {
      if (l >= a.n_ones) break;
      float2 o = a.ones[l][k];
      o.y = -o.y;  // conj(1_L)
      float2* w = out + static_cast<size_t>(l) * a.n_sum * F;
      w[0] = cmul(sum_t, o);
      w[F] = cmul(q0, o);
      w[2 * static_cast<size_t>(F)] = cmul(sum_s, o);
      w[3 * static_cast<size_t>(F)] = cmul(q1, o);
      if (a.n_sum == 5) w[4 * static_cast<size_t>(F)] = cmul(x[0], o);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (a.dot_t[g] >= 0) out[static_cast<size_t>(a.dot_t[g]) * F] = dot_t[g];
    if (a.dot_s[g] >= 0) out[static_cast<size_t>(a.dot_s[g]) * F] = dot_s[g];
  }
}

// torch.clamp_min(v, 0.0) on a card: NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// One CTA: kEpiThreads window offsets of one file (blockIdx.y) and one
// template (blockIdx.z).  Y [B, R, N] are the real rows, unscaled (inv_n =
// 1/N scales them); P, when not null, the window-sum table [B, Rs, Tp1].
__global__ void __launch_bounds__(kEpiThreads)
    trace_epilogue_kernel(const float* __restrict__ Y,
                          const float* __restrict__ P,
                          const float* __restrict__ shifts, EpiArgs args,
                          int R, int N, int Rs, int Tp1, int nt,
                          float inv_n) {
  // the template by static indices: a dynamic index into the parameters
  // would copy them to local memory
  EpiTemplate e = args.t[0];
#pragma unroll
  for (int g = 1; g < kMaxTemplates; ++g) {
    if (g == blockIdx.z) e = args.t[g];
  }
  const int t = blockIdx.x * kEpiThreads + threadIdx.x;
  if (t >= e.W) return;
  const int b = blockIdx.y;
  const float* y = Y + static_cast<size_t>(b) * R * N + t;

  float s_t, q_t, s_s, q_s, x0 = 0.0f;
  if (P != nullptr) {
    const float* p = P + static_cast<size_t>(b) * Rs * Tp1 + t;
    const size_t r = Tp1;
    s_t = __fsub_rn(p[e.L], p[0]);
    q_t = __fsub_rn(p[r + e.L], p[r]);
    s_s = __fsub_rn(p[2 * r + e.L], p[2 * r]);
    q_s = __fsub_rn(p[3 * r + e.L], p[3 * r]);
    if (nt != 1) x0 = __fsub_rn(p[4 * r + e.L], p[4 * r]);
  } else {
    const float* w = y + static_cast<size_t>(e.base) * N;
    const size_t r = N;
    s_t = __fmul_rn(w[0], inv_n);
    q_t = __fmul_rn(w[r], inv_n);
    s_s = __fmul_rn(w[2 * r], inv_n);
    q_s = __fmul_rn(w[3 * r], inv_n);
    if (nt != 1) x0 = __fmul_rn(w[4 * r], inv_n);
  }

  const float mu_t = __fmul_rn(s_t, e.inv_nt);
  const float std_t = sqrtf(
      clamp0(__fsub_rn(__fmul_rn(q_t, e.inv_nt), __fmul_rn(mu_t, mu_t))));
  const float mu_s = __fmul_rn(s_s, e.inv_ns);
  const float std_s = sqrtf(
      clamp0(__fsub_rn(__fmul_rn(q_s, e.inv_ns), __fmul_rn(mu_s, mu_s))));

  // a group the blend leaves out is never read (its dot is no row)
  float sim_t = 0.0f, sim_s = 0.0f;
  if (e.dot_t >= 0) {
    sim_t = __fdiv_rn(__fmul_rn(y[static_cast<size_t>(e.dot_t) * N], inv_n),
                      __fmul_rn(__fmul_rn(std_t, e.a_std_t), e.n_t));
  }
  if (e.dot_s >= 0) {
    sim_s = __fdiv_rn(__fmul_rn(y[static_cast<size_t>(e.dot_s) * N], inv_n),
                      __fmul_rn(__fmul_rn(std_s, e.a_std_s), e.n_s));
  }
  const float sim = __fadd_rn(__fmul_rn(sim_t, e.w_t), __fmul_rn(sim_s, e.w_s));

  // loudness boost: window mean of channel 0, shifted back
  const float mu0 = nt == 1 ? mu_t : __fmul_rn(x0, e.inv_L);
  const float loud = __fadd_rn(mu0, shifts[b]);
  const float boost =
      expf(__fmul_rn(__fsub_rn(e.ln_avg, logf(loud)), e.inv_06));
  const size_t o = static_cast<size_t>(b) * e.W + t;
  // `<=` is false for a NaN boost: such windows are gated to 0
  e.sims[o] = boost <= e.max_boost ? sim : 0.0f;
  e.boosts[o] = boost;
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

// Launches trace_spectra_kernel on `stream` (a cudaStream_t of `device`):
// X [B, C, F] and Xsq [B, 2, F] complex64 (Xsq unread when n_ones is 0),
// `ones` n_ones pointers to 1_L spectra [F], `tspec` G pointers to conj(ta)
// [C, F], `dots` 2G rows (temporal, spectral a template; -1 for none), rows
// [B, R, F] complex64.  Returns the first non-zero CUDA error code, or 0.
extern "C" int trace_spectra_launch(const void* X, const void* Xsq,
                                    const void* const* ones,
                                    const void* const* tspec, void* rows,
                                    const int* dots, int B, int C, int F,
                                    int nt, int R, int G, int n_ones,
                                    int n_sum, int device, void* stream) {
  if (B < 1 || C < 2 || F < 1 || nt < 1 || nt >= C || R < 1 || G < 1 ||
      G > kMaxTemplates || n_ones < 0 || n_ones > kMaxTemplates ||
      (n_sum != 4 && n_sum != 5) || (n_ones > 0 && Xsq == nullptr) ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowsArgs a{};
  for (int l = 0; l < n_ones; ++l) {
    a.ones[l] = static_cast<const float2*>(ones[l]);
  }
  for (int g = 0; g < G; ++g) {
    a.tspec[g] = static_cast<const float2*>(tspec[g]);
    a.dot_t[g] = dots[2 * g];
    a.dot_s[g] = dots[2 * g + 1];
    if (a.dot_t[g] >= R || a.dot_s[g] >= R) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.n_ones = n_ones;
  a.n_sum = n_sum;
  if (n_ones * n_sum > R) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kBins - 1) / kBins, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* x = static_cast<const float2*>(X);
  const float2* q = static_cast<const float2*>(Xsq);
  float2* out = static_cast<float2*>(rows);
  switch (G) {
    case 1:
      trace_spectra_kernel<1><<<grid, kBins, 0, st>>>(x, q, out, a, C, F, nt,
                                                      R);
      break;
    default:
      trace_spectra_kernel<2><<<grid, kBins, 0, st>>>(x, q, out, a, C, F, nt,
                                                      R);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches trace_epilogue_kernel on `stream`: Y [B, R, N] float32 (the
// unscaled irfft of the rows; N a power of two), P [B, Rs, Tp1] float32 or
// null (window sums from the rows), shifts [B] float32; `outs` 2G
// pointers (sims, boosts [B, W] of each template); `ints` 5 a template (L,
// W, base, dot_t, dot_s); `consts` kConsts a template (the order of
// EpiTemplate).  w_max is the largest W.
// Returns the first non-zero CUDA error code, or 0.
extern "C" int trace_epilogue_launch(const float* Y, const float* P,
                                     const float* shifts,
                                     void* const* outs, const int* ints,
                                     const float* consts, int B, int R, int N,
                                     int Rs, int Tp1, int nt, int G,
                                     int w_max, int device, void* stream) {
  if (B < 1 || B > 65535 || R < 1 || N < 1 || (N & (N - 1)) != 0 || G < 1 ||
      G > kMaxTemplates ||
      w_max < 1 || nt < 1 || (P != nullptr && Rs < (nt == 1 ? 4 : 5))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpiArgs args{};
  for (int g = 0; g < G; ++g) {
    EpiTemplate& e = args.t[g];
    e.sims = static_cast<float*>(outs[2 * g]);
    e.boosts = static_cast<float*>(outs[2 * g + 1]);
    const int* v = ints + 5 * g;
    e.L = v[0];
    e.W = v[1];
    e.base = v[2];
    e.dot_t = v[3];
    e.dot_s = v[4];
    if (e.W < 1 || e.W > w_max || e.dot_t >= R || e.dot_s >= R ||
        (P == nullptr && (e.base < 0 || e.base + (nt == 1 ? 4 : 5) > R ||
                          e.W > N)) ||
        (P != nullptr && e.L + e.W > Tp1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const float* c = consts + kConsts * g;
    e.inv_nt = c[0];
    e.inv_ns = c[1];
    e.inv_L = c[2];
    e.n_t = c[3];
    e.n_s = c[4];
    e.a_std_t = c[5];
    e.a_std_s = c[6];
    e.w_t = c[7];
    e.w_s = c[8];
    e.ln_avg = c[9];
    e.max_boost = c[10];
    e.inv_06 = c[11];
  }
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w_max + kEpiThreads - 1) / kEpiThreads, B, G);
  trace_epilogue_kernel<<<grid, kEpiThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Y, P, shifts, args, R, N, Rs, Tp1, nt, 1.0f / static_cast<float>(N));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
