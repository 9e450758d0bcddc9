// The vol-regime recursion of mfm_tpu_torch/models/vol_regime.py
// (vol_regime_adjust_resume) in one launch for Hopper (sm_90a): every
// date's multiplier fvm2 = lambda^2 and lambda, and the (num, den) carry
// out, from the carry in.
//
// Replaces no TPU kernel: the JAX package runs this recursion as a
// fori_loop that XLA compiles into one loop on the device.  The port's
// plain version is a Python loop of scalar tensor ops, 8 launches a date,
// so the rebuild waited on the host's dispatch; this kernel walks the
// dates on the card.  The parallel parts around it (the diagonal, the
// finiteness test, B2 = mean(f^2 / var), the masks and the scaling of the
// covariances) stay torch's, whose reduction order decides their bits.
//
// What bounds it on this card: the serial chain of dates.  Each date's
// (num, den) is a multiply and an add of the previous one, so the T dates
// run one after another: two dependent operations, roughly 10 cycles a
// date, about 10-20 us at T = 2500.  The bytes are 3T values read and 2T
// written (~0.1 MB), a few tens of nanoseconds at 3.35 TB/s.
//
// Design.  One block of kThreads.  Warp 0's first thread walks the chain
// and nothing else; warps 1.. move the data, so the chain never waits on a
// global load or store.  The dates go in chunks of kChunk through a
// pipeline of two buffers in shared memory: in step s the movers load
// chunk s (okf, okf * B2z and the skip flags, coalesced), the chain walks
// chunk s - 1 and leaves (num, den) after each date in shared memory, and
// the movers turn chunk s - 2's sums into fvm2 and lambda and write them
// out coalesced; a barrier ends each step.  The chain reads its addends
// from shared memory kGroup dates ahead of itself into registers, so a
// shared load's latency is off the chain too.  At a skipped date the chain
// computes the candidate sums and keeps the old ones: it selects, never
// blends, so a NaN date cannot reach the sums, and the date's fvm2 is the
// frozen carry's ratio.
//
// Rounding.  Every operation is the plain version's, in its order, each an
// explicitly rounded intrinsic (no FMA contraction): num = lam * num +
// okf * B2z, den = lam * den + okf, fvm2 = den > 0 ? num / den : +0 (a true
// division), lambda = sqrt(fvm2) (correctly rounded, as torch.sqrt is).
// lambda is the device scalar torch computed, read through its pointer.
// So fvm2, lambda and the carry are bitwise the plain version's on the
// card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // warp 0 walks the chain, warps 1-7 move data
constexpr int kMovers = kThreads - 32;
constexpr int kChunk = 256;  // dates a pipeline step
constexpr int kGroup = 8;    // dates the chain reads ahead of itself
static_assert(kChunk % kGroup == 0, "a chunk holds whole groups");

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// kGroup dates' addends and flags, as the chain holds them in registers
template <typename T>
struct Group {
  T add[kGroup], ok[kGroup];
  bool skipped[kGroup];
};

// dates [k0, k0 + kGroup) of a chunk of len dates in shared memory; a date
// past len reads as skipped, so it moves nothing (its slots lie inside the
// buffers, which hold whole groups)
template <typename T>
__device__ __forceinline__ Group<T> load_group(
    const T* add, const T* ok, const unsigned char* skip, int k0, int len) {
  Group<T> grp;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    grp.add[g] = add[k0 + g];
    grp.ok[g] = ok[k0 + g];
    grp.skipped[g] = k0 + g >= len || skip[k0 + g] != 0;
  }
  return grp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vol_regime_scan_kernel(
    const T* __restrict__ b2z, const T* __restrict__ okf,
    const unsigned char* __restrict__ skip, const T* __restrict__ lam_p,
    const T* __restrict__ num_in, const T* __restrict__ den_in,
    long long n_dates, T* __restrict__ fvm2, T* __restrict__ lamb,
    T* __restrict__ num_out, T* __restrict__ den_out) {
  using O = Ops<T>;
  __shared__ T s_add[2][kChunk];  // okf * B2z: num's addend
  __shared__ T s_ok[2][kChunk];   // okf: den's addend
  __shared__ unsigned char s_skip[2][kChunk];
  __shared__ T s_num[2][kChunk];  // the sums after each date
  __shared__ T s_den[2][kChunk];

  const int tid = threadIdx.x;
  const T zero = T(0);
  const long long n_chunks = (n_dates + kChunk - 1) / kChunk;
  T num = zero, den = zero, lam = zero;
  if (tid == 0) {
    num = *num_in;
    den = *den_in;
    lam = __ldg(lam_p);
  }

  for (long long step = 0; step < n_chunks + 2; ++step) {
    if (tid >= 32) {
      const int m = tid - 32;
      if (step < n_chunks) {  // load chunk `step`, one ahead of the chain
        const long long base = step * kChunk;
        const int len = static_cast<int>(min(static_cast<long long>(kChunk),
                                             n_dates - base));
        const int b = static_cast<int>(step & 1);
        for (int k = m; k < len; k += kMovers) {
          const T o = __ldg(okf + base + k);
          s_add[b][k] = O::mul(o, __ldg(b2z + base + k));
          s_ok[b][k] = o;
          s_skip[b][k] = skip ? __ldg(skip + base + k) : 0;
        }
      }
      if (step >= 2) {  // write chunk `step - 2`, which the chain finished
        const long long c = step - 2;
        const long long base = c * kChunk;
        const int len = static_cast<int>(min(static_cast<long long>(kChunk),
                                             n_dates - base));
        const int b = static_cast<int>(c & 1);
        for (int k = m; k < len; k += kMovers) {
          const T dn = s_den[b][k];
          const T f = dn > zero ? O::div(s_num[b][k], dn) : zero;
          fvm2[base + k] = f;
          lamb[base + k] = O::sqrt(f);
        }
      }
    } else if (tid == 0 && step >= 1 && step <= n_chunks) {
      const long long c = step - 1;  // walk chunk `step - 1`
      const int len = static_cast<int>(min(static_cast<long long>(kChunk),
                                           n_dates - c * kChunk));
      const int b = static_cast<int>(c & 1);
      // a group's addends in registers, the next group's loads in flight
      Group<T> cur = load_group(s_add[b], s_ok[b], s_skip[b], 0, len), next;
      for (int k0 = 0; k0 < len; k0 += kGroup) {
        if (k0 + kGroup < len)
          next = load_group(s_add[b], s_ok[b], s_skip[b], k0 + kGroup, len);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const T nn = O::add(O::mul(lam, num), cur.add[g]);
          const T dd = O::add(O::mul(lam, den), cur.ok[g]);
          if (!cur.skipped[g]) {
            num = nn;
            den = dd;
          }
          s_num[b][k0 + g] = num;
          s_den[b][k0 + g] = den;
        }
        cur = next;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    *num_out = num;
    *den_out = den;
  }
}

template <typename T>
int launch(const void* b2z, const void* okf, const void* skip,
           const void* lam, const void* num_in, const void* den_in,
           long long n_dates, void* fvm2, void* lamb, void* num_out,
           void* den_out, void* stream) {
  vol_regime_scan_kernel<T><<<1, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(b2z), static_cast<const T*>(okf),
      static_cast<const unsigned char*>(skip), static_cast<const T*>(lam),
      static_cast<const T*>(num_in), static_cast<const T*>(den_in), n_dates,
      static_cast<T*>(fvm2), static_cast<T*>(lamb), static_cast<T*>(num_out),
      static_cast<T*>(den_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// b2z, okf: (T,) contiguous; skip: T bytes (a bool tensor) on the device,
// or null for no skipped date; lam, num_in, den_in: one element each on
// the device; fvm2, lamb: (T,); num_out, den_out: one element each.
// Returns the launch's CUDA error code (0 on success).
int mfm_vol_regime_scan_f32(const void* b2z, const void* okf,
                            const void* skip, const void* lam,
                            const void* num_in, const void* den_in,
                            long long n_dates, void* fvm2, void* lamb,
                            void* num_out, void* den_out, void* stream) {
  return launch<float>(b2z, okf, skip, lam, num_in, den_in, n_dates, fvm2,
                       lamb, num_out, den_out, stream);
}

int mfm_vol_regime_scan_f64(const void* b2z, const void* okf,
                            const void* skip, const void* lam,
                            const void* num_in, const void* den_in,
                            long long n_dates, void* fvm2, void* lamb,
                            void* num_out, void* den_out, void* stream) {
  return launch<double>(b2z, okf, skip, lam, num_in, den_in, n_dates, fvm2,
                        lamb, num_out, den_out, stream);
}

const char* mfm_vol_regime_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
