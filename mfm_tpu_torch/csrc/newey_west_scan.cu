// The expanding Newey-West recursion of
// mfm_tpu_torch/models/newey_west.py (newey_west_expanding_resume, the
// "scan" method) in one launch for Hopper (sm_90a): every date's K x K
// covariance and the carry out, from the carry in.
//
// Replaces no TPU kernel: the JAX package runs this recursion as a
// lax.scan that XLA compiles into one loop on the device.  The port's
// plain version is a Python loop of small tensor ops, about 51 launches
// a date, so the rebuild waited on the host's dispatch (the card ~90%
// idle over 1,390-2,500 dates); this kernel walks the dates on the card.
//
// What bounds it on this card: the serial chain of dates.  Each date's
// state is an EWMA step of the previous one, so the T dates run one after
// another; the work is a few dozen flops an entry a date (~0.1 GFLOP at
// T = 2500, K = 42) and the bytes are the T K^2 covariances written once
// (17.6 MB, ~5 us at 3.35 TB/s).  The least time is the chain's latency,
// tens of microseconds.
//
// Design.  One thread per ordered entry (i, j) of the K x K state, no
// shared memory and no barrier.  A thread keeps in registers A_ij and,
// for each lag l, P^l_ij and P^l_ji (G^l + G^l' needs both), and its own
// copies of the vector and scalar recursions it reads: S, h^l, the S lags
// and the x lags at i and at j, Z and g^l.  A recursion recomputed in
// every thread gives the same bits everywhere, being the same operations
// on the same inputs.  The thread walks the dates from the carry's t,
// reading x_t[i] and x_t[j] (the next date's prefetched) and writing
// covs[t, i, j].  At a skipped date it writes the candidate V and keeps
// its state: it selects, never blends, so a NaN date cannot reach the
// sums.  Each thread writes its A_ij and P^l_ij out; the threads of row 0
// write the vector parts (index j) and thread (0, 0) the scalar ones.
//
// Rounding.  Every operation is the plain version's, in its order, each
// an explicitly rounded intrinsic (no FMA contraction); divisions by Z
// are true divisions.  lambda is the device scalar torch computed, read
// through its pointer.  The lag weights 1 - l/(1+q) are taken in double,
// as Python takes them, and rounded to the working type, as torch rounds
// a Python scalar; head * x is taken as a product, so NaN and -0
// propagate as in the loop.  So covs and every carry tensor are bitwise
// the plain version's on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 8;
constexpr int kThreads = 128;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float from_double(double c) { return __double2float_rn(c); }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double from_double(double c) { return c; }
};

// the carry's tensors, in nw_init_carry's order: S (K), A (K, K), Z (),
// then per lag P (K, K), h (K), g (), S lag (K), x lag (K)
template <typename P>
struct Carry {
  P S, A, Z;
  P Pl[kMaxQ], h[kMaxQ], g[kMaxQ], Slag[kMaxQ], xlag[kMaxQ];
};

template <typename P>
Carry<P> unpack(void* const* p, int q) {
  Carry<P> c{};
  c.S = static_cast<P>(p[0]);
  c.A = static_cast<P>(p[1]);
  c.Z = static_cast<P>(p[2]);
  for (int l = 0; l < q; ++l) {
    c.Pl[l] = static_cast<P>(p[3 + l]);
    c.h[l] = static_cast<P>(p[3 + q + l]);
    c.g[l] = static_cast<P>(p[3 + 2 * q + l]);
    c.Slag[l] = static_cast<P>(p[3 + 3 * q + l]);
    c.xlag[l] = static_cast<P>(p[3 + 4 * q + l]);
  }
  return c;
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads) newey_west_scan_kernel(
    const T* __restrict__ ret, long long rs0, long long rs1,
    const T* __restrict__ lam_p, const unsigned char* __restrict__ skip,
    long long n_dates, int K, int t0, Carry<const T*> in, Carry<T*> out,
    T* __restrict__ covs) {
  using O = Ops<T>;
  constexpr int QA = Q > 0 ? Q : 1;  // arrays of at least one element
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= K * K) return;
  const int i = e / K, j = e % K;
  const long long KK = static_cast<long long>(K) * K;
  const T lam = __ldg(lam_p);
  const T one = T(1), zero = T(0);

  // 1.0 - lag / (1.0 + q), in double as Python computes it
  T c[QA];
#pragma unroll
  for (int l = 0; l < Q; ++l)
    c[l] = O::from_double(__dsub_rn(1.0, __ddiv_rn(double(l + 1),
                                                  __dadd_rn(1.0, double(Q)))));

  T A = in.A[e], Z = *in.Z, Si = in.S[i], Sj = in.S[j];
  T Pij[QA], Pji[QA], hi[QA], hj[QA], g[QA], Sli[QA], Slj[QA], xli[QA], xlj[QA];
#pragma unroll
  for (int l = 0; l < Q; ++l) {
    Pij[l] = in.Pl[l][e];
    Pji[l] = in.Pl[l][j * K + i];
    hi[l] = in.h[l][i];
    hj[l] = in.h[l][j];
    g[l] = *in.g[l];
    Sli[l] = in.Slag[l][i];
    Slj[l] = in.Slag[l][j];
    xli[l] = in.xlag[l][i];
    xlj[l] = in.xlag[l][j];
  }

  int t = t0;
  T xi_next = zero, xj_next = zero;
  unsigned char skip_next = 0;
  if (n_dates > 0) {
    xi_next = __ldg(ret + i * rs1);
    xj_next = __ldg(ret + j * rs1);
    skip_next = skip ? __ldg(skip) : 0;
  }
  for (long long d = 0; d < n_dates; ++d) {
    const T xi = xi_next, xj = xj_next;
    const bool skipped = skip_next != 0;
    if (d + 1 < n_dates) {
      xi_next = __ldg(ret + (d + 1) * rs0 + i * rs1);
      xj_next = __ldg(ret + (d + 1) * rs0 + j * rs1);
      skip_next = skip ? __ldg(skip + d + 1) : 0;
    }
    const int t1 = t + 1;  // window length after including x_t

    const T Sni = O::add(O::mul(lam, Si), xi);
    const T Snj = O::add(O::mul(lam, Sj), xj);
    const T An = O::add(O::mul(lam, A), O::mul(xi, xj));
    const T Zn = O::add(O::mul(lam, Z), one);
    T Pnij[QA], Pnji[QA], hni[QA], hnj[QA], gn[QA];
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      const T head = t1 <= l + 1 ? one : zero;
      Pnij[l] = O::add(O::mul(lam, Pij[l]), O::mul(xli[l], xj));
      Pnji[l] = O::add(O::mul(lam, Pji[l]), O::mul(xlj[l], xi));
      hni[l] = O::add(O::mul(lam, hi[l]), O::mul(xi, head));
      hnj[l] = O::add(O::mul(lam, hj[l]), O::mul(xj, head));
      gn[l] = O::add(O::mul(lam, g[l]), head);
    }

    const T mui = O::div(Sni, Zn), muj = O::div(Snj, Zn);
    const T mumu = O::mul(mui, muj);
    T V = O::sub(O::div(An, Zn), mumu);
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      const T ai = O::sub(Sni, hni[l]), aj = O::sub(Snj, hnj[l]);
      const T zm = O::mul(O::sub(Zn, gn[l]), mumu);
      const T Gij = O::div(
          O::add(O::sub(O::sub(Pnij[l], O::mul(Sli[l], muj)), O::mul(mui, aj)), zm), Zn);
      const T Gji = O::div(
          O::add(O::sub(O::sub(Pnji[l], O::mul(Slj[l], mui)), O::mul(muj, ai)), zm), Zn);
      V = O::add(V, O::mul(c[l], O::add(Gij, Gji)));
    }
    covs[d * KK + e] = V;

    if (!skipped) {
      t = t1;
      Si = Sni;
      Sj = Snj;
      A = An;
      Z = Zn;
#pragma unroll
      for (int l = 0; l < Q; ++l) {
        Pij[l] = Pnij[l];
        Pji[l] = Pnji[l];
        hi[l] = hni[l];
        hj[l] = hnj[l];
        g[l] = gn[l];
      }
      // the lags shift by one date: lag 1 takes this date's S and x
#pragma unroll
      for (int l = Q - 1; l > 0; --l) {
        Sli[l] = Sli[l - 1];
        Slj[l] = Slj[l - 1];
        xli[l] = xli[l - 1];
        xlj[l] = xlj[l - 1];
      }
      Sli[0] = Sni;
      Slj[0] = Snj;
      xli[0] = xi;
      xlj[0] = xj;
    }
  }

  out.A[e] = A;
#pragma unroll
  for (int l = 0; l < Q; ++l) out.Pl[l][e] = Pij[l];
  if (i == 0) {
    out.S[j] = Sj;
#pragma unroll
    for (int l = 0; l < Q; ++l) {
      out.h[l][j] = hj[l];
      out.Slag[l][j] = Slj[l];
      out.xlag[l][j] = xlj[l];
    }
    if (j == 0) {
      *out.Z = Z;
#pragma unroll
      for (int l = 0; l < Q; ++l) *out.g[l] = g[l];
    }
  }
}

template <typename T, int Q>
int launch(const void* ret, long long rs0, long long rs1, const void* lam,
           const void* skip, long long n_dates, int K, int t0,
           void* const* in, void* const* out, void* covs,
           cudaStream_t stream) {
  const int blocks = (K * K + kThreads - 1) / kThreads;
  newey_west_scan_kernel<T, Q><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(ret), rs0, rs1, static_cast<const T*>(lam),
      static_cast<const unsigned char*>(skip), n_dates, K, t0,
      unpack<const T*>(in, Q), unpack<T*>(out, Q), static_cast<T*>(covs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int q, const void* ret, long long rs0, long long rs1,
             const void* lam, const void* skip, long long n_dates, int K,
             int t0, void* const* in, void* const* out, void* covs,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 0: return launch<T, 0>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 1: return launch<T, 1>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 2: return launch<T, 2>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 3: return launch<T, 3>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 4: return launch<T, 4>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 5: return launch<T, 5>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 6: return launch<T, 6>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 7: return launch<T, 7>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    case 8: return launch<T, 8>(ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out, covs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ret: (T, K) with element strides (rs0, rs1); lam: one element on the
// device; skip: T bytes on the device, or null for no skipped date; in /
// out: the 3 + 5 q carry pointers in Carry's order; covs: (T, K, K).
// Returns the launch's CUDA error code (0 on success).
int mfm_newey_west_scan_f32(const void* ret, long long rs0, long long rs1,
                            const void* lam, const void* skip,
                            long long n_dates, int K, int q, int t0,
                            void* const* in, void* const* out, void* covs,
                            void* stream) {
  return dispatch<float>(q, ret, rs0, rs1, lam, skip, n_dates, K, t0, in, out,
                         covs, stream);
}

int mfm_newey_west_scan_f64(const void* ret, long long rs0, long long rs1,
                            const void* lam, const void* skip,
                            long long n_dates, int K, int q, int t0,
                            void* const* in, void* const* out, void* covs,
                            void* stream) {
  return dispatch<double>(q, ret, rs0, rs1, lam, skip, n_dates, K, t0, in,
                          out, covs, stream);
}

const char* mfm_newey_west_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
