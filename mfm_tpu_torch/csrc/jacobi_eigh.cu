// Batched Brent-Luk parallel cyclic Jacobi eigendecomposition of small
// symmetric matrices, one thread block per matrix, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of mfm_tpu/ops/eigh_pallas.py:
//   jacobi_eigh_kernel           <- jacobi_eigh_tpu, the pallas_call at :258
//                                   (eigenvalues + eigenvectors)
//   jacobi_eigh_weighted_kernel  <- jacobi_eigh_weighted_diag_tpu, the
//                                   pallas_call at :339 (eigenvalues +
//                                   h_i = sum_k V_ki^2 d0_k; V never leaves
//                                   shared memory)
//
// Same mathematics as the TPU kernels and as the plain PyTorch versions in
// mfm_tpu_torch/ops/eigh.py (jacobi_eigh_slots,
// jacobi_eigh_weighted_diag_slots): the Brent-Luk pairing schedule, a fixed
// sweeps*(n-1) rounds with no convergence exit, a pair skipped when
// |a_pq| <= 100*tiny of the dtype, the same angle formulas, and outputs in
// the matrix's ORIGINAL index order.  Every floating-point operation is an
// explicitly rounded intrinsic (no FMA contraction), in the same order as
// the plain version, so eigenvalues agree with it to the last bit on the
// same card; only the h reduction sums in another order.
//
// Design.  The TPU kernel keeps the matrix in a permuted basis and restacks
// it every round; here the matrix stays in its original index order in
// shared memory and each round rotates the index pairs the schedule names
// (one (n-1) x n byte table, the round-r basis, staged into shared memory
// once).  The rotation work is then plain in-place row and column updates:
//   1. h = n/2 threads compute the pair angles (c, s);
//   2. all threads rotate rows p, q of A and of the TRANSPOSED eigenvector
//      accumulator Vt (Vt[i][k] = V[k][i]);
//   3. all threads rotate columns p, q of A.
// Row stride n+1 keeps the column pass's strided accesses on distinct
// banks.  For the eigen Monte-Carlo's shape (139,000 matrices, n=42, f32,
// 4 sweeps) that is 2*42*43*4 B of matrices plus the 1.7 KB table a block.
//
// What bounds it on this card: arithmetic is ~9 n^2 flops a round (5.4 ms
// of FP32 at the eigen MC's shape) and device memory traffic is one read of
// A and a write of w, h (0.3 ms), so the roofline bound is operations.  This
// simple design is instead paced by shared-memory traffic and the three
// block barriers per round (about 15x the bound at that shape on an H100,
// PERF.md).  float32 at the n of jacobi_eigh_warp.cu goes to that file's
// design instead (one warp per matrix, the matrix in registers); this one
// carries float64 and the other n, and is the warp design's yardstick in
// chip_smoke.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

// Shared-memory carve-up of one block; see smem_bytes below.
template <typename T>
struct Block {
  T* a;                 // n x ld, the matrix being diagonalised
  T* vt;                // n x ld, transposed eigenvector accumulator
  T* cs;                // h, cosines of this round
  T* sn;                // h, sines of this round
  int* pp;              // h, first index of each pair
  int* qq;              // h, second index of each pair
  unsigned char* tab;   // (n-1) x n, the basis of each round
};

template <typename T>
__host__ __device__ size_t smem_bytes(int n) {
  const int ld = n + 1, h = n / 2;
  return (2 * size_t(n) * ld + 2 * h) * sizeof(T) + 2 * h * sizeof(int) +
         size_t(n - 1) * n;
}

template <typename T>
__device__ Block<T> carve(unsigned char* raw, int n) {
  const int ld = n + 1, h = n / 2;
  Block<T> s;
  s.a = reinterpret_cast<T*>(raw);
  s.vt = s.a + n * ld;
  s.cs = s.vt + n * ld;
  s.sn = s.cs + h;
  s.pp = reinterpret_cast<int*>(s.sn + h);
  s.qq = s.pp + h;
  s.tab = reinterpret_cast<unsigned char*>(s.qq + h);
  return s;
}

// Loads matrix A (row-major n x n) and the schedule, runs every round; on
// return s.a holds the rotated matrix (eigenvalues on its diagonal) and
// s.vt the eigenvectors as rows, both in original index order.
template <typename T>
__device__ void decompose(const Block<T>& s, const T* __restrict__ A,
                          const unsigned char* __restrict__ tab, int n,
                          int sweeps, T tiny) {
  using R = Rn<T>;
  const int ld = n + 1, h = n / 2;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int idx = tid; idx < n * n; idx += nt) {
    const int r = idx / n, c = idx - r * n;
    s.a[r * ld + c] = A[idx];
    s.vt[r * ld + c] = r == c ? T(1) : T(0);
  }
  for (int idx = tid; idx < (n - 1) * n; idx += nt) s.tab[idx] = tab[idx];
  __syncthreads();

  const int rounds = sweeps * (n - 1);
  for (int rnd = 0, slot = 0; rnd < rounds; ++rnd) {
    if (tid < h) {
      const unsigned char* basis = s.tab + slot * n;
      const int p = basis[2 * tid], q = basis[2 * tid + 1];
      const T app = s.a[p * ld + p], aqq = s.a[q * ld + q];
      const T apq = s.a[p * ld + q];
      const bool small = R::abs(apq) <= tiny;
      const T tau = R::div(R::sub(aqq, app), small ? T(1) : R::mul(T(2), apq));
      const T sgn = tau > T(0) ? T(1) : (tau < T(0) ? T(-1) : tau);
      T t = R::div(sgn, R::add(R::abs(tau),
                               R::sqrt(R::add(T(1), R::mul(tau, tau)))));
      if (tau == T(0)) t = T(1);  // 45-degree rotation when a_pp == a_qq
      if (small) t = T(0);
      const T c = R::div(T(1), R::sqrt(R::add(T(1), R::mul(t, t))));
      s.cs[tid] = c;
      s.sn[tid] = R::mul(t, c);
      s.pp[tid] = p;
      s.qq[tid] = q;
    }
    __syncthreads();

    // rows: A <- J' A and Vt <- J' Vt
    for (int idx = tid; idx < h * n; idx += nt) {
      const int i = idx / n, j = idx - i * n;
      const int p = s.pp[i], q = s.qq[i];
      const T c = s.cs[i], sn = s.sn[i];
      T x = s.a[p * ld + j], y = s.a[q * ld + j];
      s.a[p * ld + j] = R::sub(R::mul(c, x), R::mul(sn, y));
      s.a[q * ld + j] = R::add(R::mul(sn, x), R::mul(c, y));
      x = s.vt[p * ld + j];
      y = s.vt[q * ld + j];
      s.vt[p * ld + j] = R::sub(R::mul(c, x), R::mul(sn, y));
      s.vt[q * ld + j] = R::add(R::mul(sn, x), R::mul(c, y));
    }
    __syncthreads();

    // columns: A <- A J
    for (int idx = tid; idx < h * n; idx += nt) {
      const int i = idx / n, j = idx - i * n;
      const int p = s.pp[i], q = s.qq[i];
      const T c = s.cs[i], sn = s.sn[i];
      const T x = s.a[j * ld + p], y = s.a[j * ld + q];
      s.a[j * ld + p] = R::sub(R::mul(c, x), R::mul(sn, y));
      s.a[j * ld + q] = R::add(R::mul(sn, x), R::mul(c, y));
    }
    __syncthreads();
    if (++slot == n - 1) slot = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_eigh_kernel(const T* __restrict__ A, T* __restrict__ w,
                   T* __restrict__ V, const unsigned char* __restrict__ tab,
                   int n, int sweeps, T tiny) {
  extern __shared__ __align__(16) unsigned char raw[];
  const Block<T> s = carve<T>(raw, n);
  const size_t b = blockIdx.x;
  decompose(s, A + b * n * n, tab, n, sweeps, tiny);
  const int ld = n + 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) w[b * n + i] = s.a[i * ld + i];
  T* Vb = V + b * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int k = idx / n, i = idx - k * n;
    Vb[idx] = s.vt[i * ld + k];  // V[k][i] = Vt[i][k]
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_eigh_weighted_kernel(const T* __restrict__ A, const T* __restrict__ d0,
                            T* __restrict__ w, T* __restrict__ hout,
                            const unsigned char* __restrict__ tab, int n,
                            int sweeps, T tiny) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char raw[];
  const Block<T> s = carve<T>(raw, n);
  const size_t b = blockIdx.x;
  decompose(s, A + b * n * n, tab, n, sweeps, tiny);
  const int ld = n + 1;
  const T* d = d0 + b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T acc = T(0);
    for (int k = 0; k < n; ++k) {
      const T v = s.vt[i * ld + k];
      acc = R::add(acc, R::mul(R::mul(v, v), d[k]));
    }
    w[b * n + i] = s.a[i * ld + i];
    hout[b * n + i] = acc;
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T>
int launch_eigh(const void* A, void* w, void* V, const void* tab, long long B,
                int n, int sweeps, double tiny, void* stream) {
  const size_t smem = smem_bytes<T>(n);
  int rc = prepare(jacobi_eigh_kernel<T>, smem);
  if (rc) return rc;
  jacobi_eigh_kernel<T><<<unsigned(B), kThreads, smem, cudaStream_t(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V),
      static_cast<const unsigned char*>(tab), n, sweeps, T(tiny));
  return int(cudaGetLastError());
}

template <typename T>
int launch_weighted(const void* A, const void* d0, void* w, void* h,
                    const void* tab, long long B, int n, int sweeps,
                    double tiny, void* stream) {
  const size_t smem = smem_bytes<T>(n);
  int rc = prepare(jacobi_eigh_weighted_kernel<T>, smem);
  if (rc) return rc;
  jacobi_eigh_weighted_kernel<T>
      <<<unsigned(B), kThreads, smem, cudaStream_t(stream)>>>(
          static_cast<const T*>(A), static_cast<const T*>(d0),
          static_cast<T*>(w), static_cast<T*>(h),
          static_cast<const unsigned char*>(tab), n, sweeps, T(tiny));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each returns the CUDA error code of the
// launch (0 on success); the caller checks shapes, dtypes and B >= 1.
extern "C" {

size_t mfm_jacobi_smem_bytes(int n, int itemsize) {
  return itemsize == 8 ? smem_bytes<double>(n) : smem_bytes<float>(n);
}

const char* mfm_cuda_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

int mfm_jacobi_eigh_f32(const void* A, void* w, void* V, const void* tab,
                        long long B, int n, int sweeps, double tiny,
                        void* stream) {
  return launch_eigh<float>(A, w, V, tab, B, n, sweeps, tiny, stream);
}

int mfm_jacobi_eigh_f64(const void* A, void* w, void* V, const void* tab,
                        long long B, int n, int sweeps, double tiny,
                        void* stream) {
  return launch_eigh<double>(A, w, V, tab, B, n, sweeps, tiny, stream);
}

int mfm_jacobi_eigh_weighted_f32(const void* A, const void* d0, void* w,
                                 void* h, const void* tab, long long B, int n,
                                 int sweeps, double tiny, void* stream) {
  return launch_weighted<float>(A, d0, w, h, tab, B, n, sweeps, tiny, stream);
}

int mfm_jacobi_eigh_weighted_f64(const void* A, const void* d0, void* w,
                                 void* h, const void* tab, long long B, int n,
                                 int sweeps, double tiny, void* stream) {
  return launch_weighted<double>(A, d0, w, h, tab, B, n, sweeps, tiny, stream);
}

}  // extern "C"
