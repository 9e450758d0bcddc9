// Batched Brent-Luk parallel cyclic Jacobi eigendecomposition of small
// float32 symmetric matrices for Hopper (sm_90a): one warp per matrix, the
// matrix and its eigenvectors held in registers.
//
// Replaces, for float32 and the even n this file instantiates, the two
// Pallas TPU kernels of mfm_tpu/ops/eigh_pallas.py:
//   warp_eigh_kernel      <- jacobi_eigh_tpu, the pallas_call at :258
//                            (eigenvalues + eigenvectors)
//   warp_weighted_kernel  <- jacobi_eigh_weighted_diag_tpu, the pallas_call
//                            at :339 (eigenvalues + h_i = sum_k V_ki^2 d0_k;
//                            V never leaves the registers)
// float64 and every other n stay with the one-block-per-matrix kernels of
// jacobi_eigh.cu; mfm_tpu_torch/ops/eigh_cuda.py routes by (n, dtype).
//
// Same arithmetic as the plain PyTorch versions (mfm_tpu_torch/ops/eigh.py,
// jacobi_eigh_slots): the matrix X lives in the interleaved basis, round
// after round (1) each pair (2a, 2a+1) takes its angle from its 2x2
// diagonal block, (2) rows 2a, 2a+1 rotate with pair a's angle, (3)
// columns 2b, 2b+1 of X and of V rotate with pair b's angle, (4) the fixed
// basis change pi renumbers rows and columns.  Every operation is an
// explicitly rounded intrinsic (no FMA contraction) in the plain version's
// order, so w and V are bitwise equal to it; h sums over k in order, as
// jacobi_eigh.cu does.
//
// Layout.  Lane a (a < h = n/2) holds rows 2a and 2a+1 of X across all n
// columns, and rows 2a and 2a+1 (original coordinates) of V across all n
// slot columns: 4n floats in registers.  Steps (1)-(3) are then lane-local;
// the h angles reach every lane through a 2h-float array in the warp's
// shared memory.  The basis change is a shift: a lane's new top row is its
// left neighbour's top (lane 1: lane 0's bottom; lane 0 keeps its own) and
// its new bottom row its right neighbour's bottom (lane h-1: its own top),
// two warp shuffles a column; columns reorder inside each lane by the same
// pi, with static register indices.  V needs no traffic between lanes.
//
// What bounds it on this card: arithmetic, 9 n^2 flops a matrix a round
// (5.4 ms of FP32 at the eigen Monte-Carlo's 139,000 matrices, n=42, 4
// sweeps); device memory is one read of A.  The bitwise contract forbids
// FMA contraction, which halves the usable FP32 rate, and only h of 32
// lanes work, so the design's ceiling is 2 * 32/h times the bound.  The
// shuffles, the selects of the basis change and the angles' correctly
// rounded divides and square roots come on top (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // matrices, one a warp, per block
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// slot j of the interleaved basis holds original index b0(n, j)
__host__ __device__ constexpr int b0(int n, int j) {
  return (j & 1) ? n - 1 - j / 2 : j / 2;
}

// the basis change between rounds: new slot j takes old slot pi(n, j)
__host__ __device__ constexpr int pi(int n, int j) {
  return n == 2 ? j
       : j == 0 ? 0
       : j == 2 ? 1
       : j == n - 1 ? n - 2
       : (j & 1) ? j + 2 : j - 2;
}

// shared memory of one warp: the n x n staging buffer, then 32 (c, s) pairs
template <int N>
__host__ __device__ constexpr int warp_floats() { return N * N + 64; }

// x[2 * lane + off] with static register indices: a select tree over the
// bits of lane (lanes >= h get some element)
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int off, int lane) {
  constexpr int H = N / 2;
  float v[H];
#pragma unroll
  for (int b = 0; b < H; ++b) v[b] = x[2 * b + off];
#pragma unroll
  for (int bit = 1; bit < H; bit <<= 1) {
#pragma unroll
    for (int b = 0; b + bit < H; b += 2 * bit) v[b] = (lane & bit) ? v[b + bit] : v[b];
  }
  return v[0];
}

// the rotation of one pair, as ops/eigh.py and jacobi_eigh.cu compute it
__device__ __forceinline__ float2 angle(float app, float aqq, float apq, float tiny) {
  const bool small = fabsf(apq) <= tiny;
  const float tau = __fdiv_rn(sub(aqq, app), small ? 1.f : mul(2.f, apq));
  const float sgn = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : tau);
  float t = __fdiv_rn(sgn, add(fabsf(tau), __fsqrt_rn(add(1.f, mul(tau, tau)))));
  if (tau == 0.f) t = 1.f;  // 45-degree rotation when a_pp == a_qq
  if (small) t = 0.f;
  const float c = __fdiv_rn(1.f, __fsqrt_rn(add(1.f, mul(t, t))));
  return make_float2(c, mul(t, c));
}

// Loads matrix a (row-major n x n) into the lane's pair-rows of X, sets V
// to the interleaved basis and runs every round.  On return lane a holds
// rows 2a, 2a+1 of the rotated X (eigenvalues on the diagonal) and rows
// 2a, 2a+1 of V, whose slot j holds original index b0(n, j).
template <int N>
__device__ __forceinline__ void decompose(const float* __restrict__ a,
                                          float* buf, float2* cs, int lane,
                                          int rounds, float tiny,
                                          float (&top)[N], float (&bot)[N],
                                          float (&v0)[N], float (&v1)[N]) {
  constexpr int H = N / 2;
  for (int i = lane; i < N * N; i += 32) buf[i] = a[i];
  __syncwarp();
  const int r = lane < H ? lane : 0;  // X rows 2r, 2r+1 are A rows r, n-1-r
#pragma unroll
  for (int j = 0; j < N; ++j) {
    top[j] = buf[r * N + b0(N, j)];
    bot[j] = buf[(N - 1 - r) * N + b0(N, j)];
    v0[j] = 2 * r == b0(N, j) ? 1.f : 0.f;
    v1[j] = 2 * r + 1 == b0(N, j) ? 1.f : 0.f;
  }

  for (int rnd = 0; rnd < rounds; ++rnd) {
    // (1) this lane's angle, from its diagonal block at columns 2a, 2a+1
    const float2 mine = angle(pick(top, 0, lane), pick(bot, 1, lane),
                              pick(top, 1, lane), tiny);
    __syncwarp();  // every lane has read the previous round's angles
    if (lane < H) cs[lane] = mine;
    __syncwarp();

    // (2) rows with the lane's own angle, (3) columns with pair b's
#pragma unroll
    for (int b = 0; b < H; ++b) {
      const float2 q = cs[b];
      const int p0 = 2 * b, p1 = 2 * b + 1;
      const float t0 = sub(mul(mine.x, top[p0]), mul(mine.y, bot[p0]));
      const float u0 = add(mul(mine.y, top[p0]), mul(mine.x, bot[p0]));
      const float t1 = sub(mul(mine.x, top[p1]), mul(mine.y, bot[p1]));
      const float u1 = add(mul(mine.y, top[p1]), mul(mine.x, bot[p1]));
      top[p0] = sub(mul(q.x, t0), mul(q.y, t1));
      top[p1] = add(mul(q.y, t0), mul(q.x, t1));
      bot[p0] = sub(mul(q.x, u0), mul(q.y, u1));
      bot[p1] = add(mul(q.y, u0), mul(q.x, u1));
      const float e0 = v0[p0], e1 = v0[p1], f0 = v1[p0], f1 = v1[p1];
      v0[p0] = sub(mul(q.x, e0), mul(q.y, e1));
      v0[p1] = add(mul(q.y, e0), mul(q.x, e1));
      v1[p0] = sub(mul(q.x, f0), mul(q.y, f1));
      v1[p1] = add(mul(q.y, f0), mul(q.x, f1));
    }

    // (4) the basis change: rows move between lanes, columns within them
    if constexpr (H > 1) {
      float nt[N], nb[N], n0[N], n1[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int k = pi(N, j);
        const float up = __shfl_up_sync(kAll, lane == 0 ? bot[k] : top[k], 1);
        const float dn = __shfl_down_sync(kAll, bot[k], 1);
        nt[j] = lane == 0 ? top[k] : up;
        nb[j] = lane == H - 1 ? top[k] : dn;
        n0[j] = v0[k];
        n1[j] = v1[k];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        top[j] = nt[j];
        bot[j] = nb[j];
        v0[j] = n0[j];
        v1[j] = n1[j];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
warp_eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                 float* __restrict__ V, long long B, int sweeps, float tiny) {
  constexpr int H = N / 2;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (m >= B) return;
  float* buf = smem + warp * warp_floats<N>();
  float2* cs = reinterpret_cast<float2*>(buf + N * N);
  float top[N], bot[N], v0[N], v1[N];
  decompose<N>(A + m * N * N, buf, cs, lane, sweeps * (N - 1), tiny,
               top, bot, v0, v1);

  // slots 2a, 2a+1 hold original indices a and n-1-a
  const float wt = pick(top, 0, lane), wb = pick(bot, 1, lane);
  __syncwarp();
  if (lane < H) {
    w[m * N + lane] = wt;
    w[m * N + N - 1 - lane] = wb;
#pragma unroll
    for (int j = 0; j < N; ++j) {  // V[k][b0(j)] = slot column j of row k
      buf[(2 * lane) * N + b0(N, j)] = v0[j];
      buf[(2 * lane + 1) * N + b0(N, j)] = v1[j];
    }
  }
  __syncwarp();
  float* Vm = V + m * N * N;
  for (int i = lane; i < N * N; i += 32) Vm[i] = buf[i];
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
warp_weighted_kernel(const float* __restrict__ A, const float* __restrict__ d0,
                     float* __restrict__ w, float* __restrict__ hout,
                     long long B, int sweeps, float tiny) {
  constexpr int H = N / 2;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (m >= B) return;
  float* buf = smem + warp * warp_floats<N>();
  float2* cs = reinterpret_cast<float2*>(buf + N * N);
  float top[N], bot[N], v0[N], v1[N];
  decompose<N>(A + m * N * N, buf, cs, lane, sweeps * (N - 1), tiny,
               top, bot, v0, v1);

  const float wt = pick(top, 0, lane), wb = pick(bot, 1, lane);
  __syncwarp();
  if (lane < H) {
    w[m * N + lane] = wt;
    w[m * N + N - 1 - lane] = wb;
    // term k of h at slot column j: V_kj^2 d0_k, for k = 2a and 2a+1
    const float d_0 = d0[m * N + 2 * lane], d_1 = d0[m * N + 2 * lane + 1];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      buf[(2 * lane) * N + j] = mul(mul(v0[j], v0[j]), d_0);
      buf[(2 * lane + 1) * N + j] = mul(mul(v1[j], v1[j]), d_1);
    }
  }
  __syncwarp();
  for (int j = lane; j < N; j += 32) {
    float acc = 0.f;
    for (int k = 0; k < N; ++k) acc = add(acc, buf[k * N + j]);
    hout[m * N + b0(N, j)] = acc;
  }
}

// dynamic shared memory of one block, within the 48 KB a launch may ask
// for without opting in
template <int N>
constexpr size_t block_smem() {
  static_assert(kWarps * warp_floats<N>() * sizeof(float) <= 48 * 1024);
  return kWarps * warp_floats<N>() * sizeof(float);
}

template <int N>
int launch_eigh(const void* A, void* w, void* V, long long B, int sweeps,
                float tiny, cudaStream_t stream) {
  const size_t smem = block_smem<N>();
  const unsigned blocks = unsigned((B + kWarps - 1) / kWarps);
  warp_eigh_kernel<N><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<float*>(w),
      static_cast<float*>(V), B, sweeps, tiny);
  return int(cudaGetLastError());
}

template <int N>
int launch_weighted(const void* A, const void* d0, void* w, void* h,
                    long long B, int sweeps, float tiny, cudaStream_t stream) {
  const size_t smem = block_smem<N>();
  const unsigned blocks = unsigned((B + kWarps - 1) / kWarps);
  warp_weighted_kernel<N><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(d0),
      static_cast<float*>(w), static_cast<float*>(h), B, sweeps, tiny);
  return int(cudaGetLastError());
}

// the largest n this file instantiates (every even n from 2 to it): the
// largest whose 4n floats of state fit a lane's registers with no spills
// (ptxas spills both kernels from n=48).  ops/eigh_cuda.py reads WARP_N
// from this line, and chip_smoke.py checks ptxas's report for spills.
constexpr int kMaxN = 46;

// runs the kernel instantiated at n; n must be even and at most kMaxN
template <int N = 2>
int dispatch_eigh(int n, const void* A, void* w, void* V, long long B,
                  int sweeps, float tiny, cudaStream_t s) {
  if (n == N) return launch_eigh<N>(A, w, V, B, sweeps, tiny, s);
  if constexpr (N + 2 <= kMaxN) {
    return dispatch_eigh<N + 2>(n, A, w, V, B, sweeps, tiny, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
}

template <int N = 2>
int dispatch_weighted(int n, const void* A, const void* d0, void* w, void* h,
                      long long B, int sweeps, float tiny, cudaStream_t s) {
  if (n == N) return launch_weighted<N>(A, d0, w, h, B, sweeps, tiny, s);
  if constexpr (N + 2 <= kMaxN) {
    return dispatch_weighted<N + 2>(n, A, d0, w, h, B, sweeps, tiny, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes.  Each returns the CUDA error code of the
// launch (0 on success), cudaErrorInvalidValue for an n this file does not
// instantiate; the caller checks shapes, dtypes and B >= 1.
extern "C" {

int mfm_jacobi_warp_eigh_f32(const void* A, void* w, void* V, long long B,
                             int n, int sweeps, double tiny, void* stream) {
  return dispatch_eigh(n, A, w, V, B, sweeps, float(tiny),
                       static_cast<cudaStream_t>(stream));
}

int mfm_jacobi_warp_weighted_f32(const void* A, const void* d0, void* w,
                                 void* h, long long B, int n, int sweeps,
                                 double tiny, void* stream) {
  return dispatch_weighted(n, A, d0, w, h, B, sweeps, float(tiny),
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
