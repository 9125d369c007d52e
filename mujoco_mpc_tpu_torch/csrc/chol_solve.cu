// Batched small SPD solve x[i] = a[i]^-1 b[i] on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_mpc_tpu/ops/pallas_linalg.py
// _chol_solve_kernel (called through solve_spd_batched, :32-103): an
// unrolled Cholesky-Crout factor with the diagonal floored at 1e-30, then
// forward and back substitution.
//
// What bounds it on the card: nothing but launch overhead on the planner's
// paths. There a = (B, n, n) and b = (B, n) float32 with n = nv of the
// model: Cartpole n 2, B 8192, ~260 KB moved and ~20 flops per system;
// Quadruped n 18 (its own bucket), B 4096, ~5.6 MB moved and ~1.6 kflop
// per system, far below any roofline. Measured there on an NVIDIA H100 80GB
// HBM3 (700 W power limit): 1.4 us of device time per call, against ~30 us
// of host time for the wrapper and the launch. At n near 32 the factor no
// longer fits in registers and spills to local memory (n = 32: 9 KB stack
// per thread), and the flops (~n^3/6 per system) start to count.
//
// Design: one thread per system, the factor held in a (N, N) array that is
// fully unrolled for a compile-time bucket N >= n, so for small n it lives
// in registers. Dimensions n..N-1 are padded as an identity block, which
// leaves the first n components bit-identical to an exact-n factorization
// (the padding only ever adds exact zeros). Each thread reads its own
// (n, n) row-major block, so at n > 2 a warp's loads are strided, i.e.
// uncoalesced; the TPU kernel's transposed (n, n, B) layout, batch
// innermost, is the known fix and is left for a later change. No shared
// memory, no synchronisation, no allocation; the launch goes on the
// caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int N>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ x, int batch, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= batch) return;
  const float* as = a + static_cast<size_t>(s) * n * n;
  const float* bs = b + static_cast<size_t>(s) * n;

  float l[N][N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      l[r][c] = r < n ? as[r * n + c] : (r == c ? 1.f : 0.f);
    }
  }

  // Cholesky-Crout, column by column, in place on the lower triangle
  float inv_diag[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float sjj = l[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) sjj -= l[j][k] * l[j][k];
    const float ljj = sqrtf(fmaxf(sjj, 1e-30f));
    l[j][j] = ljj;
    const float inv = 1.f / ljj;
    inv_diag[j] = inv;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float sij = l[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) sij -= l[i][k] * l[j][k];
      l[i][j] = sij * inv;
    }
  }

  // L y = b, then L^T x = y (x overwrites y)
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float si = i < n ? bs[i] : 0.f;
#pragma unroll
    for (int k = 0; k < i; ++k) si -= l[i][k] * y[k];
    y[i] = si * inv_diag[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float si = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) si -= l[k][i] * y[k];
    y[i] = si * inv_diag[i];
  }

  float* xs = x + static_cast<size_t>(s) * n;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) xs[i] = y[i];
  }
}

template <int N>
void launch(const float* a, const float* b, float* x, int batch, int n,
            cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  chol_solve_kernel<N><<<blocks, kThreads, 0, stream>>>(a, b, x, batch, n);
}

}  // namespace

// a (batch, n, n), b (batch, n), x (batch, n): contiguous float32 on the
// device, 1 <= n <= 32. Returns cudaGetLastError() after the launch.
extern "C" int mjpc_chol_solve_f32(const float* a, const float* b, float* x,
                                   int batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 1) launch<1>(a, b, x, batch, n, st);
  else if (n <= 2) launch<2>(a, b, x, batch, n, st);
  else if (n <= 3) launch<3>(a, b, x, batch, n, st);
  else if (n <= 4) launch<4>(a, b, x, batch, n, st);
  else if (n <= 6) launch<6>(a, b, x, batch, n, st);
  else if (n <= 8) launch<8>(a, b, x, batch, n, st);
  else if (n <= 12) launch<12>(a, b, x, batch, n, st);
  else if (n <= 18) launch<18>(a, b, x, batch, n, st);
  else if (n <= 24) launch<24>(a, b, x, batch, n, st);
  else launch<32>(a, b, x, batch, n, st);
  return static_cast<int>(cudaGetLastError());
}
