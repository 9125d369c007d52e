// One SPD system a block: the Cholesky factor and the two triangular
// solves that both kernels run above n 32 (csrc/chol_solve.cu's wide
// instance and csrc/newton.cu's), and the block's deterministic sums.
//
// The factor is Cholesky-Crout with the diagonal floored at 1e-30, as
// the tile instances and the plain version (ops/linalg.py) compute it:
// L_jj = d rsqrt(d), d = max(pivot, 1e-30), L_ij = a_ij rsqrt(d). It runs
// right-looking in shared memory, column by column: after column j is
// scaled, warp w updates rows j + 1 + w, j + 1 + w + W, ... of the
// trailing lower triangle, lane l columns j + 1 + l, j + 33 + l, ... of a
// row, so each row's reads and writes are consecutive words. The solves
// run in warp 0 with the right-hand side in registers, one element of a
// lane per 32 rows, and the factor's entries read from shared memory.
// Every barrier is the block's and every thread reaches it.

#pragma once

namespace mjpc {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// v[k] summed over the block, the same bits on every thread; red holds
// K * (blockDim.x / 32) floats. Every thread must call it.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[k * nw + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[k * nw + w];
    v[k] = s;
  }
  __syncthreads();
}

// Factor the lower triangle of h (N x N, row stride S) in place; inv[j]
// ends as 1 / L_jj. Begins and ends with a barrier.
template <int N, int S>
__device__ void block_cholesky(float* h, float* inv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int j = 0; j < N; ++j) {
    __syncthreads();
    const float d = fmaxf(h[j * S + j], 1e-30f);
    const float iv = rsqrtf(d);          // 1 / L_jj, one hardware rsqrt
    for (int i = j + 1 + tid; i < N; i += nt) h[i * S + j] *= iv;
    __syncthreads();
    if (tid == 0) {
      h[j * S + j] = d * iv;
      inv[j] = iv;
    }
    for (int i = j + 1 + warp; i < N; i += nw) {
      const float lij = h[i * S + j];
      for (int k = j + 1 + lane; k <= i; k += 32) {
        h[i * S + k] -= lij * h[k * S + j];
      }
    }
  }
  __syncthreads();
}

// Warp 0 solves L L^T x = v in place (v: N floats in shared memory), L
// and inv from block_cholesky; the other warps return at once, so the
// caller puts a barrier after it.
template <int N, int S>
__device__ void warp_chol_solve(const float* h, const float* inv, float* v) {
  if (threadIdx.x >= 32) return;
  constexpr int R = (N + 31) / 32;
  const int lane = threadIdx.x;
  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    acc[q] = i < N ? v[i] : 0.f;
  }
  // L y = v: y_j = acc_j / L_jj, then acc_i -= L_ij y_j below it
#pragma unroll
  for (int jq = 0; jq < R; ++jq) {
    for (int jl = 0; jl < 32 && 32 * jq + jl < N; ++jl) {
      const int j = 32 * jq + jl;
      const float yj = __shfl_sync(kFull, acc[jq], jl) * inv[j];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        if (i == j) acc[q] = yj;
        else if (i > j && i < N) acc[q] -= h[i * S + j] * yj;
      }
    }
  }
  // L^T x = y: x_k = acc_k / L_kk, then acc_i -= L_ki x_k above it
#pragma unroll
  for (int kq = R - 1; kq >= 0; --kq) {
    for (int kl = 31; kl >= 0; --kl) {
      const int k = 32 * kq + kl;
      if (k >= N) continue;
      const float xk = __shfl_sync(kFull, acc[kq], kl) * inv[k];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        if (i == k) acc[q] = xk;
        else if (i < k) acc[q] -= h[k * S + i] * xk;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i < N) v[i] = acc[q];
  }
}

}  // namespace mjpc
