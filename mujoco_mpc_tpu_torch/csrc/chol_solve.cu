// Batched small SPD solve x[i] = a[i]^-1 b[i] on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_mpc_tpu/ops/pallas_linalg.py
// _chol_solve_kernel (called through solve_spd_batched, :32-103): an
// unrolled Cholesky-Crout factor with the diagonal floored at 1e-30, then
// forward and back substitution.
//
// What bounds it on the card: a = (B, n, n) and b = (B, n) float32 with
// n = nv of the model: Cartpole n 2, B 8192, and Quadruped n 18, B 4096.
// n^3 / 3 + 2 n^2 flops a system (2.6 kflop at n 18) are far below the
// card's float32 rate, so the bytes bound it: 3.4 MB at n 18 for a's lower
// triangle, b and x, 1.0 us at 3.35 TB/s. In practice two things add up:
// the copy of a into shared memory, and then the latency of each system's
// ~n dependent steps (one column of the factor after the other), which
// all systems run at once, so that nothing hides it.
//
// Design: a tile of L lanes solves one system, L the smallest power of two
// >= the bucket N but at most 8 (2 for n <= 2, 8 for n >= 5); lane t holds
// rows t, t + L, ... (R = ceil(N / L) of them), so a warp holds 32 / L
// systems and a block of 64 threads 64 / L. Each warp first copies the
// lower triangles of its systems, which are contiguous in a, as one flat
// range into its slice of shared memory, by asynchronous 4-byte copies
// that are all in flight at once and take no registers: lane k copies
// word k, k + 32, ... of the range (the reads coalesce; words above the
// diagonal are skipped) to row r, column c of its system's (N, N + 1)
// block (the odd row stride keeps the column reads of the backward solve
// free of bank conflicts). Each lane then holds its rows in registers,
// row t + q L up to column (q + 1) L - 1 (the lower triangle and a little
// more: 80 floats at N 32, not 128); the Cholesky factor runs column by
// column across the tile, each L_kj shuffled once from the lane that holds
// row k to the lanes that need it, with rsqrtf for 1 / L_jj, and so does
// the forward solve; the factor's rows go back to shared memory, where the
// backward solve reads L's columns. A tile of 8 lanes, not 32, for 18
// rows: each shuffle then serves four systems of the warp, and no lane is
// left without a row (a 32-lane tile idles 14). b is read (before the
// copy is waited for) and x written directly, one element a row: the
// tiles of a warp are consecutive systems, so those accesses coalesce as
// they are. Dimensions n..N-1 are padded with an identity block (b = 0),
// which leaves the first n components exactly as an exact-n factorization
// gives them.
// Every collective (shuffle, __syncwarp) takes the full warp and sits
// behind no condition, and every tile does the same fixed work: a tile
// past the end of the batch solves an identity system and writes nothing.
// Only the warp synchronises, never the block.
//
// Above n 32 (buckets 48, 64 and 96: Cube Solving's nv 87) a system takes
// a block of 128 threads (`chol_solve_wide_kernel`): its lower triangle
// is copied into static shared memory (96 x 97 floats, 37 KB) by reads
// that coalesce over the flat (n, n) block, then block_cholesky.cuh
// factors it column by column and warp 0 solves. JAX sends these sizes to
// its unrolled XLA path (pallas_linalg.py:129-135, MAX_UNROLL_N 24), a
// TPU limit: the computation is the same.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "block_cholesky.cuh"

namespace {

constexpr int kThreads = 64;

// lanes of the tile that solves one system: the smallest power of two
// >= N, at least 2 and at most 8; lane t holds rows t, t + L, ...
__host__ __device__ constexpr int lanes(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

// shared memory a block takes, in floats: kThreads / L systems of
// (N, N + 1)
__host__ __device__ constexpr int block_floats(int N) {
  return kThreads / lanes(N) * N * (N + 1);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ x, int batch, int n) {
  constexpr int L = lanes(N);
  constexpr int R = (N + L - 1) / L;     // rows a lane holds
  constexpr int S = N + 1;               // row stride in shared memory
  constexpr int kTiles = 32 / L;         // systems a warp
  static_assert(block_floats(N) * sizeof(float) <= 48 * 1024,
                "static shared memory is limited to 48 KB");
  __shared__ float smem[block_floats(N)];

  const int lane = threadIdx.x % 32;
  const int t = lane % L;
  const int warp = threadIdx.x / 32;
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads
                           / 32 + warp) * kTiles;   // the warp's 1st system
  const long long sys = first + lane / L;
  const bool valid = sys < batch;
  float* wsh = smem + warp * kTiles * N * S;
  float* tsh = wsh + (lane / L) * N * S;

  // b, one element a row, read before the copy waits
  float acc[R], inv[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = t + q * L;
    acc[q] = valid && i < n ? __ldg(b + sys * n + i) : 0.f;
    inv[q] = 1.f;
  }

  // copy the lower triangles of the warp's systems, all copies in flight
  // at once: word e of the flat range is system e / n^2, row (e % n^2) / n,
  // column e % n, and (s, r, c) advance by 32 words a step
  const int nn = n * n;
  const long long left = batch - first;
  const int words = static_cast<int>((left < kTiles ? left : kTiles) * nn);
  const float* src = a + first * nn;
  const int ds = 32 / nn, dr = 32 % nn / n, dc = 32 % n;
  int s = lane / nn, r = lane % nn / n, c = lane % n;
  for (int e = lane; e < words; e += 32) {
    if (c <= r) {
      __pipeline_memcpy_async(wsh + s * N * S + r * S + c, src + e, 4);
    }
    c += dc;
    r += dr;
    s += ds;
    if (c >= n) {
      c -= n;
      ++r;
    }
    if (r >= n) {
      r -= n;
      ++s;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  // h[q]: row t + q L of the matrix, its columns k < (q + 1) L (the lower
  // triangle and a little more); an identity row past n
  float h[R][R * L];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = t + q * L;
#pragma unroll
    for (int k = 0; k < N && k < (q + 1) * L; ++k) {
      h[q][k] = (valid && i < n && k <= i) ? tsh[i * S + k]
                                           : (k == i ? 1.f : 0.f);
    }
  }

  // Cholesky, column by column: h ends as the lane's rows of the factor
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = fmaxf(__shfl_sync(0xffffffffu, h[j / L][j], j % L, L),
                          1e-30f);
    const float inv_j = rsqrtf(d);       // 1 / L_jj, one hardware rsqrt
    float lj[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if ((q + 1) * L > j) {
        const int i = t + q * L;
        lj[q] = i == j ? d * inv_j : h[q][j] * inv_j;
        h[q][j] = lj[q];
        if (i == j) inv[q] = inv_j;
      }
    }
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      const float lkj = __shfl_sync(0xffffffffu, lj[k / L], k % L, L);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if ((q + 1) * L > k) h[q][k] -= lj[q] * lkj;
      }
    }
  }
  // L y = b, then L^T x = y (L's columns from shared memory)
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float yj = __shfl_sync(0xffffffffu, acc[j / L] * inv[j / L], j % L,
                                 L);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if ((q + 1) * L > j && t + q * L > j) acc[q] -= h[q][j] * yj;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = t + q * L;
    if (i < N) {
#pragma unroll
      for (int k = 0; k < N && k < (q + 1) * L; ++k) tsh[i * S + k] = h[q][k];
    }
    acc[q] *= inv[q];
  }
  __syncwarp();
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    const float xk = __shfl_sync(0xffffffffu, acc[k / L] * inv[k / L], k % L,
                                 L);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = t + q * L;
      if (q * L < k && i < k) acc[q] -= tsh[k * S + i] * xk;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = t + q * L;
    if (valid && i < n) x[sys * n + i] = acc[q] * inv[q];
  }
}

constexpr int kWideThreads = 128;

template <int N>
__global__ void __launch_bounds__(kWideThreads)
chol_solve_wide_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n) {
  constexpr int S = N + 1;
  __shared__ float h[N * S];
  __shared__ float v[N];
  __shared__ float inv[N];
  const long long sys = blockIdx.x;
  const float* as = a + sys * n * n;
  // the lower triangle, read in the flat order of a; identity past n
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e - r * n;
    if (c <= r) h[r * S + c] = __ldg(as + e);
  }
  for (int e = threadIdx.x; e < (N - n) * N; e += blockDim.x) {
    const int r = n + e / N, c = e % N;
    if (c <= r) h[r * S + c] = r == c ? 1.f : 0.f;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    v[i] = i < n ? __ldg(b + sys * n + i) : 0.f;
  }
  mjpc::block_cholesky<N, S>(h, inv);
  mjpc::warp_chol_solve<N, S>(h, inv, v);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[sys * n + i] = v[i];
}

template <int N>
void launch(const float* a, const float* b, float* x, int batch, int n,
            cudaStream_t stream) {
  if constexpr (N > 32) {
    chol_solve_wide_kernel<N><<<batch, kWideThreads, 0, stream>>>(a, b, x,
                                                                  n);
  } else {
    constexpr int kSystems = kThreads / lanes(N);
    const int blocks = (batch + kSystems - 1) / kSystems;
    chol_solve_kernel<N><<<blocks, kThreads, 0, stream>>>(a, b, x, batch,
                                                          n);
  }
}

}  // namespace

// a (batch, n, n), b (batch, n), x (batch, n): contiguous float32 on the
// device, 1 <= n <= 96. The factor uses a's lower triangle only. Returns
// cudaGetLastError() after the launch.
extern "C" int mjpc_chol_solve_f32(const float* a, const float* b, float* x,
                                   int batch, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  if (n < 1 || n > 96) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 1) launch<1>(a, b, x, batch, n, st);
  else if (n <= 2) launch<2>(a, b, x, batch, n, st);
  else if (n <= 3) launch<3>(a, b, x, batch, n, st);
  else if (n <= 4) launch<4>(a, b, x, batch, n, st);
  else if (n <= 6) launch<6>(a, b, x, batch, n, st);
  else if (n <= 8) launch<8>(a, b, x, batch, n, st);
  else if (n <= 12) launch<12>(a, b, x, batch, n, st);
  else if (n <= 18) launch<18>(a, b, x, batch, n, st);
  else if (n <= 24) launch<24>(a, b, x, batch, n, st);
  else if (n <= 32) launch<32>(a, b, x, batch, n, st);
  else if (n <= 48) launch<48>(a, b, x, batch, n, st);
  else if (n <= 64) launch<64>(a, b, x, batch, n, st);
  else launch<96>(a, b, x, batch, n, st);
  return static_cast<int>(cudaGetLastError());
}
