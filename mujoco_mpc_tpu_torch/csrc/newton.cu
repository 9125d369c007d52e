// Whole primal-Newton constraint solve per sample, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_mpc_tpu/ops/pallas_newton.py
// _newton_kernel (called through newton_batched, :222-549 and :627-775),
// for its dense + one-hot-scalar operand set. Per iteration: active set
// (jar < 0, or an equality row), gradient M (qacc - qs) + J^T W jar,
// Hessian M + 1e-10 I + J^T W J solved by Cholesky (diagonal floored at
// 1e-30), exact line search over alpha in {0, 1, 0.5, 0.25, 0.0625},
// jar <- jar - alpha J step. A sample stops after two consecutive full
// steps with an unchanged active set, or once |step| <= tol (1 + |qacc|),
// or at `cap` iterations.
//
// What bounds it on the card: on the planner's path (Cartpole: nv = 2,
// n = 0 dense rows, ns = 2 limit rows, cap 8, B = 8192) each sample does a
// few hundred flops and moves ~80 bytes, so the kernel is bound by its
// launch and by the longest-running sample of each warp (samples exit at
// different iterations and a warp runs until its last one is done).
// Measured there on an NVIDIA H100 80GB HBM3 (700 W power limit): 3.9 us
// of device time per call, against ~50 us of host time for the wrapper
// and the launch. From nv = 8 up the per-sample matrices start to spill
// from registers to local memory (16 B of stack per thread at nv = 8,
// 15 KB at nv = 32), and the dense rows are re-read from global memory in each of the three
// passes per iteration.
//
// Design: one thread per sample runs the whole loop to its own exit, so a
// finished sample is frozen for free (the TPU kernel masks every lane
// until the whole tile is done). qm, the Hessian, its factor, gradient and
// step live in (NV, NV) / (NV,) arrays, fully unrolled for a compile-time
// bucket NV >= nv; dimensions nv..NV-1 are padded with an identity block,
// which leaves the first nv components exactly as an exact-nv solve would
// compute them. The row jars are carried in the jar_d / jar_s outputs
// themselves, so the kernel needs no scratch and allocates nothing. Dense
// rows are streamed from global memory; J rows, like qm, are read
// row-major per sample, which is uncoalesced (the TPU's batch-innermost
// layout is the later fix). The one-hot rows' dof and sign are small
// arrays shared by every sample. No shared memory, no synchronisation; the
// launch goes on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr float kDamp = 1e-10f;
__constant__ float kAlphas[5] = {0.f, 1.f, 0.5f, 0.25f, 0.0625f};

// v[k] for a runtime k without dynamic indexing (keeps v in registers)
template <int NV>
__device__ __forceinline__ float pick(const float (&v)[NV], int k) {
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i == k) out = v[i];
  }
  return out;
}

template <int NV>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int nv, float (&row)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) row[i] = i < nv ? src[i] : 0.f;
}

template <int NV>
__device__ __forceinline__ float dot(const float (&u)[NV],
                                     const float (&v)[NV]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += u[i] * v[i];
  return s;
}

// Solve h x = g, h symmetric positive definite (lower triangle read).
template <int NV>
__device__ __forceinline__ void chol_solve(float (&h)[NV][NV],
                                           const float (&g)[NV],
                                           float (&x)[NV]) {
  float inv_diag[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float s = h[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= h[j][k] * h[j][k];
    const float ljj = sqrtf(fmaxf(s, 1e-30f));
    h[j][j] = ljj;
    const float inv = 1.f / ljj;
    inv_diag[j] = inv;
#pragma unroll
    for (int i = j + 1; i < NV; ++i) {
      float t = h[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= h[i][k] * h[j][k];
      h[i][j] = t * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= h[i][k] * x[k];
    x[i] = s * inv_diag[i];
  }
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < NV; ++k) s -= h[k][i] * x[k];
    x[i] = s * inv_diag[i];
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads) newton_kernel(
    const float* __restrict__ qm_g, const float* __restrict__ qs_g,
    const float* __restrict__ j_g, const float* __restrict__ aref_g,
    const float* __restrict__ dvec_g, const float* __restrict__ eqf_g,
    const float* __restrict__ saref_g, const float* __restrict__ sdvec_g,
    const int* __restrict__ dof_g, const float* __restrict__ sign_g,
    float* __restrict__ qacc_g, float* __restrict__ jard_g,
    float* __restrict__ jars_g, int batch, int nv, int n, int ns, int cap,
    float tol) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  const float* qm_b = qm_g + static_cast<size_t>(b) * nv * nv;
  float m[NV][NV], qs[NV], qacc[NV];
#pragma unroll
  for (int r = 0; r < NV; ++r) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      m[r][c] = (r < nv && c < nv) ? qm_b[r * nv + c] : (r == c ? 1.f : 0.f);
    }
  }
  load_row<NV>(qs_g + static_cast<size_t>(b) * nv, nv, qs);
#pragma unroll
  for (int i = 0; i < NV; ++i) qacc[i] = qs[i];

  const float* jb = j_g + static_cast<size_t>(b) * n * nv;
  const float* aref = aref_g + static_cast<size_t>(b) * n;
  const float* dvec = dvec_g + static_cast<size_t>(b) * n;
  const float* eqf = eqf_g + static_cast<size_t>(b) * n;
  const float* saref = saref_g + static_cast<size_t>(b) * ns;
  const float* sdvec = sdvec_g + static_cast<size_t>(b) * ns;
  float* jar_d = jard_g + static_cast<size_t>(b) * n;
  float* jar_s = jars_g + static_cast<size_t>(b) * ns;

  float row[NV];
  for (int r = 0; r < n; ++r) {
    load_row<NV>(jb + r * nv, nv, row);
    jar_d[r] = dot<NV>(row, qs) - aref[r];
  }
  for (int r = 0; r < ns; ++r) {
    jar_s[r] = sign_g[r] * pick<NV>(qs, dof_g[r]) - saref[r];
  }

  bool prev_exact = false;
  for (int it = 0; it < cap; ++it) {
    float e[NV], me[NV], g[NV], h[NV][NV], step[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) e[i] = qacc[i] - qs[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      me[i] = dot<NV>(m[i], e);
      g[i] = me[i];
#pragma unroll
      for (int c = 0; c <= i; ++c) h[i][c] = m[i][c] + (i == c ? kDamp : 0.f);
    }

    // gradient and Hessian of the active rows
    for (int r = 0; r < n; ++r) {
      load_row<NV>(jb + r * nv, nv, row);
      const float jar = jar_d[r];
      const float w = (jar < 0.f || eqf[r] > 0.5f) ? dvec[r] : 0.f;
      const float wj = w * jar;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        g[i] += row[i] * wj;
        const float wi = w * row[i];
#pragma unroll
        for (int c = 0; c <= i; ++c) h[i][c] += wi * row[c];
      }
    }
    for (int r = 0; r < ns; ++r) {
      const int k = dof_g[r];
      const float jar = jar_s[r];
      const float w = jar < 0.f ? sdvec[r] : 0.f;
      const float gk = sign_g[r] * (w * jar);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i == k) {
          g[i] += gk;
          h[i][i] += w;
        }
      }
    }

    chol_solve<NV>(h, g, step);

    // exact line search on the piecewise-quadratic cost
    float mstep[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) mstep[i] = dot<NV>(m[i], step);
    const float sme = dot<NV>(step, me);
    const float sms = dot<NV>(step, mstep);
    const float eme = dot<NV>(e, me);
    float pen_d[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    float pen_s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < n; ++r) {
      load_row<NV>(jb + r * nv, nv, row);
      const float js = dot<NV>(row, step);
      const float jar = jar_d[r];
      const bool eq = eqf[r] > 0.5f;
      const float dv = dvec[r];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const float jc = jar - kAlphas[a] * js;
        const float pc = (jc < 0.f || eq) ? dv : 0.f;
        pen_d[a] += pc * jc * jc;
      }
    }
    for (int r = 0; r < ns; ++r) {
      const float js = sign_g[r] * pick<NV>(step, dof_g[r]);
      const float jar = jar_s[r];
      const float dv = sdvec[r];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const float jc = jar - kAlphas[a] * js;
        const float pc = jc < 0.f ? dv : 0.f;
        pen_s[a] += pc * jc * jc;
      }
    }
    int best = 0;
    float best_cost = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const float al = kAlphas[a];
      const float c = 0.5f * eme - al * sme + 0.5f * al * al * sms
                      + (0.5f * pen_d[a] + 0.5f * pen_s[a]);
      if (a == 0 || c < best_cost) {
        best = a;
        best_cost = c;
      }
    }
    const float alpha = kAlphas[best];

    // take the step; carry the jars; compare the active sets
    float qn2 = 0.f, sn2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      qacc[i] -= alpha * step[i];
      qn2 += qacc[i] * qacc[i];
      sn2 += step[i] * step[i];
    }
    bool flipped = false;
    for (int r = 0; r < n; ++r) {
      load_row<NV>(jb + r * nv, nv, row);
      const float js = dot<NV>(row, step);
      const float jar = jar_d[r];
      const bool eq = eqf[r] > 0.5f;
      const float jn = jar - alpha * js;
      flipped |= ((jar < 0.f) || eq) != ((jn < 0.f) || eq);
      jar_d[r] = jn;
    }
    for (int r = 0; r < ns; ++r) {
      const float js = sign_g[r] * pick<NV>(step, dof_g[r]);
      const float jar = jar_s[r];
      const float jn = jar - alpha * js;
      flipped |= (jar < 0.f) != (jn < 0.f);
      jar_s[r] = jn;
    }
    const bool exact = best == 1 && !flipped;
    const bool small = sqrtf(sn2) <= tol * (1.f + sqrtf(qn2));
    const bool done = (exact && prev_exact) || small;
    prev_exact = exact;
    if (done) break;
  }

  float* qacc_b = qacc_g + static_cast<size_t>(b) * nv;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < nv) qacc_b[i] = qacc[i];
  }
}

template <int NV>
void launch(const float* qm, const float* qs, const float* j,
            const float* aref, const float* dvec, const float* eqf,
            const float* s_aref, const float* s_dvec, const int* dof,
            const float* sign, float* qacc, float* jar_d, float* jar_s,
            int batch, int nv, int n, int ns, int cap, float tol,
            cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  newton_kernel<NV><<<blocks, kThreads, 0, stream>>>(
      qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, qacc, jar_d,
      jar_s, batch, nv, n, ns, cap, tol);
}

}  // namespace

// qm (batch, nv, nv), qs (batch, nv), j (batch, n, nv), aref/dvec/eqf
// (batch, n), s_aref/s_dvec (batch, ns): contiguous float32 on the device;
// dof (ns,) int32 in [0, nv) and sign (ns,) float32, shared by all samples.
// Writes qacc (batch, nv), jar_d (batch, n), jar_s (batch, ns). n and ns
// may be 0 (their pointers are then not read). 1 <= nv <= 32. Returns
// cudaGetLastError() after the launch.
extern "C" int mjpc_newton_f32(const float* qm, const float* qs,
                               const float* j, const float* aref,
                               const float* dvec, const float* eqf,
                               const float* s_aref, const float* s_dvec,
                               const int* dof, const float* sign,
                               float* qacc, float* jar_d, float* jar_s,
                               int batch, int nv, int n, int ns, int cap,
                               float tol, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  if (nv < 1 || nv > 32 || n < 0 || ns < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define MJPC_NEWTON_LAUNCH(NV)                                           \
  launch<NV>(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, qacc, \
             jar_d, jar_s, batch, nv, n, ns, cap, tol, st)
  if (nv <= 2) MJPC_NEWTON_LAUNCH(2);
  else if (nv <= 4) MJPC_NEWTON_LAUNCH(4);
  else if (nv <= 8) MJPC_NEWTON_LAUNCH(8);
  else if (nv <= 12) MJPC_NEWTON_LAUNCH(12);
  else if (nv <= 16) MJPC_NEWTON_LAUNCH(16);
  else if (nv <= 24) MJPC_NEWTON_LAUNCH(24);
  else MJPC_NEWTON_LAUNCH(32);
#undef MJPC_NEWTON_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
