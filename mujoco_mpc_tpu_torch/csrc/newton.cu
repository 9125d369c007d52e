// Whole primal-Newton constraint solve per sample, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_mpc_tpu/ops/pallas_newton.py
// _newton_kernel (called through newton_batched, :222-549 and :627-775):
// dense rows, one-hot-scalar rows and factored pyramidal contact-point
// groups. Per iteration: active set (jar < 0, or an equality row),
// gradient M (qacc - qs) + J^T W jar, Hessian M + 1e-10 I + J^T W J solved
// by Cholesky (diagonal floored at 1e-30), exact line search over alpha in
// {0, 1, 0.5, 0.25, 0.0625}, jar <- jar - alpha J step. A sample stops
// after two consecutive full steps with an unchanged active set, or once
// |step| <= tol (1 + |qacc|), or at `cap` iterations.
//
// Contact groups arrive factored, as in the TPU kernel: per point p the
// direction factors G[p, d] (6-vectors), the dof axes cdofc[k] (6-vectors,
// shared by the groups) and the model constant dmask[p, k] in {-1, 0, 1}.
// Facet f of point p has the Jacobian row
//   J[f, p, k] = dmask[p, k] (GF[f, p] . cdofc[k]),
//   GF[f, p] = G[p, 0] + sign_f mu[col_f, p] G[p, dir_f]
// (PYRAMID_FACETS; condim 1: GF = G[p, 0]). The TPU kernel expands these
// rows once into VMEM (:285-321). A thread here has at most 255 registers,
// and at the Quadruped's shapes (nv 18, 80 facet rows) the expansion
// alone would be 5.8 KB per sample, so the kernel never stores it: the
// gradient and Hessian rebuild each active facet's row when they need it
// (6 multiply-adds per entry), and the line search and the jar update use
// J[f, p] . x = GF[f, p] . (sum_k dmask[p, k] x[k] cdofc[k]), one 6-vector
// per point shared by its facets. Points with a zero penalty weight (not
// in contact) add nothing to the gradient, Hessian or line search and are
// skipped there; their jars are still carried, because the exit test
// counts their sign flips as the TPU kernel does. dmask is read per point
// and is the same for every sample, so its branches never diverge.
//
// What bounds it on the card: arithmetic latency of one thread per sample.
// Cartpole (nv 2, ns 2, cap 8, B 8192) does a few hundred flops and moves
// ~80 bytes per sample; Quadruped (nv 18, ns 24, one condim-3 group of 20
// points, cap 6, B 4096) does ~1e5 flops and moves ~4 KB per sample, and
// its 4096 threads are 128 warps, about one per SM, so nothing hides the
// latency of the dependent multiply-adds. The per-sample matrices spill to
// local memory from nv = 8 up (ptxas -v, PERF.md). A warp per sample or a
// batch-innermost layout is later work (ROADMAP B3).
//
// Design: one thread per sample runs the whole loop to its own exit, so a
// finished sample is frozen for free (the TPU kernel masks every lane
// until the whole tile is done). qm (lower triangle), the Hessian, its
// factor, gradient and step live in (NV, NV) / (NV,) arrays, fully
// unrolled for a compile-time bucket NV >= nv; dimensions nv..NV-1 are
// padded with an identity block, which leaves the first nv components
// exactly as an exact-nv solve would compute them. The row jars are
// carried in the jar outputs themselves, so the kernel needs no scratch
// and allocates nothing. Dense rows, qm, G and cdofc are read row-major
// per sample, which is uncoalesced (the TPU's batch-innermost layout is
// the later fix). No shared memory, no synchronisation; the launch goes
// on the caller's stream, 32 threads a block so that B = 4096 spreads
// over 128 SMs.

#include <cuda_runtime.h>

// One factored contact-point group, batch-first and contiguous.
struct MjpcNewtonGroup {
  const float* g;      // (batch, p, condim, 6) direction factors
  const float* aref;   // (batch, nrep, p)
  const float* dvec;   // (batch, p)
  const float* mu;     // (batch, 3, p)
  const float* dmask;  // (p, nv), shared by the batch
  float* jar;          // (batch, nrep, p): written, and carried in place
  int p;
  int condim;          // 1, 3, 4 or 6: nrep = 1, 4, 6, 10 facets a point
};

namespace {

constexpr int kThreads = 32;
constexpr int kMaxGroups = 4;
constexpr float kDamp = 1e-10f;
__constant__ float kAlphas[5] = {0.f, 1.f, 0.5f, 0.25f, 0.0625f};
// Facet f of a condim 3/4/6 point (PYRAMID_FACETS, whose condim-3 and
// condim-4 tables are prefixes of condim 6's): direction, friction
// column and sign. Condim 1 has one facet, the bare normal.
__constant__ int kFacetDir[10] = {1, 1, 2, 2, 3, 3, 4, 4, 5, 5};
__constant__ int kFacetCol[10] = {0, 0, 0, 0, 1, 1, 2, 2, 2, 2};
__constant__ float kFacetSign[10] = {1.f, -1.f, 1.f, -1.f, 1.f,
                                     -1.f, 1.f, -1.f, 1.f, -1.f};

struct Groups {
  MjpcNewtonGroup slot[kMaxGroups];
  int count;
};

// One group's operands for sample b.
struct GroupView {
  const float* g;
  const float* aref;
  const float* dvec;
  const float* mu;
  const float* dmask;
  float* jar;
  int p;
  int ndirs;
  int nrep;
};

__device__ __forceinline__ GroupView group_view(const MjpcNewtonGroup& gr,
                                                int b) {
  GroupView v;
  const size_t bs = static_cast<size_t>(b);
  v.p = gr.p;
  v.ndirs = gr.condim;
  v.nrep = gr.condim == 1 ? 1 : 2 * (gr.condim - 1);
  v.g = gr.g + bs * gr.p * v.ndirs * 6;
  v.aref = gr.aref + bs * v.nrep * gr.p;
  v.dvec = gr.dvec + bs * gr.p;
  v.mu = gr.mu + bs * 3 * gr.p;
  v.dmask = gr.dmask;
  v.jar = gr.jar + bs * v.nrep * gr.p;
  return v;
}

// GF[f, p], the facet-combined 6-vector factor.
__device__ __forceinline__ void facet_factor(const GroupView& v, int p,
                                             int f, float (&gf)[6]) {
  const float* gp = v.g + p * v.ndirs * 6;
  if (v.nrep == 1) {
#pragma unroll
    for (int j = 0; j < 6; ++j) gf[j] = __ldg(gp + j);
    return;
  }
  const float* gd = gp + kFacetDir[f] * 6;
  const float s = kFacetSign[f] * __ldg(v.mu + kFacetCol[f] * v.p + p);
#pragma unroll
  for (int j = 0; j < 6; ++j) gf[j] = __ldg(gp + j) + s * __ldg(gd + j);
}

__device__ __forceinline__ float dot6(const float (&a)[6],
                                      const float (&b)[6]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) s += a[j] * b[j];
  return s;
}

// w = sum_k dmask[k] x[k] cdofc[k], so that J[f, p] . x = GF[f, p] . w.
template <int NV>
__device__ __forceinline__ void point_axis(const float* __restrict__ dm,
                                           const float* __restrict__ cdofc,
                                           int nv, const float (&x)[NV],
                                           float (&w)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) w[j] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k < nv) {
      const float mk = __ldg(dm + k);
      if (mk != 0.f) {
        const float s = mk * x[k];
#pragma unroll
        for (int j = 0; j < 6; ++j) w[j] += s * __ldg(cdofc + k * 6 + j);
      }
    }
  }
}

// The facet's Jacobian row: row[k] = dmask[k] (GF . cdofc[k]).
template <int NV>
__device__ __forceinline__ void facet_row(const float* __restrict__ dm,
                                          const float* __restrict__ cdofc,
                                          int nv, const float (&gf)[6],
                                          float (&row)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float r = 0.f;
    if (k < nv) {
      const float mk = __ldg(dm + k);
      if (mk != 0.f) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) s += gf[j] * __ldg(cdofc + k * 6 + j);
        r = mk * s;
      }
    }
    row[k] = r;
  }
}

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

// (M x)[i] with M symmetric, its lower triangle stored
template <int NV>
__device__ __forceinline__ float sym_dot(const float (&m)[NV][NV], int i,
                                         const float (&x)[NV]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c) s += (c <= i ? m[i][c] : m[c][i]) * x[c];
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
    const float* __restrict__ cdofc_g, float* __restrict__ qacc_g,
    float* __restrict__ jard_g, float* __restrict__ jars_g, int batch,
    int nv, int n, int ns, int cap, float tol,
    const __grid_constant__ Groups groups) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  const float* qm_b = qm_g + static_cast<size_t>(b) * nv * nv;
  float m[NV][NV], qs[NV], qacc[NV];
#pragma unroll
  for (int r = 0; r < NV; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      m[r][c] = (r < nv) ? qm_b[r * nv + c] : (r == c ? 1.f : 0.f);
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
  const float* cdofc = cdofc_g + static_cast<size_t>(b) * nv * 6;
  float* jar_d = jard_g + static_cast<size_t>(b) * n;
  float* jar_s = jars_g + static_cast<size_t>(b) * ns;
  const int ngroups = groups.count;

  float row[NV], w6[6], gf[6];
  for (int r = 0; r < n; ++r) {
    load_row<NV>(jb + r * nv, nv, row);
    jar_d[r] = dot<NV>(row, qs) - aref[r];
  }
  for (int r = 0; r < ns; ++r) {
    jar_s[r] = sign_g[r] * pick<NV>(qs, dof_g[r]) - saref[r];
  }
  for (int s = 0; s < ngroups; ++s) {
    const GroupView v = group_view(groups.slot[s], b);
    for (int p = 0; p < v.p; ++p) {
      point_axis<NV>(v.dmask + p * nv, cdofc, nv, qs, w6);
      for (int f = 0; f < v.nrep; ++f) {
        facet_factor(v, p, f, gf);
        v.jar[f * v.p + p] = dot6(gf, w6) - __ldg(v.aref + f * v.p + p);
      }
    }
  }

  bool prev_exact = false;
  for (int it = 0; it < cap; ++it) {
    float e[NV], me[NV], g[NV], h[NV][NV], step[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) e[i] = qacc[i] - qs[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      me[i] = sym_dot<NV>(m, i, e);
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
    for (int s = 0; s < ngroups; ++s) {
      const GroupView v = group_view(groups.slot[s], b);
      for (int p = 0; p < v.p; ++p) {
        const float dv = __ldg(v.dvec + p);
        if (dv == 0.f) continue;
        for (int f = 0; f < v.nrep; ++f) {
          const float jar = v.jar[f * v.p + p];
          if (!(jar < 0.f)) continue;
          facet_factor(v, p, f, gf);
          facet_row<NV>(v.dmask + p * nv, cdofc, nv, gf, row);
          const float wj = dv * jar;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            g[i] += row[i] * wj;
            const float wi = dv * row[i];
#pragma unroll
            for (int c = 0; c <= i; ++c) h[i][c] += wi * row[c];
          }
        }
      }
    }

    chol_solve<NV>(h, g, step);

    // exact line search on the piecewise-quadratic cost
    float mstep[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) mstep[i] = sym_dot<NV>(m, i, step);
    const float sme = dot<NV>(step, me);
    const float sms = dot<NV>(step, mstep);
    const float eme = dot<NV>(e, me);
    float pen_d[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    float pen_s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    float pen_g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
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
    for (int s = 0; s < ngroups; ++s) {
      const GroupView v = group_view(groups.slot[s], b);
      for (int p = 0; p < v.p; ++p) {
        const float dv = __ldg(v.dvec + p);
        if (dv == 0.f) continue;
        point_axis<NV>(v.dmask + p * nv, cdofc, nv, step, w6);
        for (int f = 0; f < v.nrep; ++f) {
          facet_factor(v, p, f, gf);
          const float js = dot6(gf, w6);
          const float jar = v.jar[f * v.p + p];
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            const float jc = jar - kAlphas[a] * js;
            const float pc = jc < 0.f ? dv : 0.f;
            pen_g[a] += pc * jc * jc;
          }
        }
      }
    }
    int best = 0;
    float best_cost = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const float al = kAlphas[a];
      const float c = 0.5f * eme - al * sme + 0.5f * al * al * sms
                      + (0.5f * pen_d[a] + 0.5f * pen_s[a] + 0.5f * pen_g[a]);
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
    for (int s = 0; s < ngroups; ++s) {
      const GroupView v = group_view(groups.slot[s], b);
      for (int p = 0; p < v.p; ++p) {
        point_axis<NV>(v.dmask + p * nv, cdofc, nv, step, w6);
        for (int f = 0; f < v.nrep; ++f) {
          facet_factor(v, p, f, gf);
          const float js = dot6(gf, w6);
          float* jp = v.jar + f * v.p + p;
          const float jar = *jp;
          const float jn = jar - alpha * js;
          flipped |= (jar < 0.f) != (jn < 0.f);
          *jp = jn;
        }
      }
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
            const float* sign, const float* cdofc, float* qacc,
            float* jar_d, float* jar_s, int batch, int nv, int n, int ns,
            int cap, float tol, const Groups& groups, cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  newton_kernel<NV><<<blocks, kThreads, 0, stream>>>(
      qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, cdofc, qacc,
      jar_d, jar_s, batch, nv, n, ns, cap, tol, groups);
}

}  // namespace

// qm (batch, nv, nv), qs (batch, nv), j (batch, n, nv), aref/dvec/eqf
// (batch, n), s_aref/s_dvec (batch, ns): contiguous float32 on the device;
// dof (ns,) int32 in [0, nv) and sign (ns,) float32, shared by all samples.
// With ngroups (0..4) contact-point groups (host array `groups`, device
// pointers inside), cdofc (batch, nv, 6) on the device. Writes qacc
// (batch, nv), jar_d (batch, n), jar_s (batch, ns) and each group's jar.
// n, ns and a group's p may be 0 (their pointers are then not read).
// 1 <= nv <= 32. Returns cudaGetLastError() after the launch.
extern "C" int mjpc_newton_f32(const float* qm, const float* qs,
                               const float* j, const float* aref,
                               const float* dvec, const float* eqf,
                               const float* s_aref, const float* s_dvec,
                               const int* dof, const float* sign,
                               float* qacc, float* jar_d, float* jar_s,
                               int batch, int nv, int n, int ns, int cap,
                               float tol, const float* cdofc,
                               const MjpcNewtonGroup* groups, int ngroups,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  if (nv < 1 || nv > 32 || n < 0 || ns < 0 || ngroups < 0
      || ngroups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Groups gs = {};
  gs.count = ngroups;
  for (int i = 0; i < ngroups; ++i) {
    const MjpcNewtonGroup& gr = groups[i];
    const bool condim_ok = gr.condim == 1 || gr.condim == 3
                           || gr.condim == 4 || gr.condim == 6;
    if (!condim_ok || gr.p < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (gr.p > 0 && (!cdofc || !gr.g || !gr.aref || !gr.dvec || !gr.mu
                     || !gr.dmask || !gr.jar)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    gs.slot[i] = gr;
  }
#define MJPC_NEWTON_LAUNCH(NV)                                            \
  launch<NV>(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, cdofc, \
             qacc, jar_d, jar_s, batch, nv, n, ns, cap, tol, gs, st)
  if (nv <= 2) MJPC_NEWTON_LAUNCH(2);
  else if (nv <= 4) MJPC_NEWTON_LAUNCH(4);
  else if (nv <= 8) MJPC_NEWTON_LAUNCH(8);
  else if (nv <= 12) MJPC_NEWTON_LAUNCH(12);
  else if (nv <= 18) MJPC_NEWTON_LAUNCH(18);
  else if (nv <= 24) MJPC_NEWTON_LAUNCH(24);
  else MJPC_NEWTON_LAUNCH(32);
#undef MJPC_NEWTON_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
