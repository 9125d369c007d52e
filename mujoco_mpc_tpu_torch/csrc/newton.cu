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
//   J[f, p, k] = jd[p, 0, k] + sign_f mu[col_f, p] jd[p, dir_f, k],
//   jd[p, d, k] = dmask[p, k] (G[p, d] . cdofc[k])
// (PYRAMID_FACETS; condim 1: the bare normal jd[p, 0]).
//
// Design: a tile of L lanes solves one sample, L the smallest power of two
// >= the bucket NV (2 for Cartpole's nv 2, 32 for nv 18..32), 128 / L
// tiles a block. Every synchronisation is the warp's own (__syncwarp,
// shuffles of width L, ballot), never the block's, and the warp iterates
// until each of its tiles has met its sample's exit rule; a tile whose
// sample has finished keeps its sample frozen meanwhile (for L = 32 a tile
// is the warp). Before the loop the tile stages its sample once into its
// slice of dynamic shared memory, reading each operand coalesced (lane k
// takes element k of a contiguous block): every row, dense and facet, as
// one (R, NV + 1) block (the odd stride keeps column reads free of bank
// conflicts), with jar, D and the equality flag per row; the facet rows
// are expanded from (G, mu, cdofc, dmask) once, as the TPU kernel does
// (pallas_newton.py:285-321); M as a symmetric (NV, NV + 1) block from
// qm's lower triangle. One-hot rows keep their (dof, sign) form. Per
// iteration, lane i owns dof i: (M e)_i, the gradient and row i of the
// Hessian, summed over the active rows, which a ballot and a prefix count
// compact into a list; the Cholesky factor and the forward solve run
// column by column across the tile by shuffles, with the rows in
// registers, and the backward solve reads the factor back from shared
// memory. Lane l owns rows l, l + L, ... for J step (kept for the jar
// update), the five line-search penalties and the jar update; the sums,
// the flip flag and the norms are reduced over the tile by butterfly
// shuffles and a ballot, so every lane of a tile sees the same alpha and
// the same exit decision. Dimensions nv..NV-1 are padded with an identity
// block, which leaves the first nv components exactly as an exact-nv solve
// would compute them.
//
// What bounds it on the card: the latency of each sample's dependent
// steps, which the ~20 samples an SM holds at once do not hide. On an
// NVIDIA H100 (700 W) at the Quadruped's shapes (B 4096, nv 18, 80 facet
// rows, 24 one-hot rows, cap 6) it takes ~107 us, ~24x the 4.5 us that its
// bytes need: staging alone (cap 0) ~28 us, then ~18-21 us per iteration
// (about NV shuffle rounds each for the factor and the two solves, and
// passes over the active and one-hot rows); Cartpole (B 8192, nv 2) ~4.7
// us (tools/newton_check.py, PERF.md). Shared memory per sample is
// 4 (R (NV + 6) + NV (NV + 2) + max(NV (NV + 1), the largest group's
// P (6 condim + 3)) + 2 ns) bytes, ~11 KB at the Quadruped's shapes; the
// launch holds fewer tiles a block when 128 / L of them do not fit, and
// refuses a warp of samples that does not.

#include <cuda_runtime.h>

// One factored contact-point group, batch-first and contiguous.
struct MjpcNewtonGroup {
  const float* g;      // (batch, p, condim, 6) direction factors
  const float* aref;   // (batch, nrep, p)
  const float* dvec;   // (batch, p)
  const float* mu;     // (batch, 3, p)
  const float* dmask;  // (p, nv), shared by the batch
  float* jar;          // (batch, nrep, p): written
  int p;
  int condim;          // 1, 3, 4 or 6: nrep = 1, 4, 6, 10 facets a point
};

namespace {

constexpr int kThreads = 128;
// Asking ptxas for 4 resident blocks an SM caps a thread at 128 registers;
// at nv 18 it then keeps everything in registers (112, no spills), where
// the default spilled 12 bytes (ptxas -v, PERF.md).
constexpr int kBlocksPerSm = 4;
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

__host__ __device__ constexpr int lanes(int nv) {
  return nv <= 2 ? 2 : nv <= 4 ? 4 : nv <= 8 ? 8 : nv <= 16 ? 16 : 32;
}

__host__ __device__ inline int nrep_of(int condim) {
  return condim == 1 ? 1 : 2 * (condim - 1);
}

// A sample's slice of shared memory: offsets in floats.
struct Layout {
  int rows;   // R: dense rows, then each group's facet rows, facet-major
  int jar, dv, eq, js, list, m, scratch, vec, sjar, sdv, total;
};

Layout layout(int bucket, int n, int ns, const Groups& gs) {
  const int stride = bucket + 1;
  Layout l;
  l.rows = n;
  int stage = bucket * stride;  // the factor; G and mu while staging
  for (int s = 0; s < gs.count; ++s) {
    const MjpcNewtonGroup& g = gs.slot[s];
    l.rows += nrep_of(g.condim) * g.p;
    stage = stage > g.p * (6 * g.condim + 3) ? stage
                                              : g.p * (6 * g.condim + 3);
  }
  l.jar = l.rows * stride;
  l.dv = l.jar + l.rows;
  l.eq = l.dv + l.rows;
  l.js = l.eq + l.rows;
  l.list = l.js + l.rows;
  l.m = l.list + l.rows;
  l.scratch = l.m + bucket * stride;
  l.vec = l.scratch + stage;
  l.sjar = l.vec + bucket;
  l.sdv = l.sjar + ns;
  l.total = l.sdv + ns;
  return l;
}

__device__ __forceinline__ float dot6(const float* a, const float (&b)[6]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) s += a[j] * b[j];
  return s;
}

// A warp's lanes split into tiles of L, one sample each. Every lane of the
// warp runs every collective with the full mask (a tile that has finished
// keeps iterating, frozen, until its warp is done), so that each is one
// instruction with a mask known at compile time, and a shuffle of width L
// stays inside its tile. No collective may sit behind a condition that
// differs between the tiles of a warp.
template <int L>
struct Tile {
  int first;  // the tile's first lane within the warp

  __device__ float shfl(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, L);
  }
  // sum over the tile, the same bits on every lane (butterfly)
  __device__ float sum(float v) const {
#pragma unroll
    for (int o = L / 2; o > 0; o /= 2) {
      v += __shfl_xor_sync(0xffffffffu, v, o, L);
    }
    return v;
  }
  // bit k: lane k of the tile
  __device__ unsigned ballot(bool p) const {
    const unsigned all = __ballot_sync(0xffffffffu, p) >> first;
    return L == 32 ? all : all & ((1u << (L % 32)) - 1u);
  }
  __device__ void sync() const { __syncwarp(); }
};

template <int NV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) newton_kernel(
    const float* __restrict__ qm_g, const float* __restrict__ qs_g,
    const float* __restrict__ j_g, const float* __restrict__ aref_g,
    const float* __restrict__ dvec_g, const float* __restrict__ eqf_g,
    const float* __restrict__ saref_g, const float* __restrict__ sdvec_g,
    const int* __restrict__ dof_g, const float* __restrict__ sign_g,
    const float* __restrict__ cdofc_g, float* __restrict__ qacc_g,
    float* __restrict__ jard_g, float* __restrict__ jars_g, int batch,
    int nv, int n, int ns, int cap, float tol, const Layout lay,
    const __grid_constant__ Groups groups) {
  constexpr int L = lanes(NV);
  constexpr int S = NV + 1;
  extern __shared__ float smem[];
  const int t = threadIdx.x % L;
  const Tile<L> tile{static_cast<int>(threadIdx.x % 32) - t};
  const int slot = threadIdx.x / L;
  // A tile past the batch's end solves the last sample, frozen from the
  // start, and writes nothing.
  const int b_raw = blockIdx.x * (blockDim.x / L) + slot;
  const bool valid = b_raw < batch;
  const int b = valid ? b_raw : batch - 1;

  float* sh = smem + static_cast<size_t>(slot) * lay.total;
  float* jrow = sh;                    // (R, S) rows, zero past nv
  float* jar = sh + lay.jar;           // (R,) the rows' J qacc - aref
  float* dv = sh + lay.dv;             // (R,) D
  float* eq = sh + lay.eq;             // (R,) 1 for an equality row
  float* js = sh + lay.js;             // (R,) J step
  int* list = reinterpret_cast<int*>(sh + lay.list);  // the active rows
  float* m = sh + lay.m;               // (NV, S) M, symmetric
  float* scratch = sh + lay.scratch;   // G, mu; then the factor (NV, S)
  float* vec = sh + lay.vec;           // (NV,) qs, then the step
  float* sjar = sh + lay.sjar;         // (ns,) one-hot jars
  float* sdv = sh + lay.sdv;           // (ns,) their D
  const size_t bs = static_cast<size_t>(b);
  const int R = lay.rows;
  const bool own = t < NV;             // lane t owns dof t

  // stage the sample
  const float qs = (t < nv) ? qs_g[bs * nv + t] : 0.f;
  const float* qm_b = qm_g + bs * nv * nv;
#pragma unroll
  for (int i = t; i < NV * NV; i += L) {
    const int r = i / NV, c = i - r * NV;
    m[r * S + c] = (r < nv && c < nv)
                       ? qm_b[c <= r ? r * nv + c : c * nv + r]  // lower
                       : (r == c ? 1.f : 0.f);
  }
  if (own) vec[t] = qs;
  const float* jb = j_g + bs * n * nv;
  for (int i = t; i < n * NV; i += L) {
    const int r = i / NV, c = i - r * NV;
    jrow[r * S + c] = c < nv ? jb[r * nv + c] : 0.f;
  }
  for (int r = t; r < n; r += L) {
    jar[r] = aref_g[bs * n + r];       // J qs is subtracted below
    dv[r] = dvec_g[bs * n + r];
    eq[r] = eqf_g[bs * n + r] > 0.5f ? 1.f : 0.f;
  }
  for (int r = t; r < ns; r += L) {
    sjar[r] = saref_g[bs * ns + r];
    sdv[r] = sdvec_g[bs * ns + r];
  }
  float cd[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    cd[j] = (groups.count && t < nv) ? cdofc_g[(bs * nv + t) * 6 + j] : 0.f;
  }
  for (int s = 0, base = n; s < groups.count; ++s) {
    const MjpcNewtonGroup& gr = groups.slot[s];
    const int p = gr.p, cdim = gr.condim, nrep = nrep_of(cdim);
    const int ng = p * cdim * 6;
    for (int i = t; i < ng; i += L) scratch[i] = gr.g[bs * ng + i];
    for (int i = t; i < 3 * p; i += L) {
      scratch[ng + i] = gr.mu[bs * 3 * p + i];
    }
    for (int i = t; i < nrep * p; i += L) {
      jar[base + i] = gr.aref[bs * nrep * p + i];
      dv[base + i] = gr.dvec[bs * p + i % p];
      eq[base + i] = 0.f;
    }
    tile.sync();
    if (own) {
      for (int q = 0; q < p; ++q) {
        const float dm = t < nv ? __ldg(gr.dmask + q * nv + t) : 0.f;
        const float* gq = scratch + q * cdim * 6;
        const float j0 = dm * dot6(gq, cd);
        if (nrep == 1) {
          jrow[(base + q) * S + t] = j0;
          continue;
        }
        for (int f = 0; f < nrep; f += 2) {
          const float jd = dm * dot6(gq + kFacetDir[f] * 6, cd);
          const float mu = scratch[ng + kFacetCol[f] * p + q];
          jrow[(base + f * p + q) * S + t] = j0 + kFacetSign[f] * mu * jd;
          jrow[(base + (f + 1) * p + q) * S + t] =
              j0 + kFacetSign[f + 1] * mu * jd;
        }
      }
    }
    tile.sync();                       // before the next group's G
    base += nrep * p;
  }
  tile.sync();
  for (int r = t; r < R; r += L) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) s += jrow[r * S + c] * vec[c];
    jar[r] = s - jar[r];
  }
  for (int r = t; r < ns; r += L) {
    const int k = __ldg(dof_g + r);
    const float x = (k >= 0 && k < nv) ? vec[k] : 0.f;
    sjar[r] = __ldg(sign_g + r) * x - sjar[r];
  }
  tile.sync();

  float qacc = qs;
  bool prev_exact = false, done = !valid;
  for (int it = 0; it < cap && !__all_sync(0xffffffffu, done); ++it) {
    // (M e)_t and row t of M + 1e-10 I
    const float e = qacc - qs;
    float me = 0.f, h[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float mc = own ? m[t * S + c] : 0.f;
      me += mc * tile.shfl(e, c);
      h[c] = mc + (c == t ? kDamp : 0.f);
    }
    float g = me;

    // the active rows (jar < 0 or an equality row, D != 0), compacted
    int nact = 0;
    for (int base = 0; base < R; base += L) {
      const int r = base + t;
      const bool a = r < R && dv[r] != 0.f && (jar[r] < 0.f || eq[r] != 0.f);
      const unsigned mask = tile.ballot(a);
      if (a) list[nact + __popc(mask & ((1u << t) - 1u))] = r;
      nact += __popc(mask);
    }
    tile.sync();
    for (int q = 0; q < nact; ++q) {
      const int r = list[q];
      const float* jr = jrow + r * S;
      const float w = dv[r];
      const float a = own ? jr[t] : 0.f;
      g += a * (w * jar[r]);
      const float wa = w * a;
#pragma unroll
      for (int c = 0; c < NV; ++c) h[c] += wa * jr[c];
    }
    float hs = 0.f;
    for (int r = 0; r < ns; ++r) {     // branch-free: a row's loads go together
      const float jv = sjar[r];
      const float w = (t < nv && __ldg(dof_g + r) == t && jv < 0.f)
                          ? sdv[r] : 0.f;
      g += __ldg(sign_g + r) * (w * jv);
      hs += w;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) h[c] += c == t ? hs : 0.f;

    // Cholesky, column by column: lane t ends with row t of the factor
    float inv_t = 1.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float d = fmaxf(tile.shfl(h[j], j), 1e-30f);
      const float inv = rsqrtf(d);     // 1 / L_jj, one hardware rsqrt
      const float ljj = d * inv;
      const float lj = t == j ? ljj : h[j] * inv;
      h[j] = lj;
      if (t == j) inv_t = inv;
#pragma unroll
      for (int k = j + 1; k < NV; ++k) h[k] -= lj * tile.shfl(lj, k);
    }
    // L y = g, then L^T step = y (L's columns from shared memory)
    float acc = g;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float yj = tile.shfl(acc * inv_t, j);
      if (t > j) acc -= h[j] * yj;
    }
    if (own) {
#pragma unroll
      for (int c = 0; c < NV; ++c) scratch[t * S + c] = h[c];
    }
    tile.sync();
    acc *= inv_t;
#pragma unroll
    for (int k = NV - 1; k >= 0; --k) {
      const float xk = tile.shfl(acc * inv_t, k);
      if (t < k) acc -= scratch[k * S + t] * xk;
    }
    const float step = own ? acc * inv_t : 0.f;

    // exact line search on the piecewise-quadratic cost
    float ms = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      ms += (own ? m[t * S + c] : 0.f) * tile.shfl(step, c);
    }
    const float sme = tile.sum(step * me);
    const float sms = tile.sum(step * ms);
    const float eme = tile.sum(e * me);
    if (own) vec[t] = step;
    tile.sync();
    float pen[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    float pen_s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = t; r < R; r += L) {
      float x = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) x += jrow[r * S + c] * vec[c];
      js[r] = x;
      const float jv = jar[r], w = dv[r];
      const bool q = eq[r] != 0.f;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const float jc = jv - kAlphas[a] * x;
        pen[a] += ((jc < 0.f || q) ? w : 0.f) * jc * jc;
      }
    }
    for (int r = t; r < ns; r += L) {
      const int k = __ldg(dof_g + r);
      const float x = (k >= 0 && k < nv) ? __ldg(sign_g + r) * vec[k] : 0.f;
      const float jv = sjar[r], w = sdv[r];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const float jc = jv - kAlphas[a] * x;
        pen_s[a] += (jc < 0.f ? w : 0.f) * jc * jc;
      }
    }
    int best = 0;
    float best_cost = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const float al = kAlphas[a];
      const float c = 0.5f * eme - al * sme + 0.5f * al * al * sms
                      + tile.sum(0.5f * pen[a] + 0.5f * pen_s[a]);
      if (a == 0 || c < best_cost) {
        best = a;
        best_cost = c;
      }
    }
    const float alpha = kAlphas[best];

    // take the step; carry the jars; compare the active sets (a finished
    // sample stays as it is)
    const float qnew = qacc - alpha * step;
    const float qn2 = tile.sum(qnew * qnew);
    const float sn2 = tile.sum(step * step);
    bool flipped = false;
    if (!done) {
      qacc = qnew;
      for (int r = t; r < R; r += L) {
        const float jv = jar[r], jn = jv - alpha * js[r];
        const bool q = eq[r] != 0.f;
        flipped |= ((jv < 0.f) || q) != ((jn < 0.f) || q);
        jar[r] = jn;
      }
      for (int r = t; r < ns; r += L) {
        const int k = __ldg(dof_g + r);
        const float x = (k >= 0 && k < nv) ? __ldg(sign_g + r) * vec[k] : 0.f;
        const float jv = sjar[r], jn = jv - alpha * x;
        flipped |= (jv < 0.f) != (jn < 0.f);
        sjar[r] = jn;
      }
    }
    // every lane of the warp takes the ballot, whatever its tile's alpha
    const bool stable = tile.ballot(flipped) == 0u;
    const bool exact = best == 1 && stable;
    const bool small = sqrtf(sn2) <= tol * (1.f + sqrtf(qn2));
    if (!done) {
      done = (exact && prev_exact) || small;
      prev_exact = exact;
    }
  }

  tile.sync();
  if (!valid) return;
  if (t < nv) qacc_g[bs * nv + t] = qacc;
  for (int r = t; r < n; r += L) jard_g[bs * n + r] = jar[r];
  for (int r = t; r < ns; r += L) jars_g[bs * ns + r] = sjar[r];
  for (int s = 0, base = n; s < groups.count; ++s) {
    const MjpcNewtonGroup& gr = groups.slot[s];
    const int k = nrep_of(gr.condim) * gr.p;
    for (int i = t; i < k; i += L) gr.jar[bs * k + i] = jar[base + i];
    base += k;
  }
}

// The kernel instance's attributes for blocks of `smem` bytes of dynamic
// shared memory: as much of the SM's L1 as shared memory as it takes, so
// that as many blocks as fit stay resident, and past 48 KB the opt-in to
// it. Returns a CUDA error code.
template <int NV>
int set_attributes(int smem) {
  cudaFuncSetAttribute(newton_kernel<NV>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        newton_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem));
  }
  return 0;
}

template <int NV>
int launch(const float* qm, const float* qs, const float* j,
           const float* aref, const float* dvec, const float* eqf,
           const float* s_aref, const float* s_dvec, const int* dof,
           const float* sign, const float* cdofc, float* qacc, float* jar_d,
           float* jar_s, int batch, int nv, int n, int ns, int cap,
           float tol, const Groups& groups, cudaStream_t stream) {
  constexpr int L = lanes(NV);
  const Layout lay = layout(NV, n, ns, groups);
  const size_t per = sizeof(float) * static_cast<size_t>(lay.total);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  // whole warps of tiles (the collectives take the full warp)
  constexpr int kWarpTiles = 32 / L;
  int tiles = kThreads / L;
  if (per * tiles > static_cast<size_t>(limit)) {
    tiles = static_cast<int>(limit / per) / kWarpTiles * kWarpTiles;
  }
  if (tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = per * tiles;
  const int err = set_attributes<NV>(static_cast<int>(bytes));
  if (err != 0) return err;
  const int blocks = (batch + tiles - 1) / tiles;
  newton_kernel<NV><<<blocks, tiles * L, bytes, stream>>>(
      qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, cdofc, qacc,
      jar_d, jar_s, batch, nv, n, ns, cap, tol, lay, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int blocks_per_sm(int threads, int smem, int* blocks) {
  const int err = set_attributes<NV>(smem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, newton_kernel<NV>, threads, static_cast<size_t>(smem)));
}

}  // namespace

// The blocks of `threads` threads and `smem` bytes of dynamic shared
// memory that one SM of the current device holds at once, for nv's bucket
// instance, with the attributes launch() sets (the CUDA occupancy
// calculator's answer, written to *blocks). Returns a CUDA error code.
extern "C" int mjpc_newton_blocks_per_sm(int nv, int threads, int smem,
                                         int* blocks) {
  if (nv < 1 || nv > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nv <= 2) return blocks_per_sm<2>(threads, smem, blocks);
  if (nv <= 4) return blocks_per_sm<4>(threads, smem, blocks);
  if (nv <= 8) return blocks_per_sm<8>(threads, smem, blocks);
  if (nv <= 12) return blocks_per_sm<12>(threads, smem, blocks);
  if (nv <= 18) return blocks_per_sm<18>(threads, smem, blocks);
  if (nv <= 24) return blocks_per_sm<24>(threads, smem, blocks);
  return blocks_per_sm<32>(threads, smem, blocks);
}

// qm (batch, nv, nv), qs (batch, nv), j (batch, n, nv), aref/dvec/eqf
// (batch, n), s_aref/s_dvec (batch, ns): contiguous float32 on the device;
// dof (ns,) int32 in [0, nv) and sign (ns,) float32, shared by all samples.
// With ngroups (0..4) contact-point groups (host array `groups`, device
// pointers inside), cdofc (batch, nv, 6) on the device. Writes qacc
// (batch, nv), jar_d (batch, n), jar_s (batch, ns) and each group's jar.
// n, ns and a group's p may be 0 (their pointers are then not read).
// 1 <= nv <= 32. Returns the launch's CUDA error code, or
// cudaErrorInvalidValue for operands it does not take, among them a sample
// whose shared memory exceeds what a block may hold.
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
#define MJPC_NEWTON_LAUNCH(NV)                                             \
  return launch<NV>(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, \
                    cdofc, qacc, jar_d, jar_s, batch, nv, n, ns, cap, tol,  \
                    gs, st)
  if (nv <= 2) MJPC_NEWTON_LAUNCH(2);
  else if (nv <= 4) MJPC_NEWTON_LAUNCH(4);
  else if (nv <= 8) MJPC_NEWTON_LAUNCH(8);
  else if (nv <= 12) MJPC_NEWTON_LAUNCH(12);
  else if (nv <= 18) MJPC_NEWTON_LAUNCH(18);
  else if (nv <= 24) MJPC_NEWTON_LAUNCH(24);
  else MJPC_NEWTON_LAUNCH(32);
#undef MJPC_NEWTON_LAUNCH
}
