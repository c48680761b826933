// The SEIP right-hand side for any shape (A, J, K, M, L, seasonal), shared by
// seip_rk4_any.cu and seip_bs3_any.cu: one warp per ensemble member.
//
// The production kernels (../seip_rk4.cu, ../seip_bs3.cu on ../seip_rhs.cuh) are
// specialised for (4, 4, 4, 4, 2, seasonal) throughout: float4 rows, a 32-lane map of
// two doses a lane, two strains in a float4 head, a half-warp nu table. These kernels
// compute the same function -- the JAX kernel's RHS (dynode_tpu/ops/seip_pallas.py::
// _build_rhs) in its expression order -- at every shape that models/seip.py::
// seip_config builds, with a layout that only asks A * J * K to be counted:
//
// * Lane map. A member's A * J * K (age, history, dose) cells go round robin over the
//   warp: lane q owns cells q, q + 32, ... (kPerLane of them, the last round ragged).
//   A lane keeps S over m and E, I, C over l of each of its cells in registers.
// * What crosses cells goes through the warp's slab in shared memory. At the start of
//   an RHS every lane writes its cells' S, E and I there; then
//     - lane q < A L sums I over (j, k) of one (age, strain), in cell order, and adds
//       the introduction pulse; lanes A L .. A L + A K - 1 each sum S over (j, m) of one
//       (age, dose) -- over m first, then over j -- and form its uptake rate;
//     - lane q < A L mixes the ages' sums by the contact row: the force of infection
//       lam(a, l);
//     - every lane then computes its cells' derivatives, reading lam and the rates, the
//       lower dose's S for the dose flow k - 1 -> k, the other histories' I for the
//       recovery routing eta_to[j'][l] -> j, and the top tier's S, E, I for the seasonal
//       reset, from the slab.
//   Three __syncwarp separate the phases and one ends the RHS, so the next RHS may
//   overwrite the slab. The plain version (ops/seip.py::seip_kernel_rhs, for any shape
//   but the production one) sums in the same orders, so both round alike.
// * Constants. The host's float64 constants (ops/seip.py::kernel_constants, in its
//   order) stay in device memory; each CTA rounds them to float once into shared memory
//   (ConstLayout gives each field's place) and reads them there by index.
// * Time scalars. A time row is season, the pulse of each strain, phi, then nu(a, k):
//   2 + L + A K floats (the production row is the L = 2 case). time_value computes one
//   value with every operation rounded on its own, as ../seip_rhs.cuh does.
//
// What bounds these kernels: float32 operations and shared-memory latency, not bytes.
// They are written to be right at every shape, not fast: a phase serialises each sum on
// one lane, and a shape with more than 32 cells keeps several cells a lane in registers.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "seip_rhs.cuh"

namespace dynode_seip_any {

using dynode_seip::kFull;
using dynode_seip::kMaxKnots;
using dynode_seip::kTwoPi;
using dynode_seip::Outs;

constexpr int kWarp = 32;

// The member's structure and its places in the warp's slab.
template <int A, int J, int K, int M, int L>
struct Dims {
  static constexpr int kCells = A * J * K;
  static constexpr int kPerLane = (kCells + kWarp - 1) / kWarp;  // cells a lane owns (some lanes one less)
  static constexpr int NS = kCells * M;
  static constexpr int NE = kCells * L;
  static constexpr int kHead = 2 + L;            // season, the L pulses, phi
  static constexpr int kRow = kHead + A * K;     // a time row: the head, then nu(a, k)
  // the slab of one warp: S, E, I of the RHS's input, then inf(a, l), lam(a, l),
  // rate(a, k) and the member's scale(l)
  static constexpr int kS = 0;
  static constexpr int kE = NS;
  static constexpr int kI = NS + NE;
  static constexpr int kInf = NS + 2 * NE;
  static constexpr int kLam = kInf + A * L;
  static constexpr int kRate = kLam + A * L;
  static constexpr int kScale = kRate + A * K;
  static constexpr int kSlab = (kScale + L + 3) / 4 * 4;
  __host__ __device__ static constexpr int age(int cell) { return cell / (J * K); }
  __host__ __device__ static constexpr int hist(int cell) { return cell / K % J; }
  __host__ __device__ static constexpr int dose(int cell) { return cell % K; }
};

// Where each field of ops/seip.py::kernel_constants starts in the flat float64 array
// (its order; n_knots knots per (age, dose)).
template <int A, int J, int K, int M, int L>
struct ConstLayout {
  static constexpr int contact = 0;
  static constexpr int lamc = contact + A * A;  // (L, A): float(beta[l] / pop[a])
  static constexpr int sigma = lamc + L * A;
  static constexpr int gamma = sigma + L;
  static constexpr int pop = gamma + L;
  static constexpr int season = pop + A;  // amp, peak, tau
  static constexpr int intro_time = season + 3;
  static constexpr int intro_scale = intro_time + L;
  static constexpr int intro_perc = intro_scale + L;
  static constexpr int intro_norm = intro_perc + L;
  static constexpr int intro_mask = intro_norm + L;  // (L, A)
  static constexpr int maskpop = intro_mask + L * A;  // (L, A)
  static constexpr int vax_base = maskpop + L * A;  // (A, K, 4)
  static constexpr int vax_knots = vax_base + A * K * 4;  // (A, K, n_knots)
  int n_knots;
  __host__ __device__ constexpr int vax_kcoef() const { return vax_knots + A * K * n_knots; }
  __host__ __device__ constexpr int omega() const { return vax_kcoef() + A * K * n_knots; }
  __host__ __device__ constexpr int escape() const { return omega() + M; }  // (L, J, K, M)
  __host__ __device__ constexpr int eta_to() const { return escape() + L * J * K * M; }  // (J, L)
  __host__ __device__ constexpr int size() const { return eta_to() + J * L; }
  // floats of shared memory the constants take, for any knot count the host allows
  static constexpr int kShared = (ConstLayout{kMaxKnots}.size() + 3) / 4 * 4;
};

// The rounded constants in shared memory, read by index.
template <int A, int J, int K, int M, int L>
struct View {
  using CL = ConstLayout<A, J, K, M, L>;
  const float* c;
  CL lay;
  __device__ float contact(int a, int b) const { return c[CL::contact + a * A + b]; }
  __device__ float lamc(int l, int a) const { return c[CL::lamc + l * A + a]; }
  __device__ float sigma(int l) const { return c[CL::sigma + l]; }
  __device__ float gamma(int l) const { return c[CL::gamma + l]; }
  __device__ float pop(int a) const { return c[CL::pop + a]; }
  __device__ float season(int i) const { return c[CL::season + i]; }
  __device__ float intro_time(int l) const { return c[CL::intro_time + l]; }
  __device__ float intro_scale(int l) const { return c[CL::intro_scale + l]; }
  __device__ float intro_perc(int l) const { return c[CL::intro_perc + l]; }
  __device__ float intro_norm(int l) const { return c[CL::intro_norm + l]; }
  __device__ float intro_mask(int l, int a) const { return c[CL::intro_mask + l * A + a]; }
  __device__ float maskpop(int l, int a) const { return c[CL::maskpop + l * A + a]; }
  __device__ const float* vax_base(int a, int k) const { return c + CL::vax_base + (a * K + k) * 4; }
  __device__ const float* vax_knots(int a, int k) const { return c + CL::vax_knots + (a * K + k) * lay.n_knots; }
  __device__ const float* vax_kcoef(int a, int k) const { return c + lay.vax_kcoef() + (a * K + k) * lay.n_knots; }
  __device__ float omega(int m) const { return c[lay.omega() + m]; }
  __device__ float escape(int l, int j, int k, int m) const {
    return c[lay.escape() + ((l * J + j) * K + k) * M + m];
  }
  __device__ int eta_to(int j, int l) const { return static_cast<int>(c[lay.eta_to() + j * L + l]); }
};

// Round the host's float64 constants into shared memory (every thread of the CTA, then
// a barrier).
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ View<A, J, K, M, L> load_consts(float* dst, const double* __restrict__ src,
                                                           int n_knots) {
  const ConstLayout<A, J, K, M, L> lay{n_knots};
  for (int i = threadIdx.x; i < lay.size(); i += blockDim.x) dst[i] = static_cast<float>(src[i]);
  __syncthreads();
  return View<A, J, K, M, L>{dst, lay};
}

// Value i of the time row at day t, in the expression order of ops/seip.py::
// _time_scalars, every operation rounded on its own (../seip_rhs.cuh::time_value at
// any L). A pulse of a strain with no introduction is 0, and so is phi without
// seasonal vaccination.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ float time_value(const View<A, J, K, M, L>& c, float t, int i) {
  using D = Dims<A, J, K, M, L>;
  if (i >= D::kHead) {  // the clipped uptake spline of (a, k)
    const int a = (i - D::kHead) / K, k = (i - D::kHead) % K;
    const float* b = c.vax_base(a, k);
    const float* knots = c.vax_knots(a, k);
    const float* kcoef = c.vax_kcoef(a, k);
    float v = __fadd_rn(__fadd_rn(__fadd_rn(b[0], __fmul_rn(b[1], t)), __fmul_rn(__fmul_rn(b[2], t), t)),
                        __fmul_rn(__fmul_rn(__fmul_rn(b[3], t), t), t));
    for (int n = 0; n < c.lay.n_knots; ++n) {
      const float d = __fsub_rn(t, knots[n]);
      v = __fadd_rn(v, __fmul_rn(kcoef[n], d > 0.0f ? __fmul_rn(__fmul_rn(d, d), d) : 0.0f));
    }
    return fmaxf(v, 0.0f);
  }
  if (i == 0) {
    const float arg = __fdiv_rn(__fmul_rn(kTwoPi, __fsub_rn(t, c.season(1))), 365.0f);
    return __fadd_rn(1.0f, __fmul_rn(c.season(0), cosf(arg)));
  }
  if (i <= L) {
    const int l = i - 1;
    if (c.intro_perc(l) == 0.0f) return 0.0f;
    const float z = __fdiv_rn(__fsub_rn(t, c.intro_time(l)), c.intro_scale(l));
    return __fdiv_rn(__fmul_rn(c.intro_perc(l), expf(__fmul_rn(__fmul_rn(-0.5f, z), z))), c.intro_norm(l));
  }
  if (SEASONAL && i == L + 1) {
    return dynode_seip::integer_pow(sinf(__fdiv_rn(__fmul_rn(kTwoPi, __fadd_rn(t, c.season(2))), 730.0f)),
                                    1000);
  }
  return 0.0f;
}

// A lane's values: its cells' S over m and E, I, C over l.
template <int A, int J, int K, int M, int L>
struct Cells {
  static constexpr int P = Dims<A, J, K, M, L>::kPerLane;
  float s[P][M];
  float e[P][L];
  float i[P][L];
  float c[P][L];
};

// Cell n of `lane`, or -1 past the member's cells.
template <int A, int J, int K, int M, int L>
__host__ __device__ __forceinline__ int cell_of(int lane, int n) {
  const int cell = lane + kWarp * n;
  return cell < Dims<A, J, K, M, L>::kCells ? cell : -1;
}

// out = x + w * k, element by element
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void axpy(Cells<A, J, K, M, L>& out, const Cells<A, J, K, M, L>& x, float w,
                                     const Cells<A, J, K, M, L>& k) {
#pragma unroll
  for (int n = 0; n < Cells<A, J, K, M, L>::P; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) out.s[n][m] = x.s[n][m] + w * k.s[n][m];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out.e[n][l] = x.e[n][l] + w * k.e[n][l];
      out.i[n][l] = x.i[n][l] + w * k.i[n][l];
      out.c[n][l] = x.c[n][l] + w * k.c[n][l];
    }
  }
}

// out = w * k
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void scaled(Cells<A, J, K, M, L>& out, float w, const Cells<A, J, K, M, L>& k) {
#pragma unroll
  for (int n = 0; n < Cells<A, J, K, M, L>::P; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) out.s[n][m] = w * k.s[n][m];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out.e[n][l] = w * k.e[n][l];
      out.i[n][l] = w * k.i[n][l];
      out.c[n][l] = w * k.c[n][l];
    }
  }
}

// d = f(t, y) for this lane's cells. `row` is the time row at t (global or shared
// memory); `slab` the warp's slab, whose scale(l) holds the member's scales.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ __forceinline__ void rhs(Cells<A, J, K, M, L>& d, const Cells<A, J, K, M, L>& y,
                                    const float* row, const View<A, J, K, M, L>& c, float* slab,
                                    int lane) {
  using D = Dims<A, J, K, M, L>;
  constexpr int P = D::kPerLane;
  float* S = slab + D::kS;
  float* E = slab + D::kE;
  float* I = slab + D::kI;
  float* inf = slab + D::kInf;
  float* lam = slab + D::kLam;
  float* rate = slab + D::kRate;
  const float* scale = slab + D::kScale;

  // ---- the input's S, E, I into the slab ------------------------------------
#pragma unroll
  for (int n = 0; n < P; ++n) {
    const int cell = cell_of<A, J, K, M, L>(lane, n);
    if (cell < 0) continue;
#pragma unroll
    for (int m = 0; m < M; ++m) S[cell * M + m] = y.s[n][m];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      E[cell * L + l] = y.e[n][l];
      I[cell * L + l] = y.i[n][l];
    }
  }
  __syncwarp();

  // ---- sums over the structure: sum_{j,k} I + pulse per (a, l); the uptake rate per (a, k)
  for (int q = lane; q < A * L + A * K; q += kWarp) {
    if (q < A * L) {
      const int a = q / L, l = q % L;
      const float* src = I + a * J * K * L + l;
      float v = src[0];
      for (int jk = 1; jk < J * K; ++jk) v = v + src[jk * L];
      if (c.intro_perc(l) != 0.0f && c.intro_mask(l, a) != 0.0f) v = v + row[1 + l] * c.maskpop(l, a);
      inf[q] = v;
    } else {
      const int r = q - A * L;
      const int a = r / K, k = r % K;
      float sv = 0.0f;
      for (int j = 0; j < J; ++j) {
        const float* src = S + ((a * J + j) * K + k) * M;
        float sj = src[0];
        for (int m = 1; m < M; ++m) sj = sj + src[m];
        sv = j == 0 ? sj : sv + sj;
      }
      rate[r] = fminf((row[D::kHead + r] * c.pop(a)) / fmaxf(sv, 1e-8f), 1.0f);
    }
  }
  __syncwarp();

  // ---- the contact mixing: lam(a, l) -------------------------------------------
  for (int q = lane; q < A * L; q += kWarp) {
    const int a = q / L, l = q % L;
    float mixed = c.contact(a, 0) * inf[l];
    for (int b = 1; b < A; ++b) mixed = mixed + c.contact(a, b) * inf[b * L + l];
    lam[q] = ((c.lamc(l, a) * row[0]) * scale[l]) * mixed;
  }
  __syncwarp();

  // ---- each cell's derivatives ---------------------------------------------------
#pragma unroll
  for (int n = 0; n < P; ++n) {
    const int cell = cell_of<A, J, K, M, L>(lane, n);
    if (cell < 0) continue;
    const int a = D::age(cell), j = D::hist(cell), k = D::dose(cell);
    float lm[L];
#pragma unroll
    for (int l = 0; l < L; ++l) lm[l] = lam[a * L + l];

    // S: infection out; E/I/C: the exposure chain
    float esc[L][M];
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int m = 0; m < M; ++m) esc[l][m] = c.escape(l, j, k, m);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float coeff = esc[0][m] * lm[0];
#pragma unroll
      for (int l = 1; l < L; ++l) coeff = coeff + esc[l][m] * lm[l];
      d.s[n][m] = -coeff * y.s[n][m];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float acc = esc[l][0] * y.s[n][0];
#pragma unroll
      for (int m = 1; m < M; ++m) acc = acc + esc[l][m] * y.s[n][m];
      const float ne = lm[l] * acc;
      d.e[n][l] = ne - c.sigma(l) * y.e[n][l];
      d.c[n][l] = ne;
      d.i[n][l] = c.sigma(l) * y.e[n][l] - c.gamma(l) * y.i[n][l];
    }

    // recovery into immune history eta_to[j'][l], waning bin 0, in (j', l) order
    for (int jj = 0; jj < J; ++jj) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (c.eta_to(jj, l) == j) {
          d.s[n][0] = d.s[n][0] + c.gamma(l) * I[((a * J + jj) * K + k) * L + l];
        }
      }
    }

    // vaccination uptake: the lower dose's outflow lands at m = 0, then this dose's
    // own outflow (the top tier recycles its waned, m > 0, back to m = 0)
    const float rk = rate[a * K + k];
    if (k >= 1) {
      const float rlo = rate[a * K + k - 1];
      const float* lo = S + (cell - 1) * M;
      float inflow = rlo * lo[0];
#pragma unroll
      for (int m = 1; m < M; ++m) inflow = inflow + rlo * lo[m];
      d.s[n][0] = d.s[n][0] + inflow;
    }
    if (k < K - 1) {
#pragma unroll
      for (int m = 0; m < M; ++m) d.s[n][m] = d.s[n][m] - rk * y.s[n][m];
    } else if (M > 1) {
      float top = rk * y.s[n][1];
#pragma unroll
      for (int m = 2; m < M; ++m) top = top + rk * y.s[n][m];
#pragma unroll
      for (int m = 1; m < M; ++m) d.s[n][m] = d.s[n][m] - rk * y.s[n][m];
      d.s[n][0] = d.s[n][0] + top;
    }

    // seasonal vaccination reset: the top tier moves to the one below it (to itself
    // at K = 1, as Python's index K - 2 = -1 does)
    if (SEASONAL) {
      const float phi = row[1 + L];
      if (k == (K >= 2 ? K - 2 : K - 1)) {
        const int top_cell = cell + (K - 1 - k);
#pragma unroll
        for (int m = 0; m < M; ++m) d.s[n][m] = d.s[n][m] + phi * S[top_cell * M + m];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          d.e[n][l] = d.e[n][l] + phi * E[top_cell * L + l];
          d.i[n][l] = d.i[n][l] + phi * I[top_cell * L + l];
        }
      }
      if (k == K - 1) {
#pragma unroll
        for (int m = 0; m < M; ++m) d.s[n][m] = d.s[n][m] - phi * y.s[n][m];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          d.e[n][l] = d.e[n][l] - phi * y.e[n][l];
          d.i[n][l] = d.i[n][l] - phi * y.i[n][l];
        }
      }
    }

    // waning chain m -> m + 1
#pragma unroll
    for (int m = 0; m + 1 < M; ++m) {
      const float om = c.omega(m);
      if (om != 0.0f) {
        const float wn = om * y.s[n][m];
        d.s[n][m] = d.s[n][m] - wn;
        d.s[n][m + 1] = d.s[n][m + 1] + wn;
      }
    }
  }
  __syncwarp();  // the slab is read until here
}

// This lane's values of the shared initial state (S, E, I, C flattened in order).
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void load_y0(Cells<A, J, K, M, L>& y, const float* __restrict__ y0, int lane) {
  using D = Dims<A, J, K, M, L>;
#pragma unroll
  for (int n = 0; n < D::kPerLane; ++n) {
    const int cell = cell_of<A, J, K, M, L>(lane, n);
    const int at = cell < 0 ? 0 : cell;  // past the cells: any value, never stored
#pragma unroll
    for (int m = 0; m < M; ++m) y.s[n][m] = __ldg(y0 + at * M + m);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      y.e[n][l] = __ldg(y0 + D::NS + at * L + l);
      y.i[n][l] = __ldg(y0 + D::NS + D::NE + at * L + l);
      y.c[n][l] = __ldg(y0 + D::NS + 2 * D::NE + at * L + l);
    }
  }
}

// Write this lane's values of save slot `slot` at member position `pos`; NaN instead
// when !reached.
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void save_lane(const Outs& o, const Cells<A, J, K, M, L>& y, int slot, size_t pos,
                                          int batch, int lane, bool reached) {
  using D = Dims<A, J, K, M, L>;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int n = 0; n < D::kPerLane; ++n) {
    const int cell = cell_of<A, J, K, M, L>(lane, n);
    if (cell < 0) continue;
    if (o.p[0]) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const size_t off = (static_cast<size_t>(slot) * D::NS + cell * M + m) * batch + pos;
        dynode_seip::store(o.p[0], off, reached ? y.s[n][m] : nan, o.bf16);
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t off = (static_cast<size_t>(slot) * D::NE + cell * L + l) * batch + pos;
      if (o.p[1]) dynode_seip::store(o.p[1], off, reached ? y.e[n][l] : nan, o.bf16);
      if (o.p[2]) dynode_seip::store(o.p[2], off, reached ? y.i[n][l] : nan, o.bf16);
      if (o.p[3]) dynode_seip::store(o.p[3], off, reached ? y.c[n][l] : nan, o.bf16);
    }
  }
}

// The member's scales into the warp's slab (then the warp synchronises).
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void load_scales(float* slab, const float* __restrict__ scales, int member,
                                            int batch, int lane) {
  for (int l = lane; l < L; l += kWarp) {
    slab[Dims<A, J, K, M, L>::kScale + l] = __ldg(scales + static_cast<size_t>(l) * batch + member);
  }
  __syncwarp();
}

// Field starts of the constants (ConstLayout, in kernel_constants order) at n_knots
// knots, for the host's check that both sides agree: contact, lamc, sigma, gamma, pop,
// season, intro_time, intro_scale, intro_perc, intro_norm, intro_mask, maskpop,
// vax_base, vax_knots, vax_kcoef, omega, escape, eta_to, then the size.
template <int A, int J, int K, int M, int L>
inline void layout_offsets(int n_knots, int* out) {
  using CL = ConstLayout<A, J, K, M, L>;
  const CL lay{n_knots};
  const int offs[] = {CL::contact,     CL::lamc,       CL::sigma,      CL::gamma,      CL::pop,
                      CL::season,      CL::intro_time, CL::intro_scale, CL::intro_perc, CL::intro_norm,
                      CL::intro_mask,  CL::maskpop,    CL::vax_base,   CL::vax_knots,  lay.vax_kcoef(),
                      lay.omega(),     lay.escape(),   lay.eta_to(),   lay.size()};
  for (int i = 0; i < static_cast<int>(sizeof(offs) / sizeof(offs[0])); ++i) out[i] = offs[i];
}

}  // namespace dynode_seip_any
