// The SEIP right-hand side shared by seip_rk4.cu and seip_bs3.cu: one warp per
// ensemble member.
//
// It computes what the JAX kernel's RHS computes (dynode_tpu/ops/seip_pallas.py::
// _build_rhs), element by element in its expression order; the plain version in
// ops/seip.py (seip_kernel_rhs) mirrors this file, including the order of every sum
// over the member's structure.
//
// Lane map. The 640-float production state (A, J, K, M, L) = (4, 4, 4, 4, 2) is spread
// over the 32 lanes of a warp: lane = a * J * K/2 + j * K/2 + kp owns the two doses
// k = 2 kp and 2 kp + 1 of cell (a, j): S over m (2 x 4 floats) and E, I, C over l
// (3 x 2 x 2 floats), 20 floats in all. What stays in a lane: every flow of its own
// cells, the waning chain, the dose move 0 -> 1 and 2 -> 3, the top tier's booster
// recycling and the seasonal reset 3 -> 2. What crosses lanes:
//   * sum_{j,k} I per (a, l): a xor butterfly over the age's 8 lanes (offsets 4, 2, 1);
//   * the contact mixing: each age's sum goes through the warp's shared slab (one
//     store by the age's first lane, two 16-byte loads by every lane);
//   * sum_{j,m} S per (a, k): the lane's own m in order, then xor over j (4, 2);
//   * the dose move 1 -> 2 (lane kp = 0 to kp = 1, xor 1);
//   * recovery into history eta_to[j][l] at m = 0: each lane stores its gamma * I
//     (one 16-byte store into the slab) and reads the (history, strain) sources that
//     land in its own history, J * L predicated 8-byte loads.
// A butterfly with descending offsets adds v[i] + v[i + n/2] first; ops/seip.py's
// _halves takes the same order.
//
// Time scalars. Seasonal forcing, the introduction pulses, the seasonal-vaccination
// pulse phi and the uptake splines nu(a, k) depend on t only. They are computed once
// per stage time (time_value: a row of TimeLayout per time) -- by a table kernel ahead
// of the RK4 solve, once per attempt by each warp of the BS3 solve -- and rhs() takes
// the six a lane needs (LaneTime). time_value rounds every operation on its own
// (__fmul_rn and friends cannot be contracted), so a row equals the plain version's
// ops/seip.py::_time_scalars bit for bit under either source's -fmad.
//
// Constants. The host's float64 constants (contact, float(beta[l] / pop[a]), mask *
// pop, the escape table formed in float64, ...) are rounded once, as the JAX kernel
// rounds its Python-float closure constants, and copied to shared memory at start,
// laid out as 16-byte rows that one vector load reads: escape[l][j][k][0..3],
// contact[a][0..3], per age (beta / pop, mask * pop) of both strains, (sigma, gamma)
// of both strains, omega[0..3]. Held in registers instead (about 17 a lane), they
// made ptxas spill at 128 registers. A lane keeps only its recovery and pulse routes
// in registers, as two bit masks (Routes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dynode_seip {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxKnots = 4;  // spline knots per (age, dose); more is refused by the host
constexpr float kTwoPi = static_cast<float>(6.283185307179586);  // float(2 * math.pi)

template <int A, int J, int K, int M, int L>
struct Consts {
  static_assert(A == 4 && M == 4, "contact and escape rows are float4");
  alignas(16) float escape[L][J][K][M];
  alignas(16) float contact[A][A];
  alignas(16) float age_rates[A][2 * L];  // float(beta[l] / pop[a]) for each l, then mask[l, a] * pop[a]
  alignas(16) float flows[2 * L];         // sigma[l] for each l, then gamma[l]
  alignas(16) float omega[M];
  float pop[A];
  float season_amp, season_peak, tau;
  float intro_time[L], intro_scale[L], intro_perc[L], intro_norm[L];
  float intro_mask[L][A];
  float vax_base[A][K][4];
  float vax_knots[A][K][kMaxKnots];
  float vax_kcoef[A][K][kMaxKnots];
  int eta_to[J][L];
  int n_knots;
};

// The one shape the C entry points instantiate (the production configuration), with
// at most kMaxKnots spline knots.
inline bool production(int A, int J, int K, int M, int L, int seasonal, int n_knots) {
  return A == 4 && J == 4 && K == 4 && M == 4 && L == 2 && seasonal && n_knots <= kMaxKnots;
}

// The host's float64 constants, in the order of ops/seip.py::kernel_constants.
template <int A, int J, int K, int M, int L>
Consts<A, J, K, M, L> read_consts(const double* h, int n_knots) {
  Consts<A, J, K, M, L> c{};
  auto take = [&h](float* dst, int n) {
    for (int i = 0; i < n; ++i) dst[i] = static_cast<float>(*h++);
  };
  float lamc[L][A], maskpop[L][A];
  take(&c.contact[0][0], A * A);
  take(&lamc[0][0], L * A);
  take(c.flows, L);
  take(c.flows + L, L);
  take(c.pop, A);
  take(&c.season_amp, 1);
  take(&c.season_peak, 1);
  take(&c.tau, 1);
  take(c.intro_time, L);
  take(c.intro_scale, L);
  take(c.intro_perc, L);
  take(c.intro_norm, L);
  take(&c.intro_mask[0][0], L * A);
  take(&maskpop[0][0], L * A);
  for (int a = 0; a < A; ++a) {
    for (int l = 0; l < L; ++l) {
      c.age_rates[a][l] = lamc[l][a];
      c.age_rates[a][L + l] = maskpop[l][a];
    }
  }
  take(&c.vax_base[0][0][0], A * K * 4);
  for (int a = 0; a < A; ++a) {
    for (int k = 0; k < K; ++k) take(c.vax_knots[a][k], n_knots);
  }
  for (int a = 0; a < A; ++a) {
    for (int k = 0; k < K; ++k) take(c.vax_kcoef[a][k], n_knots);
  }
  take(c.omega, M);
  take(&c.escape[0][0][0][0], L * J * K * M);
  for (int j = 0; j < J; ++j) {
    for (int l = 0; l < L; ++l) c.eta_to[j][l] = static_cast<int>(*h++);
  }
  c.n_knots = n_knots;
  return c;
}

// Copy the parameter-space constants into shared memory (all threads, then a barrier).
template <class C>
__device__ __forceinline__ void load_consts(C& dst, const C& src) {
  static_assert(sizeof(C) % 4 == 0, "word copy");
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(C) / 4); i += blockDim.x) d[i] = s[i];
  __syncthreads();
}

// One lane's values: two doses of one (a, j) cell.
template <int M, int L>
struct Lane {
  float s[2][M];
  float e[2][L];
  float i[2][L];
  float c[2][L];
};

// out = x + w * k, element by element
template <int M, int L>
__device__ __forceinline__ void axpy(Lane<M, L>& out, const Lane<M, L>& x, float w,
                                     const Lane<M, L>& k) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int m = 0; m < M; ++m) out.s[q][m] = x.s[q][m] + w * k.s[q][m];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out.e[q][l] = x.e[q][l] + w * k.e[q][l];
      out.i[q][l] = x.i[q][l] + w * k.i[q][l];
      out.c[q][l] = x.c[q][l] + w * k.c[q][l];
    }
  }
}

// out = w * k
template <int M, int L>
__device__ __forceinline__ void scaled(Lane<M, L>& out, float w, const Lane<M, L>& k) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int m = 0; m < M; ++m) out.s[q][m] = w * k.s[q][m];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out.e[q][l] = w * k.e[q][l];
      out.i[q][l] = w * k.i[q][l];
      out.c[q][l] = w * k.c[q][l];
    }
  }
}

// Where a lane sits in the member's structure.
template <int A, int J, int K>
struct Where {
  static constexpr int KP = K / 2;        // dose pairs
  static constexpr int kAgeLanes = J * KP;  // lanes of one age
  static_assert(K == 4 && A * J * KP == 32, "one warp per member: A * J * K/2 == 32 lanes, K == 4");
  int lane, a, j, kp, k0;
  __device__ explicit Where(int lane_) : lane(lane_) {
    a = lane / kAgeLanes;
    j = (lane / KP) % J;
    kp = lane % KP;
    k0 = 2 * kp;
  }
};

// ---- time scalars -----------------------------------------------------------------

// A row of time scalars: season, the introduction pulse of each strain, phi (kHead
// floats, one float4), then nu(a, k) at kHead + a * K + k.
template <int A, int K, int L>
struct TimeLayout {
  static_assert(L == 2, "season, two pulses and phi fill the row's first float4");
  static constexpr int kHead = 4;
  static constexpr int kRow = kHead + A * K;
  static_assert(kRow % 4 == 0, "rows stay 16-byte aligned");
};

// x ** y by the square-and-multiply chain of jax.lax.integer_pow
__device__ __forceinline__ float integer_pow(float x, int y) {
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

// Value i of the time row at day t (TimeLayout), in the plain version's expression
// order (ops/seip.py::_time_scalars), every operation rounded on its own. A pulse
// whose strain has no introduction is 0, and so is phi without seasonal vaccination.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ float time_value(const Consts<A, J, K, M, L>& c, float t, int i) {
  using T = TimeLayout<A, K, L>;
  if (i >= T::kHead) {  // the clipped uptake spline of (a, k) (_spline_scalar, then max(., 0))
    const int a = (i - T::kHead) / K, k = (i - T::kHead) % K;
    const float* b = c.vax_base[a][k];
    float v = __fadd_rn(__fadd_rn(__fadd_rn(b[0], __fmul_rn(b[1], t)), __fmul_rn(__fmul_rn(b[2], t), t)),
                        __fmul_rn(__fmul_rn(__fmul_rn(b[3], t), t), t));
    for (int n = 0; n < c.n_knots; ++n) {
      const float d = __fsub_rn(t, c.vax_knots[a][k][n]);
      v = __fadd_rn(v, __fmul_rn(c.vax_kcoef[a][k][n], d > 0.0f ? __fmul_rn(__fmul_rn(d, d), d) : 0.0f));
    }
    return fmaxf(v, 0.0f);
  }
  if (i == 0) {
    const float arg = __fdiv_rn(__fmul_rn(kTwoPi, __fsub_rn(t, c.season_peak)), 365.0f);
    return __fadd_rn(1.0f, __fmul_rn(c.season_amp, cosf(arg)));
  }
  if (i <= L) {
    const int l = i - 1;
    if (c.intro_perc[l] == 0.0f) return 0.0f;
    const float z = __fdiv_rn(__fsub_rn(t, c.intro_time[l]), c.intro_scale[l]);
    return __fdiv_rn(__fmul_rn(c.intro_perc[l], expf(__fmul_rn(__fmul_rn(-0.5f, z), z))),
                     c.intro_norm[l]);
  }
  if (SEASONAL && i == L + 1) {
    return integer_pow(sinf(__fdiv_rn(__fmul_rn(kTwoPi, __fadd_rn(t, c.tau)), 730.0f)), 1000);
  }
  return 0.0f;
}

// The time scalars one lane reads: season, the pulses, phi and nu of its two doses.
template <int L>
struct LaneTime {
  float season, pulse[L], phi, nu[2];
};

// This lane's values of a time row (in global or shared memory): two vector loads.
template <int A, int J, int K, int L>
__device__ __forceinline__ LaneTime<L> lane_time(const float* row, const Where<A, J, K>& w) {
  using T = TimeLayout<A, K, L>;
  const float4 head = *reinterpret_cast<const float4*>(row);
  const float2 nu = *reinterpret_cast<const float2*>(row + T::kHead + w.a * K + w.k0);
  LaneTime<L> v;
  v.season = head.x;
  v.pulse[0] = head.y;
  v.pulse[1] = head.z;
  v.phi = head.w;
  v.nu[0] = nu.x;
  v.nu[1] = nu.y;
  return v;
}

// ---- the RHS ------------------------------------------------------------------------

// A lane's recovery and pulse routes.
struct Routes {
  unsigned pulse_on;  // bit l: strain l's introduction reaches this lane's age
  unsigned mine;      // bit jj * L + l: recovery from history jj, strain l lands in history j
};

template <int A, int J, int K, int M, int L>
__device__ __forceinline__ Routes lane_routes(const Consts<A, J, K, M, L>& c, const Where<A, J, K>& w) {
  Routes r{0u, 0u};
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (c.intro_perc[l] != 0.0f && c.intro_mask[l][w.a] != 0.0f) r.pulse_on |= 1u << l;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      if (c.eta_to[jj][l] == w.j) r.mine |= 1u << (jj * L + l);
    }
  }
  return r;
}

// A warp's exchange slab in shared memory.
template <int A, int L>
struct alignas(16) WarpSlab {
  float rec[32][2 * L];  // per lane: gamma[l] * I of dose q at [l * 2 + q]
  float age[A][L];       // per age: sum_{j,k} I + pulse, per strain
};

// d = f(t, y) for this lane's values; tv holds the time scalars at t; scale is the
// member's per-strain scale.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ __forceinline__ void rhs(Lane<M, L>& d, const Lane<M, L>& y, const LaneTime<L>& tv,
                                    const float (&scale)[L], const Consts<A, J, K, M, L>& c,
                                    const Routes& routes, WarpSlab<A, L>& slab,
                                    const Where<A, J, K>& w) {
  using W = Where<A, J, K>;
  static_assert(L == 2, "the slab and the constant rows hold two strains");
  const int a = w.a, j = w.j;
  const int k1 = w.k0 + 1;
  const float4 ar = *reinterpret_cast<const float4*>(c.age_rates[a]);  // lamc 0, 1; maskpop 0, 1
  const float4 fl = *reinterpret_cast<const float4*>(c.flows);         // sigma 0, 1; gamma 0, 1
  const float lamc[L] = {ar.x, ar.y}, maskpop[L] = {ar.z, ar.w};
  const float sigma[L] = {fl.x, fl.y}, gamma[L] = {fl.z, fl.w};

  // ---- force of infection --------------------------------------------------
  float v[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    v[l] = y.i[0][l] + y.i[1][l];
#pragma unroll
    for (int off = W::kAgeLanes / 2; off >= 1; off >>= 1) v[l] = v[l] + __shfl_xor_sync(kFull, v[l], off);
    if (routes.pulse_on & (1u << l)) v[l] = v[l] + tv.pulse[l] * maskpop[l];
  }
  if (w.lane % W::kAgeLanes == 0) *reinterpret_cast<float2*>(slab.age[a]) = make_float2(v[0], v[1]);
  __syncwarp();
  const float4 ages01 = *reinterpret_cast<const float4*>(&slab.age[0][0]);  // age 0 l 0, 1; age 1 l 0, 1
  const float4 ages23 = *reinterpret_cast<const float4*>(&slab.age[2][0]);
  const float4 crow = *reinterpret_cast<const float4*>(c.contact[a]);
  float lam[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float sum0 = l == 0 ? ages01.x : ages01.y;
    const float sum1 = l == 0 ? ages01.z : ages01.w;
    const float sum2 = l == 0 ? ages23.x : ages23.y;
    const float sum3 = l == 0 ? ages23.z : ages23.w;
    float mixed = crow.x * sum0;
    mixed = mixed + crow.y * sum1;
    mixed = mixed + crow.z * sum2;
    mixed = mixed + crow.w * sum3;
    lam[l] = ((lamc[l] * tv.season) * scale[l]) * mixed;
  }

  // ---- S: infection out; E/I/C: the exposure chain ---------------------------
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = w.k0 + q;
    float esc[L][M];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 row = *reinterpret_cast<const float4*>(c.escape[l][j][k]);
      esc[l][0] = row.x;
      esc[l][1] = row.y;
      esc[l][2] = row.z;
      esc[l][3] = row.w;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float coeff = esc[0][m] * lam[0];
#pragma unroll
      for (int l = 1; l < L; ++l) coeff = coeff + esc[l][m] * lam[l];
      d.s[q][m] = -coeff * y.s[q][m];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float acc = esc[l][0] * y.s[q][0];
#pragma unroll
      for (int m = 1; m < M; ++m) acc = acc + esc[l][m] * y.s[q][m];
      const float ne = lam[l] * acc;
      d.e[q][l] = ne - sigma[l] * y.e[q][l];
      d.c[q][l] = ne;
      d.i[q][l] = sigma[l] * y.e[q][l] - gamma[l] * y.i[q][l];
    }
  }

  // ---- recovery into immune history eta_to[j'][l], waning bin 0 -------------
  *reinterpret_cast<float4*>(slab.rec[w.lane]) =
      make_float4(gamma[0] * y.i[0][0], gamma[0] * y.i[1][0], gamma[1] * y.i[0][1],
                  gamma[1] * y.i[1][1]);
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (routes.mine & (1u << (jj * L + l))) {
        const float2 rec = *reinterpret_cast<const float2*>(&slab.rec[a * W::kAgeLanes + jj * W::KP + w.kp][2 * l]);
        d.s[0][0] = d.s[0][0] + rec.x;
        d.s[1][0] = d.s[1][0] + rec.y;
      }
    }
  }

  // ---- vaccination uptake (saturated per dose tier) ---------------------------
  float rate[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float sv = y.s[q][0];
#pragma unroll
    for (int m = 1; m < M; ++m) sv = sv + y.s[q][m];
#pragma unroll
    for (int off = W::kAgeLanes / 2; off >= W::KP; off >>= 1) sv = sv + __shfl_xor_sync(kFull, sv, off);
    rate[q] = fminf((tv.nu[q] * c.pop[a]) / fmaxf(sv, 1e-8f), 1.0f);
  }
  float out[2][M];
  float sum_out[2];  // sum over m of a lower tier's outflow
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int m = 0; m < M; ++m) out[q][m] = rate[q] * y.s[q][m];
    sum_out[q] = out[q][0];
#pragma unroll
    for (int m = 1; m < M; ++m) sum_out[q] = sum_out[q] + out[q][m];
  }
  // dose k0 - 1 is the other lane's second dose (lane kp - 1)
  const float inflow_k0 = __shfl_xor_sync(kFull, sum_out[1], 1);
  if (w.k0 >= 1) d.s[0][0] = d.s[0][0] + inflow_k0;
#pragma unroll
  for (int m = 0; m < M; ++m) d.s[0][m] = d.s[0][m] - out[0][m];  // k0 < K - 1
  d.s[1][0] = d.s[1][0] + sum_out[0];
  if (k1 < K - 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) d.s[1][m] = d.s[1][m] - out[1][m];
  } else {
    // top tier: boosting recycles the waned (m > 0) back to m = 0
    float top = out[1][1];
#pragma unroll
    for (int m = 2; m < M; ++m) top = top + out[1][m];
#pragma unroll
    for (int m = 1; m < M; ++m) d.s[1][m] = d.s[1][m] - out[1][m];
    d.s[1][0] = d.s[1][0] + top;
  }

  // ---- seasonal vaccination reset (top tier -> previous tier) ---------------
  if (SEASONAL && k1 == K - 1) {
    const float phi = tv.phi;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float shift = phi * y.s[1][m];
      d.s[0][m] = d.s[0][m] + shift;
      d.s[1][m] = d.s[1][m] - shift;
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float se = phi * y.e[1][l];
      d.e[0][l] = d.e[0][l] + se;
      d.e[1][l] = d.e[1][l] - se;
      const float si = phi * y.i[1][l];
      d.i[0][l] = d.i[0][l] + si;
      d.i[1][l] = d.i[1][l] - si;
    }
  }

  // ---- waning chain m -> m + 1 ---------------------------------------------
  const float4 om = *reinterpret_cast<const float4*>(c.omega);
  const float omega[M] = {om.x, om.y, om.z, om.w};
#pragma unroll
  for (int m = 0; m + 1 < M; ++m) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float wn = omega[m] * y.s[q][m];
      d.s[q][m] = d.s[q][m] - wn;
      d.s[q][m + 1] = d.s[q][m + 1] + wn;
    }
  }
}

// ---- saves --------------------------------------------------------------------------

// Saved compartments (nullptr where not saved), their type and layout.
struct Outs {
  void* p[4];  // S, E, I, C
  int bf16;
  int packed;
};

// Where member g sits along the member axis: g itself, or the JAX kernel's tile
// layout (g = blk * 1024 + sub * 128 + lane -> sub * (B / 8) + blk * 128 + lane).
__device__ __forceinline__ size_t member_pos(int g, int batch, int packed) {
  if (!packed) return static_cast<size_t>(g);
  return static_cast<size_t>((g & 1023) >> 7) * static_cast<size_t>(batch >> 3) +
         static_cast<size_t>(g >> 10) * 128 + static_cast<size_t>(g & 127);
}

__device__ __forceinline__ void store(void* base, size_t off, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(base)[off] = v;
  }
}

// Write this lane's values of save slot `slot`; NaN instead when !reached.
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void save_lane(const Outs& o, const Lane<M, L>& y, int slot, size_t pos,
                                          int batch, const Where<A, J, K>& w, bool reached) {
  constexpr size_t NS = static_cast<size_t>(A) * J * K * M;
  constexpr size_t NE = static_cast<size_t>(A) * J * K * L;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t cell = static_cast<size_t>((w.a * J + w.j) * K + w.k0 + q);
    if (o.p[0]) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        store(o.p[0], ((slot * NS) + cell * M + m) * batch + pos, reached ? y.s[q][m] : nan, o.bf16);
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const size_t off = ((slot * NE) + cell * L + l) * batch + pos;
      if (o.p[1]) store(o.p[1], off, reached ? y.e[q][l] : nan, o.bf16);
      if (o.p[2]) store(o.p[2], off, reached ? y.i[q][l] : nan, o.bf16);
      if (o.p[3]) store(o.p[3], off, reached ? y.c[q][l] : nan, o.bf16);
    }
  }
}

// This lane's values of the shared initial state (S, E, I, C flattened in order).
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ void load_y0(Lane<M, L>& y, const float* __restrict__ y0,
                                        const Where<A, J, K>& w) {
  constexpr int NS = A * J * K * M;
  constexpr int NE = A * J * K * L;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int cell = (w.a * J + w.j) * K + w.k0 + q;
#pragma unroll
    for (int m = 0; m < M; ++m) y.s[q][m] = __ldg(y0 + cell * M + m);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      y.e[q][l] = __ldg(y0 + NS + cell * L + l);
      y.i[q][l] = __ldg(y0 + NS + NE + cell * L + l);
      y.c[q][l] = __ldg(y0 + NS + 2 * NE + cell * L + l);
    }
  }
}

}  // namespace dynode_seip
