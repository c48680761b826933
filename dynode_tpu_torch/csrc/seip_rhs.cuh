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
// recycling and the seasonal reset 3 -> 2. What crosses lanes (__shfl_sync):
//   * sum_{j,k} I per (a, l): a xor butterfly over the age's 8 lanes (offsets 4, 2, 1);
//   * the contact mixing: each age's sum is read from its first lane;
//   * sum_{j,m} S per (a, k): the lane's own m in order, then xor over j (4, 2);
//   * the dose move 1 -> 2 (lane kp = 0 to kp = 1, xor 1);
//   * recovery into history eta_to[j][l] at m = 0: J * L reads per dose.
// A butterfly with descending offsets adds v[i] + v[i + n/2] first; ops/seip.py's
// _halves takes the same order.
//
// The constants (contact, float(beta[l] / pop[a]), mask * pop, the escape table formed
// in float64 on the host, ...) arrive as float64 from the host and are rounded once,
// as the JAX kernel rounds its Python-float closure constants; the kernels copy them
// to shared memory at start, since most are read at a lane-dependent index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace dynode_seip {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxKnots = 4;  // spline knots per (age, dose); more is refused by the host
constexpr float kTwoPi = static_cast<float>(6.283185307179586);  // float(2 * math.pi)

template <int A, int J, int K, int M, int L>
struct Consts {
  float contact[A][A];
  float lamc[L][A];  // float(beta[l] / pop[a])
  float sigma[L];
  float gamma[L];
  float pop[A];
  float season_amp, season_peak, tau;
  float intro_time[L], intro_scale[L], intro_perc[L], intro_norm[L];
  float intro_mask[L][A];
  float maskpop[L][A];  // float(mask[l, a] * pop[a])
  float vax_base[A][K][4];
  float vax_knots[A][K][kMaxKnots];
  float vax_kcoef[A][K][kMaxKnots];
  float omega[M];
  float escape[L][J][K][M];
  int eta_to[J][L];
  int n_knots;
};

// The host's float64 constants, in the order of ops/seip.py::kernel_constants.
template <int A, int J, int K, int M, int L>
Consts<A, J, K, M, L> read_consts(const double* h, int n_knots) {
  Consts<A, J, K, M, L> c{};
  auto take = [&h](float* dst, int n) {
    for (int i = 0; i < n; ++i) dst[i] = static_cast<float>(*h++);
  };
  take(&c.contact[0][0], A * A);
  take(&c.lamc[0][0], L * A);
  take(c.sigma, L);
  take(c.gamma, L);
  take(c.pop, A);
  take(&c.season_amp, 1);
  take(&c.season_peak, 1);
  take(&c.tau, 1);
  take(c.intro_time, L);
  take(c.intro_scale, L);
  take(c.intro_perc, L);
  take(c.intro_norm, L);
  take(&c.intro_mask[0][0], L * A);
  take(&c.maskpop[0][0], L * A);
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

// x ** y by the square-and-multiply chain of jax.lax.integer_pow
__device__ __forceinline__ float integer_pow(float x, int y) {
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

// The clipped uptake spline of (a, k) at day t (_spline_scalar, then max(., 0)).
template <int A, int J, int K, int M, int L>
__device__ __forceinline__ float uptake(const Consts<A, J, K, M, L>& c, float t, int a, int k) {
  const float* b = c.vax_base[a][k];
  float v = b[0] + b[1] * t + b[2] * t * t + b[3] * t * t * t;
  for (int i = 0; i < c.n_knots; ++i) {
    const float d = t - c.vax_knots[a][k][i];
    v = v + c.vax_kcoef[a][k][i] * (d > 0.0f ? d * d * d : 0.0f);
  }
  return fmaxf(v, 0.0f);
}

// d = f(t, y) for this lane's values; scale is the member's per-strain scale.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ __forceinline__ void rhs(Lane<M, L>& d, const Lane<M, L>& y, float t,
                                    const float (&scale)[L], const Consts<A, J, K, M, L>& c,
                                    const Where<A, J, K>& w) {
  using W = Where<A, J, K>;
  const int a = w.a, j = w.j;
  const int k1 = w.k0 + 1;

  // ---- time scalars --------------------------------------------------------
  const float season = 1.0f + c.season_amp * cosf(kTwoPi * (t - c.season_peak) / 365.0f);
  float nu[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) nu[q] = uptake(c, t, a, w.k0 + q);

  // ---- force of infection --------------------------------------------------
  float lam[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float v = y.i[0][l] + y.i[1][l];
#pragma unroll
    for (int off = W::kAgeLanes / 2; off >= 1; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
    if (c.intro_perc[l] != 0.0f && c.intro_mask[l][a] != 0.0f) {
      const float z = (t - c.intro_time[l]) / c.intro_scale[l];
      const float pulse = c.intro_perc[l] * expf(-0.5f * z * z) / c.intro_norm[l];
      v = v + pulse * c.maskpop[l][a];
    }
    float mixed = 0.0f;
#pragma unroll
    for (int b = 0; b < A; ++b) {
      const float term = c.contact[a][b] * __shfl_sync(kFull, v, b * W::kAgeLanes);
      mixed = b == 0 ? term : mixed + term;
    }
    lam[l] = ((c.lamc[l][a] * season) * scale[l]) * mixed;
  }

  // ---- S: infection out; E/I/C: the exposure chain ---------------------------
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = w.k0 + q;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float coeff = c.escape[0][j][k][m] * lam[0];
#pragma unroll
      for (int l = 1; l < L; ++l) coeff = coeff + c.escape[l][j][k][m] * lam[l];
      d.s[q][m] = -coeff * y.s[q][m];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float acc = c.escape[l][j][k][0] * y.s[q][0];
#pragma unroll
      for (int m = 1; m < M; ++m) acc = acc + c.escape[l][j][k][m] * y.s[q][m];
      const float ne = lam[l] * acc;
      d.e[q][l] = ne - c.sigma[l] * y.e[q][l];
      d.c[q][l] = ne;
      d.i[q][l] = c.sigma[l] * y.e[q][l] - c.gamma[l] * y.i[q][l];
    }
  }

  // ---- recovery into immune history eta_to[j'][l], waning bin 0 -------------
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int src = a * W::kAgeLanes + jj * W::KP + w.kp;
      const bool mine = c.eta_to[jj][l] == j;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float rec = __shfl_sync(kFull, c.gamma[l] * y.i[q][l], src);
        if (mine) d.s[q][0] = d.s[q][0] + rec;
      }
    }
  }

  // ---- vaccination uptake (saturated per dose tier) ---------------------------
  float rate[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float v = y.s[q][0];
#pragma unroll
    for (int m = 1; m < M; ++m) v = v + y.s[q][m];
#pragma unroll
    for (int off = W::kAgeLanes / 2; off >= W::KP; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
    rate[q] = fminf((nu[q] * c.pop[a]) / fmaxf(v, 1e-8f), 1.0f);
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
  if (SEASONAL) {
    const float phi = integer_pow(sinf(kTwoPi * (t + c.tau) / 730.0f), 1000);
    if (k1 == K - 1) {
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
  }

  // ---- waning chain m -> m + 1 ---------------------------------------------
#pragma unroll
  for (int m = 0; m + 1 < M; ++m) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float wn = c.omega[m] * y.s[q][m];
      d.s[q][m] = d.s[q][m] - wn;
      d.s[q][m + 1] = d.s[q][m + 1] + wn;
    }
  }
}

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
