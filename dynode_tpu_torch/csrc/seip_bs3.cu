// Adaptive lockstep Bogacki-Shampine 3(2) of the SEIP ensemble: one warp per member,
// one CTA of BLOCK_B warps per lockstep block.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/seip_pallas.py::_seip_kernel_adaptive
// (launched by _solve_adaptive, entry seip_ensemble_solve_adaptive), with the
// semantics of seip_pallas.py:577-823: the block shares one (t, dt); every attempt
// runs BS3's stages with the RHS of seip_rhs.cuh; the block's error norm is the max
// over its members of each member's scaled RMS error; the step factor is
// clip(0.9 * exp(log(norm) * (-1/3)), 0.2, 10); dt is clamped to land exactly on each
// save point and an accepted clamped step keeps its dt; an interval gets
// steps_per_save attempts (the first max(4 * steps_per_save, 32)), and a block that
// runs out saves NaN for it and counts it; eps = 1e-6 * max(save_every, 1). FSAL:
// the last stage f(t + dt, y_new) stays in registers and is the next attempt's first
// stage after an accept; after a reject (kv false) it is recomputed.
//
// The plain version (ops/seip.py::seip_solve_adaptive_reference) takes the same
// decisions only if both round alike, and a decision is a discontinuous function of
// rounding: this source is compiled with -fmad=false and IEEE division and square
// root (ops/_build.py's per-source flags), and the member norm is summed as the plain
// version sums it (a lane's 20 values in order, then a xor butterfly 16, 8, 4, 2, 1).
// fmaxf drops a NaN, so a not-finite member norm travels as its own flag.
//
// Design. The TPU kernel stepped 1,024 members in lockstep per grid step, with five
// state groups of the tile in VMEM. Here a member is a warp and its five groups (y,
// stage input, stage derivative, candidate, error) are 100 registers a lane; a block
// is BLOCK_B warps (at most 32 in a CTA, so the TPU's 1,024-member block cannot be one
// CTA; the lockstep block is narrower: 4, 8 or 16 warps, 4 by default, which a
// chip_sweep.py sweep found fastest). The
// block max is two steps: a warp reduction for each member's sum of squares, then a
// shared-memory reduction over the block's warps after one barrier (double-buffered,
// so one barrier per attempt is enough); every thread then takes the same scalar
// (t, dt) decision. Warps past the batch shadow the last member, join every barrier
// and shuffle, and are left out of the max and the saves.
//
// Time scalars: the block shares (t, h), so the attempt's four stage times t,
// t + h/2, t + 3h/4 and t + h are known when it starts. Each warp computes their time
// rows in one pass at the start of the attempt -- a lane takes nu(a, k) of two
// stages, lanes 0-15 one head value (season, a pulse or phi) of one stage -- into
// its own shared slot, then __syncwarp; no RHS call computes one. Saves go straight
// from a lane's registers: only C is saved on the main path.
//
// What bounds it on the H100: float32 operations, counted by chip_smoke.py from the
// attempt statistics (three RHS per attempt, one more after each rejection, about
// 5.4k operations each per member, and the time scalars once per block).

#include <cuda_runtime.h>

#include "seip_rhs.cuh"

namespace {

using namespace dynode_seip;

template <int M, int L>
__device__ __forceinline__ float lane_sq(const Lane<M, L>& er, const Lane<M, L>& y,
                                         const Lane<M, L>& yn, float atol, float rtol) {
  float sq = 0.0f;
  bool first = true;
  auto add = [&](float e, float a, float b) {
    const float r = e / (atol + rtol * fmaxf(fabsf(a), fabsf(b)));
    sq = first ? r * r : sq + r * r;
    first = false;
  };
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int m = 0; m < M; ++m) add(er.s[q][m], y.s[q][m], yn.s[q][m]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.e[q][l], y.e[q][l], yn.e[q][l]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.i[q][l], y.i[q][l], yn.i[q][l]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.c[q][l], y.c[q][l], yn.c[q][l]);
  }
  return sq;
}

// The time rows of the attempt's stage times t0 .. t3 into this warp's slot: lane
// computes nu(a, k) = row value kHead + (lane & 15) of stages lane / 16 and lane / 16 + 2,
// lanes 0-15 also head value lane & 3 of stage lane / 4; then the warp synchronises.
template <int A, int J, int K, int M, int L, bool SEASONAL>
__device__ __forceinline__ void time_rows(const Consts<A, J, K, M, L>& c, float t0, float t1,
                                          float t2, float t3, float (*tr)[TimeLayout<A, K, L>::kRow],
                                          int lane) {
  using T = TimeLayout<A, K, L>;
  static_assert(A * K == 16 && T::kHead == 4, "a half warp per stage's nu, a quarter warp per head");
  const int hi = lane >> 4, i = T::kHead + (lane & 15);
  tr[hi][i] = time_value<A, J, K, M, L, SEASONAL>(c, hi ? t1 : t0, i);
  tr[hi + 2][i] = time_value<A, J, K, M, L, SEASONAL>(c, hi ? t3 : t2, i);
  if (lane < 16) {
    const int s = lane >> 2;
    const float ts = s == 0 ? t0 : (s == 1 ? t1 : (s == 2 ? t2 : t3));
    tr[s][lane & 3] = time_value<A, J, K, M, L, SEASONAL>(c, ts, lane & 3);
  }
  __syncwarp();
}

// __launch_bounds__ asks for 16 warps per SM at every width: at most 128 registers a
// thread. Without the CTA count ptxas takes 168 registers at block_b 4 (12 warps per
// SM, no spill), and 20 or 24 warps per SM cap it at 96 or 80 (244 or 436 bytes of
// spill stores): all three ran slower (chip_smoke.py prints the registers and spills).
template <int A, int J, int K, int M, int L, bool SEASONAL, int BLOCK_B>
__global__ void __launch_bounds__(32 * BLOCK_B, 16 / BLOCK_B)
seip_bs3_kernel(const __grid_constant__ Consts<A, J, K, M, L> cp, const float* __restrict__ y0,
                const float* __restrict__ scales, Outs outs, int* __restrict__ flags, int batch,
                int n_saves, float save_every, float eps, float atol, float rtol, float dt0,
                int steps_per_save) {
  using T = TimeLayout<A, K, L>;
  __shared__ Consts<A, J, K, M, L> c;
  __shared__ WarpSlab<A, L> slabs[BLOCK_B];
  __shared__ __align__(16) float rows[BLOCK_B][4][T::kRow];  // the attempt's four time rows
  __shared__ float norms[2][BLOCK_B];
  __shared__ int not_finite[2][BLOCK_B];
  load_consts(c, cp);
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int g = blockIdx.x * BLOCK_B + warp;
  const bool live = g < batch;
  const int member = live ? g : batch - 1;
  const Where<A, J, K> w(static_cast<int>(threadIdx.x % 32));
  const Routes routes = lane_routes(c, w);
  WarpSlab<A, L>& slab = slabs[warp];
  float(*tr)[T::kRow] = rows[warp];
  const size_t pos = member_pos(member, batch, outs.packed);
  float scale[L];
#pragma unroll
  for (int l = 0; l < L; ++l) scale[l] = __ldg(scales + static_cast<size_t>(l) * batch + member);
  constexpr float inv_n = static_cast<float>(1.0 / (A * J * K * (M + 3 * L)));
  const float c29 = static_cast<float>(2.0 / 9.0);
  const float c572 = static_cast<float>(5.0 / 72.0);
  const float c49 = static_cast<float>(4.0 / 9.0);
  const float expo = static_cast<float>(-1.0 / 3.0);

  Lane<M, L> y, k, st, ac, er;
  load_y0(y, y0, w);
  if (live) save_lane(outs, y, 0, pos, batch, w, true);
  float t = 0.0f, dt = dt0;
  bool kv = false;  // k holds f(t, y) (the last accepted attempt's final stage)
  int n_acc = 0, n_rej = 0, n_bad = 0, buf = 0;
  const int k_first = max(4 * steps_per_save, 32);
#pragma unroll 1
  for (int s = 1; s < n_saves; ++s) {
    const float s_end = static_cast<float>(s) * save_every;
    const int budget = s == 1 ? k_first : steps_per_save;
#pragma unroll 1
    for (int attempt = 0; attempt < budget; ++attempt) {
      const float remaining = s_end - t;
      if (!(remaining > eps)) break;
      const float h = fminf(dt, remaining);
      const bool landing = h >= remaining - eps;
      const float h05 = 0.5f * h, h075 = 0.75f * h;
      time_rows<A, J, K, M, L, SEASONAL>(c, t, t + h05, t + h075, t + h, tr, w.lane);
      if (!kv) rhs<A, J, K, M, L, SEASONAL>(k, y, lane_time<A, J, K, L>(tr[0], w), scale, c, routes, slab, w);
      axpy(ac, y, h * c29, k);
      scaled(er, h * c572, k);
      axpy(st, y, h05, k);
      rhs<A, J, K, M, L, SEASONAL>(k, st, lane_time<A, J, K, L>(tr[1], w), scale, c, routes, slab, w);
      axpy(ac, ac, h / 3.0f, k);
      axpy(er, er, -(h / 12.0f), k);
      axpy(st, y, h075, k);
      rhs<A, J, K, M, L, SEASONAL>(k, st, lane_time<A, J, K, L>(tr[2], w), scale, c, routes, slab, w);
      axpy(ac, ac, h * c49, k);
      axpy(er, er, -(h / 9.0f), k);
      rhs<A, J, K, M, L, SEASONAL>(k, ac, lane_time<A, J, K, L>(tr[3], w), scale, c, routes, slab, w);
      axpy(er, er, h / 8.0f, k);

      float sq = lane_sq(er, y, ac, atol, rtol);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sq = sq + __shfl_xor_sync(kFull, sq, off);
      const float member_norm = sqrtf(sq * inv_n);
      if (w.lane == 0) {
        norms[buf][warp] = live ? member_norm : 0.0f;
        not_finite[buf][warp] = live && !isfinite(member_norm);
      }
      __syncthreads();
      float norm = 0.0f;
      int bad = 0;
#pragma unroll
      for (int i = 0; i < BLOCK_B; ++i) {
        norm = fmaxf(norm, norms[buf][i]);
        bad |= not_finite[buf][i];
      }
      buf ^= 1;
      const bool ok = !bad;
      float factor = 0.2f;
      if (ok) {
        const float safe = fmaxf(norm, 1e-30f);
        factor = fminf(fmaxf(0.9f * expf(logf(safe) * expo), 0.2f), 10.0f);
      }
      const bool good = ok && norm <= 1.0f;
      dt = (landing && good) ? dt : h * factor;
      if (good) {
        y = ac;
        t = landing ? s_end : t + h;
        ++n_acc;
      } else {
        ++n_rej;
      }
      kv = good;
    }
    const bool reached = t >= s_end - eps;
    n_bad += reached ? 0 : 1;
    if (live) save_lane(outs, y, s, pos, batch, w, reached);
  }
  if (threadIdx.x == 0) {
    flags[3 * blockIdx.x + 0] = n_bad;
    flags[3 * blockIdx.x + 1] = n_acc;
    flags[3 * blockIdx.x + 2] = n_rej;
  }
}

template <int A, int J, int K, int M, int L, bool SEASONAL, int BLOCK_B>
int launch(const Consts<A, J, K, M, L>& c, const float* y0, const float* scales, Outs outs,
           int* flags, int batch, int n_saves, double save_every, double rtol, double atol,
           double dt0, int steps_per_save, cudaStream_t stream) {
  const int blocks = (batch + BLOCK_B - 1) / BLOCK_B;
  const double eps = 1e-6 * (save_every > 1.0 ? save_every : 1.0);
  seip_bs3_kernel<A, J, K, M, L, SEASONAL, BLOCK_B><<<blocks, 32 * BLOCK_B, 0, stream>>>(
      c, y0, scales, outs, flags, batch, n_saves, static_cast<float>(save_every),
      static_cast<float>(eps), static_cast<float>(atol), static_cast<float>(rtol),
      static_cast<float>(dt0), steps_per_save);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. Instantiated for (A, J, K, M, L, seasonal) = (4, 4, 4, 4, 2, 1) and
// block_b in 4, 8, 16 (warps per CTA); anything else, or more than kMaxKnots
// spline knots, returns cudaErrorInvalidValue (the Python wrapper rejects it first).
// Arguments as dynode_seip_rk4, plus flags: (ceil(B / block_b), 3) int32 exhausted /
// accepted / rejected per block. Returns cudaGetLastError() after the launch.
extern "C" int dynode_seip_bs3(int A, int J, int K, int M, int L, int seasonal, int n_knots,
                               const double* consts, const float* y0, const float* scales,
                               void* out_s, void* out_e, void* out_i, void* out_c, int* flags,
                               int bf16, int packed, int batch, int block_b, int n_saves,
                               double save_every, double rtol, double atol, double dt0,
                               int steps_per_save, void* stream) {
  if (!production(A, J, K, M, L, seasonal, n_knots)) return static_cast<int>(cudaErrorInvalidValue);
  const Outs outs{{out_s, out_e, out_i, out_c}, bf16, packed};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto c = read_consts<4, 4, 4, 4, 2>(consts, n_knots);
  switch (block_b) {
    case 4:
      return launch<4, 4, 4, 4, 2, true, 4>(c, y0, scales, outs, flags, batch, n_saves, save_every,
                                            rtol, atol, dt0, steps_per_save, st);
    case 8:
      return launch<4, 4, 4, 4, 2, true, 8>(c, y0, scales, outs, flags, batch, n_saves, save_every,
                                            rtol, atol, dt0, steps_per_save, st);
    case 16:
      return launch<4, 4, 4, 4, 2, true, 16>(c, y0, scales, outs, flags, batch, n_saves,
                                             save_every, rtol, atol, dt0, steps_per_save, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
