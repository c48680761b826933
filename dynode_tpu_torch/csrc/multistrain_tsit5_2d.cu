// Constant-step Tsit5 of the multi-strain SEIRS ensemble on the aligned 2-D
// layout, eight lanes per member.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/multistrain_pallas.py::_solve_kernel_2d
// (launched by _solve_pallas_2d, entry ensemble_solve_tsit5_2d). It computes what that
// kernel computes -- n_steps Tsit5 steps of the multi-strain SEIRS on the aligned
// (D2, B) state (each of the s | e | i | r | c groups padded to 8 rows), with the
// per-(age, strain)-row rates of pack_rates_2d, saving all D2 rows every save_stride
// steps with zero padding rows -- in the expression order of _rhs_2d and
// _tsit5_step_2d (ops/multistrain.py, the plain version).
//
// The TPU variant spread the model's structure over the vector unit's sublanes. On
// Hopper the counterpart is to spread it over lanes:
//
// * Each member owns a group of 8 consecutive lanes of a warp (4 members per warp),
//   one (age, strain) pair per lane: lane p < A*K holds e, i, r and c of pair p and
//   s of its age; lanes past A*K (2 of 8 at (2, 3) and (3, 2)) shadow the last pair
//   and store only zero padding rows.
// * The three cross-pair terms of the RHS are __shfl_sync exchanges inside the
//   8-lane group: the per-age population sum s_a + sum_k (e + i + r)[a, k], the
//   contact mixing sum_b C[a][b] * (i / N)[b, k], and ds_a = sum_k (r_out - new_inf).
//   Every lane of an age adds the same values in the same order, so the copies of
//   s_a stay identical.
// * A lane's live set is 5 state floats, 6 stage vectors of 5 and its 4 rates and A
//   contact weights: a few dozen registers where the one-member-per-thread kernel
//   (multistrain_tsit5.cu) holds 213, and 8x as many threads, which fills the card at
//   the main path's B = 9,984 where that kernel fills 78 blocks on 132 SMs.
// * What bounds it on the H100: float32 operations, 6.8 GFLOP against 0.32 GB of
//   saves at B = 9,984 (a bound of 0.10 ms by operations), but it runs at about 17% of
//   that: each RHS is 8 shuffles at (2, 3) and a division on a dependent chain, and
//   every lane repeats its age's population sum. Timed in turns with the
//   one-member-per-thread kernel in one run, it measured 0.618 ms (median) against
//   0.599 ms (PERF.md): level within the spread, so spreading the structure over lanes
//   did not pay here, as spreading it over sublanes did not on the TPU. The save grid
//   (40 rows per member per day) is written once, lane p storing row p of each group,
//   so a warp's store covers 8 rows x 16 bytes.
// * The ragged last warp is masked: groups past the batch shadow the last member
//   (every lane of a warp takes part in each shuffle) and store nothing. There is
//   no batch % block constraint.
// * The Tsit5 weights are the generated dynode_tableaus.cuh values; as in the JAX
//   _tsit5_step_2d, each enters as float(dt * a) with the product taken in double,
//   computed once on the host and passed by value in the kernel's parameter space.

#include <cuda_runtime.h>

#include <cstddef>

#include "dynode_tableaus.cuh"

namespace {

constexpr int kLanes = 8;  // lanes per member
// Threads per block (16 members): the width kernel #2's sweep chose; not swept
// for this kernel.
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Weights {
  float a[dynode::kTsit5Stages][dynode::kTsit5Stages];  // float(dt * a(s, j))
  float b[dynode::kTsit5Stages];                        // float(dt * b(j))
};

constexpr int blk8(int n) { return (n + 7) / 8 * 8; }

template <int A, int K>
struct Layout {
  static constexpr int AK = A * K;
  static constexpr int SA = blk8(A);
  static constexpr int SAK = blk8(AK);
  static constexpr int OE = SA, OI = SA + SAK, OR = SA + 2 * SAK, OC = SA + 3 * SAK;
  static constexpr int D2 = SA + 4 * SAK;
  static_assert(AK <= kLanes && SA == kLanes && SAK == kLanes,
                "one (age, strain) pair per lane of an 8-lane group");
};

// The five values of one lane: s of its age, e / i / r / c of its pair.
struct Lane {
  float s, e, i, r, c;
};

__device__ __forceinline__ float group_lane(float v, int src) {
  return __shfl_sync(kFull, v, src, kLanes);
}

// d/dt of the lane's values (_rhs_2d): age a, strain k of this lane's pair.
template <int A, int K>
__device__ __forceinline__ Lane rhs_2d(const Lane& y, const float (&crow)[A], float beta,
                                       float sigma, float gamma, float omega, int a, int k) {
  const float eir = y.e + y.i + y.r;
  float pop = group_lane(eir, a * K);
#pragma unroll
  for (int kk = 1; kk < K; ++kk) pop = pop + group_lane(eir, a * K + kk);
  const float inv_n = 1.0f / (y.s + pop);
  const float i_on = y.i * inv_n;
  float mixed = crow[0] * group_lane(i_on, k);
#pragma unroll
  for (int b = 1; b < A; ++b) mixed = mixed + crow[b] * group_lane(i_on, b * K + k);
  const float new_inf = beta * mixed * y.s;
  const float e_out = sigma * y.e;
  const float i_out = gamma * y.i;
  const float r_out = omega * y.r;
  const float net = r_out - new_inf;
  float ds = group_lane(net, a * K);
#pragma unroll
  for (int kk = 1; kk < K; ++kk) ds = ds + group_lane(net, a * K + kk);
  return Lane{ds, new_inf - e_out, e_out - i_out, i_out - r_out, new_inf};
}

__device__ __forceinline__ Lane axpy(const Lane& y, float w, const Lane& k) {
  return Lane{y.s + w * k.s, y.e + w * k.e, y.i + w * k.i, y.r + w * k.r, y.c + w * k.c};
}

// Lane p stores row p of each group: s of age p (zero past A), its own pair's
// e / i / r / c (zero past A*K).
template <int A, int K>
__device__ __forceinline__ void save(float* __restrict__ out, const Lane& y, int slot,
                                     int member, int batch, int lane, bool live) {
  using L = Layout<A, K>;
  const float s_row = group_lane(y.s, lane < A ? lane * K : 0);
  if (!live) return;
  const bool pair = lane < L::AK;
  float* base = out + (static_cast<size_t>(slot) * L::D2 + lane) * batch + member;
  const size_t group = static_cast<size_t>(kLanes) * batch;
  base[0] = lane < A ? s_row : 0.0f;
  base[1 * group] = pair ? y.e : 0.0f;
  base[2 * group] = pair ? y.i : 0.0f;
  base[3 * group] = pair ? y.r : 0.0f;
  base[4 * group] = pair ? y.c : 0.0f;
}

template <int A, int K>
__global__ void __launch_bounds__(kThreads)
multistrain_tsit5_2d_kernel(const float* __restrict__ y0, const float* __restrict__ rates,
                            const float* __restrict__ contact, float* __restrict__ out,
                            int batch, Weights w, int n_steps, int save_stride) {
  using L = Layout<A, K>;
  constexpr int S = dynode::kTsit5Stages;
  const int lane = threadIdx.x % kLanes;
  const long long group = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const bool live = group < batch;
  const int member = live ? static_cast<int>(group) : batch - 1;
  const int pair = lane < L::AK ? lane : L::AK - 1;
  const int a = pair / K;
  const int k = pair % K;

  float crow[A];
#pragma unroll
  for (int b = 0; b < A; ++b) crow[b] = __ldg(contact + a * A + b);
  const auto row = [&](const float* base, int r) {
    return __ldg(base + static_cast<size_t>(r) * batch + member);
  };
  const float beta = row(rates, pair);
  const float sigma = row(rates, L::SAK + pair);
  const float gamma = row(rates, 2 * L::SAK + pair);
  const float omega = row(rates, 3 * L::SAK + pair);
  Lane y{row(y0, a), row(y0, L::OE + pair), row(y0, L::OI + pair), row(y0, L::OR + pair),
         row(y0, L::OC + pair)};
  save<A, K>(out, y, 0, member, batch, lane, live);

  Lane ks[S];
#pragma unroll 1
  for (int step = 1; step <= n_steps; ++step) {
    ks[0] = rhs_2d<A, K>(y, crow, beta, sigma, gamma, omega, a, k);
#pragma unroll
    for (int s = 1; s < S; ++s) {
      Lane ys = y;
#pragma unroll
      for (int j = 0; j < s; ++j) {
        if (dynode::tsit5_a(s, j) != 0.0) ys = axpy(ys, w.a[s][j], ks[j]);
      }
      ks[s] = rhs_2d<A, K>(ys, crow, beta, sigma, gamma, omega, a, k);
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (dynode::tsit5_b(j) != 0.0) y = axpy(y, w.b[j], ks[j]);
    }
    if (step % save_stride == 0) save<A, K>(out, y, step / save_stride, member, batch, lane, live);
  }
}

template <int A, int K>
cudaError_t launch(const float* y0, const float* rates, const float* contact, float* out,
                   int batch, const Weights& w, int n_steps, int save_stride,
                   cudaStream_t stream) {
  const long long threads = static_cast<long long>(batch) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  multistrain_tsit5_2d_kernel<A, K><<<blocks, kThreads, 0, stream>>>(
      y0, rates, contact, out, batch, w, n_steps, save_stride);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Shapes instantiated: (A, K) = (2, 3) and (3, 2); any other shape
// returns cudaErrorInvalidValue (the Python wrapper rejects it first).
// y0: (D2, B) f32, rates: (4 * 8, B) f32, contact: (A*A,) f32, out: (n_saves, D2, B)
// f32, all contiguous on the current device; dt in double, as the JAX kernel forms
// dt * a in double. Returns cudaGetLastError() after the launch.
extern "C" int dynode_multistrain_tsit5_2d(int n_age, int n_strain, const float* y0,
                                           const float* rates, const float* contact,
                                           float* out, int batch, double dt, int n_steps,
                                           int save_stride, void* stream) {
  Weights w{};
  for (int s = 0; s < dynode::kTsit5Stages; ++s) {
    for (int j = 0; j < dynode::kTsit5Stages; ++j) {
      w.a[s][j] = static_cast<float>(dt * dynode::tsit5_a(s, j));
    }
    w.b[s] = static_cast<float>(dt * dynode::tsit5_b(s));
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_age == 2 && n_strain == 3) {
    return launch<2, 3>(y0, rates, contact, out, batch, w, n_steps, save_stride, st);
  }
  if (n_age == 3 && n_strain == 2) {
    return launch<3, 2>(y0, rates, contact, out, batch, w, n_steps, save_stride, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
