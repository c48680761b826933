// Constant-step RK4 of the SEIP ensemble, one warp per member.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/seip_pallas.py::_seip_kernel (launched
// by _solve, entry seip_ensemble_solve). It computes what that kernel computes --
// n_steps classic RK4 steps of the 640-float SEIP state of every member, from one
// shared initial state, with per-member per-strain transmission scales, saving the
// selected compartments every save_stride steps -- in the order of
// seip_pallas.py:382-408: step n starts at float(n) * dt; its stages are at t,
// t + float(0.5 dt), t + float(dt); the weights 0.5 dt, dt and dt / 6 are formed in
// double on the host and rounded once. The RHS is seip_rhs.cuh.
//
// What bounds it on the H100: float32 operations. One RHS is about 5.5k operations
// per member and an RK4 step about 28k, so 200 days at dt = 0.5 and B = 32,768 are
// about 3.7e11 operations (5.5 ms at 67 TFLOP/s), against 3.4 GB of C-only float32
// saves (1.0 ms at 3.35 TB/s); chip_smoke.py counts both from the plain version.
//
// Design. The TPU kernel kept a 1,024-member tile of the state and its four RK
// groups resident in VMEM. A thread here has at most 255 registers, so one member per
// thread would spill about 10 KB of live state; a warp per member spreads it over 32
// lanes instead (seip_rhs.cuh): 20 floats per group per lane, 80 for the four groups
// (y, stage input, stage derivative, accumulator), in registers. The cross-lane terms
// of the RHS are warp shuffles. Saves go straight from registers to the output, in
// either the member-last or the JAX tile layout, float32 or bf16, for the selected
// compartments only. Warps past the batch exit at once (there is no block-wide step),
// so any batch works.

#include <cuda_runtime.h>

#include "seip_rhs.cuh"

namespace {

using namespace dynode_seip;

constexpr int kWarps = 4;  // members per CTA

template <int A, int J, int K, int M, int L, bool SEASONAL>
__global__ void __launch_bounds__(32 * kWarps)
seip_rk4_kernel(const __grid_constant__ Consts<A, J, K, M, L> cp, const float* __restrict__ y0,
                const float* __restrict__ scales, Outs outs, int batch, float dtf, float h2,
                float h6, int n_steps, int save_stride) {
  __shared__ Consts<A, J, K, M, L> c;
  load_consts(c, cp);
  const int g = blockIdx.x * kWarps + static_cast<int>(threadIdx.x / 32);
  if (g >= batch) return;
  const Where<A, J, K> w(static_cast<int>(threadIdx.x % 32));
  const size_t pos = member_pos(g, batch, outs.packed);
  float scale[L];
#pragma unroll
  for (int l = 0; l < L; ++l) scale[l] = __ldg(scales + static_cast<size_t>(l) * batch + g);

  Lane<M, L> y, st, k, ac;
  load_y0(y, y0, w);
  save_lane(outs, y, 0, pos, batch, w, true);
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    const float t = static_cast<float>(step) * dtf;
    rhs<A, J, K, M, L, SEASONAL>(k, y, t, scale, c, w);
    ac = k;
    axpy(st, y, h2, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, t + h2, scale, c, w);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, h2, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, t + h2, scale, c, w);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, dtf, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, t + dtf, scale, c, w);
    axpy(ac, ac, 1.0f, k);
    axpy(y, y, h6, ac);
    if ((step + 1) % save_stride == 0) save_lane(outs, y, (step + 1) / save_stride, pos, batch, w, true);
  }
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
int launch(const double* consts, int n_knots, const float* y0, const float* scales, Outs outs,
           int batch, double dt, int n_steps, int save_stride, cudaStream_t stream) {
  const Consts<A, J, K, M, L> c = read_consts<A, J, K, M, L>(consts, n_knots);
  const int blocks = (batch + kWarps - 1) / kWarps;
  seip_rk4_kernel<A, J, K, M, L, SEASONAL><<<blocks, 32 * kWarps, 0, stream>>>(
      c, y0, scales, outs, batch, static_cast<float>(dt), static_cast<float>(0.5 * dt),
      static_cast<float>(dt / 6.0), n_steps, save_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point. Instantiated for (A, J, K, M, L, seasonal) = (4, 4, 4, 4, 2, 1), the
// production configuration; any other shape, or more than kMaxKnots spline knots,
// returns cudaErrorInvalidValue (the Python wrapper rejects them first).
// consts: the host's float64 constants (ops/seip.py::kernel_constants); y0: the
// shared (S, E, I, C) flattened, float32; scales: (L, B) float32; out_*: the saved
// compartments or null, (n_saves, *compartment, B) in bf16 when bf16 != 0, in the
// tile layout when packed != 0. Returns cudaGetLastError() after the launch.
extern "C" int dynode_seip_rk4(int A, int J, int K, int M, int L, int seasonal, int n_knots,
                               const double* consts, const float* y0, const float* scales,
                               void* out_s, void* out_e, void* out_i, void* out_c, int bf16,
                               int packed, int batch, double dt, int n_steps, int save_stride,
                               void* stream) {
  const Outs outs{{out_s, out_e, out_i, out_c}, bf16, packed};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A == 4 && J == 4 && K == 4 && M == 4 && L == 2 && seasonal && n_knots <= kMaxKnots) {
    return launch<4, 4, 4, 4, 2, true>(consts, n_knots, y0, scales, outs, batch, dt, n_steps,
                                       save_stride, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
