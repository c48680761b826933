"""Build the port's CUDA sources for the host, against an emulation of the
CUDA pieces they use, so that the CPU tests can run them.

A CUDA kernel cannot run here, but the multi-strain and general SEIP sources
use only a few CUDA pieces: thread and block indices, ``__ldg``, warp
shuffles, ``__syncwarp``, ``__syncthreads``, dynamic shared memory, the
``__f*_rn`` intrinsics and bf16 stores. :data:`SHIM` emulates them: a
launch runs its CTAs one after another, each CTA as ``blockDim`` host
threads that meet at every CTA barrier, and each warp's 32 threads meet at
every shuffle and ``__syncwarp``, as a warp's lanes do. Every float32
operation rounds on its own (``-ffp-contract=off``), as nvcc's
``-fmad=false`` makes it on the card; ``cosf``, ``expf`` and ``sinf`` are
the host's, which may differ from the card's (and from PyTorch's) in the
last bit.

:func:`build` compiles one translation unit (a source of ``csrc/``, or a
unit ``ops/_build.py`` generates for a shape) into a shared library, after
rewriting each kernel launch ``kernel<...><<<blocks, threads, bytes,
stream>>>(`` into a call of the emulation.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dynode_tpu_torch.ops import _build

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline thread_local Idx threadIdx, blockIdx, blockDim;
template <class T> inline T __ldg(const T* p) { return *p; }
using std::isfinite;
using std::max;
using std::min;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
struct Warp { float vals[32]; std::barrier<>* bar; };
struct Block { std::barrier<>* bar; float* smem; };
inline thread_local Warp* g_warp = nullptr;
inline thread_local Block* g_block = nullptr;
inline thread_local int g_lane = 0;
inline float __shfl_sync(unsigned mask, float v, int src, int width = 32) {
  if (mask != 0xffffffffu) throw 1;
  g_warp->vals[g_lane] = v;
  g_warp->bar->arrive_and_wait();
  const float r = g_warp->vals[(g_lane / width) * width + ((src % width) + width) % width];
  g_warp->bar->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int offset) {
  if (mask != 0xffffffffu) throw 1;
  g_warp->vals[g_lane] = v;
  g_warp->bar->arrive_and_wait();
  const float r = g_warp->vals[g_lane ^ offset];
  g_warp->bar->arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar->arrive_and_wait(); }
inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
namespace emu {
inline float* dynamic_shared() { return g_block->smem; }
// a CTA at a time; each CTA's threads run together, shared memory starts as NaN
template <class F, class... Args>
void launch_smem(int blocks, int threads, size_t smem_bytes, F fn, Args... args) {
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> cta(threads);
    std::vector<float> smem(smem_bytes / 4 + 1, std::nanf(""));
    Block blk{&cta, smem.data()};
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<Warp> warps(threads / 32);
    for (auto& w : warps) {
      bars.push_back(std::make_unique<std::barrier<>>(32));
      w.bar = bars.back().get();
    }
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t) {
      lanes.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = threads;
        g_warp = &warps[t / 32]; g_lane = t % 32; g_block = &blk;
        fn(args...);
      });
    }
    for (auto& t : lanes) t.join();
  }
}
template <class F, class... Args>
void launch(int blocks, int threads, F fn, Args... args) {
  launch_smem(blocks, threads, 0, fn, args...);
}
}  // namespace emu
"""

# kernel<...><<<blocks, threads, bytes, stream>>>(  ->  emu::launch_smem(blocks, threads, bytes, kernel<...>,
_LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<(\w+), (\w+), (\w+), stream>>>\(")
_DYNAMIC = re.compile(r"extern __shared__ __align__\(16\) float (\w+)\[\];")


def emulated(text: str) -> str:
    """A CUDA source with its launches and dynamic shared memory rewritten
    for the emulation."""
    text = _LAUNCH.sub(r"emu::launch_smem(\2, \3, \4, \1, ", text)
    return _DYNAMIC.sub(r"float* \1 = emu::dynamic_shared();", text)


def build(name: str, unit: str, out: Path, entries: dict[str, list]) -> ctypes.CDLL:
    """Compile ``unit`` (the text of a translation unit) for the host into
    ``out`` with every source it includes emulated, and declare ``entries``
    (C entry -> ctypes argument types)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("needs g++ to build the host emulation")
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(SHIM)
    (out / "cuda_bf16.h").write_text('#include "cuda_runtime.h"\n')
    (out / _build.HEADER_NAME).write_text(_build.tableau_header())
    for src in [*_build.SRC_DIR.glob("*.cu*"), *_build.SHAPES_DIR.glob("*.cu*")]:
        (out / src.name).write_text(emulated(src.read_text()))
    cpp = out / f"{name}.cpp"
    cpp.write_text(emulated(unit))
    lib = out / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    "-Wno-attributes", "-I", str(out), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True)
    loaded = ctypes.CDLL(str(lib))
    for entry, types in entries.items():
        fn = getattr(loaded, entry)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return loaded


def build_family_units(specs, tmp_path_factory, workers: int = 4) -> dict:
    """``{(family, shape): library}`` of the units ``ops/_build.py``
    generates for each ``(family, shape)`` of ``specs``, built for the host
    a few at a time."""
    specs = list(specs)
    outs = [tmp_path_factory.mktemp(_build.shape_tag(*spec)) for spec in specs]  # not thread-safe

    def one(spec, out):
        family, shape = spec
        fam = _build.FAMILIES[family]
        return build(family, fam.unit(shape), out, fam.entries)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return dict(zip(specs, pool.map(one, specs, outs)))
