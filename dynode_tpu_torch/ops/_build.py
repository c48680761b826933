"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

At first use, :func:`load_library` compiles each ``dynode_tpu_torch/csrc/*.cu``
with its own nvcc, all started together, and links the objects into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         [SOURCE_FLAGS of the source] \
         -c -I <generated include dir> -o <obj> csrc/<source>.cu   # one per source
    nvcc -shared -o <lib> <objs>

and loads it with ``ctypes``. The library goes into
``build/dynode_tpu_torch/<hash>/`` at the root of the checkout, keyed on a
hash of the sources, the generated header and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is. No source includes
PyTorch's headers, which keeps a build to seconds.

The one generated header, ``dynode_tableaus.cuh``, holds the Tsit5 tableau
written out from :mod:`dynode_tpu_torch.ode.solvers`, so the kernel's
coefficients are the Python floats of the tableau, never retyped.

Shape builds. The library instantiates each kernel for the shapes of the
production models only. Every other shape of a kernel family
(:data:`FAMILIES`) is built on its own, at first use
(:func:`shape_library`): a small generated translation unit includes the
family's source -- the library's own templates for the multi-strain
kernels, the general SEIP kernels of ``csrc/shapes/`` -- and instantiates
them for the shape behind ``extern "C"`` entries of its own. It is compiled
with the same flags (the source's ``SOURCE_FLAGS`` too) straight into a
shared library under
``build/dynode_tpu_torch/<shapes_key>/shapes/<family>_<shape>/``, keyed
on every source, the flags and the shape, and replaced atomically.
:func:`prebuild` compiles several at once, one nvcc each, all started
together. The library itself is unchanged by them: its sources, flags and
:func:`build_key` do not include ``csrc/shapes/``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from ..ode.solvers import Tsit5

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "csrc"
SHAPES_DIR = SRC_DIR / "shapes"  # sources built per shape only
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "dynode_tpu_torch"
LIB_NAME = "libdynode_kernels.so"
HEADER_NAME = "dynode_tableaus.cuh"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # print registers and spills of every kernel into the build log
    "-Xptxas", "-v",
)

#: flags of one source on top of NVCC_FLAGS. The adaptive SEIP kernel must round
#: as its plain version does, since its step decisions turn on rounding: no
#: multiply-add contraction, IEEE division and square root.
SOURCE_FLAGS = {
    "seip_bs3.cu": ("-fmad=false", "-prec-div=true", "-prec-sqrt=true"),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _c_matrix(rows, n) -> str:
    """A square C initializer of doubles, ``rows`` zero-padded to ``n x n``."""
    lines = []
    for row in rows:
        vals = [repr(float(v)) for v in row] + ["0.0"] * (n - len(row))
        lines.append("    {" + ", ".join(vals) + "},")
    return "\n".join(lines)


def tableau_header() -> str:
    """Text of the generated header: the Tsit5 stages of the constant step.

    Coefficients are written with ``repr`` (exact round trip of the Python
    float) and narrowed with ``static_cast<float>`` in the kernel, the same
    rounding the JAX kernels apply to a Python-float coefficient.
    """
    n = 6  # stages that reach the constant-step update (b[6] == 0)
    a_rows = [()] + [Tsit5.a[s - 1] for s in range(1, n)]
    b = ", ".join(repr(float(v)) for v in Tsit5.b[:n])
    return f"""// generated by dynode_tpu_torch/ops/_build.py from ode/solvers.py
#pragma once

namespace dynode {{

constexpr int kTsit5Stages = {n};

// a(s, j): weight of stage j in the input of stage s (row 0 is empty)
__host__ __device__ constexpr double tsit5_a(int s, int j) {{
  constexpr double a[{n}][{n}] = {{
{_c_matrix(a_rows, n)}
  }};
  return a[s][j];
}}

__host__ __device__ constexpr double tsit5_b(int j) {{
  constexpr double b[{n}] = {{{b}}};
  return b[j];
}}

}}  // namespace dynode
"""


def sources() -> list[Path]:
    """Every CUDA source of the package, in a stable order."""
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def build_key() -> str:
    """Hash of the sources, the generated header and the flags."""
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(tableau_header().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for name, flags in sorted(SOURCE_FLAGS.items()):
        h.update(f"{name}: {' '.join(flags)}".encode())
    return h.hexdigest()[:16]


def nvcc_commands(nvcc: str, out: Path, include_dir: Path) -> tuple[list[list[str]], list[str]]:
    """``(one compile command per csrc/*.cu, the link command into out)``."""
    compiles, objs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = out.parent / f"{src.stem}.o"
        objs.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c",
                         "-I", str(include_dir), "-I", str(SRC_DIR), "-o", str(obj), str(src)])
    return compiles, [nvcc, "-shared", "-o", str(out), *objs]


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands together; ``(command, return code, output)`` of each,
    the output ending with the command's wall time from the common start,
    labelled with the file the command writes."""
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]

    def finish(proc):
        text = proc.communicate()[0]
        target = Path(proc.args[proc.args.index("-o") + 1]).name
        return text + f"wall time: {time.perf_counter() - start:.1f} s ({target})\n"

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        outputs = list(pool.map(finish, procs))
    return [(cmd, proc.returncode, text) for cmd, proc, text in zip(cmds, procs, outputs)]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib_path = library_path()
    build_dir = lib_path.parent
    if not lib_path.is_file():
        include_dir = build_dir / "include"
        include_dir.mkdir(parents=True, exist_ok=True)
        (include_dir / HEADER_NAME).write_text(tableau_header())
        # objects and the library go into a private directory, removed
        # whether or not nvcc succeeds
        with tempfile.TemporaryDirectory(dir=build_dir) as work:
            tmp = Path(work) / LIB_NAME
            compiles, link = nvcc_commands(find_nvcc(), tmp, include_dir)
            results = _run_all(compiles)
            if all(rc == 0 for _, rc, _ in results):
                results += _run_all([link])
            log = "".join(" ".join(cmd) + "\n" + text for cmd, _, text in results)
            (build_dir / "nvcc.log").write_text(log)
            if any(rc != 0 for _, rc, _ in results):
                raise RuntimeError(f"nvcc failed:\n{log}")
            os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or none
    return _declare(ctypes.CDLL(str(lib_path)))


def build_log() -> str:
    """The nvcc output of the loaded build: ptxas registers and spills, and
    each command's wall time."""
    return (BUILD_ROOT / build_key() / "nvcc.log").read_text()


def library_path() -> Path:
    """Where :func:`load_library` keeps the library of the current sources."""
    return BUILD_ROOT / build_key() / LIB_NAME


_TEMPLATE_ARG = re.compile(r"L[ib](\d+)E")


def kernel_label(mangled: str) -> str:
    """``seip_bs3_kernel<4>`` for a mangled SEIP kernel name: the kernel and
    its template arguments after the six of the model's shape; the name as it
    is for any other symbol."""
    m = re.search(r"\d+(seip_\w+?_kernel)I((?:L[ib]\d+E)+)", mangled)
    if not m:
        return mangled
    extra = _TEMPLATE_ARG.findall(m.group(2))[6:]
    return f"{m.group(1)}<{','.join(extra)}>" if extra else m.group(1)


def ptxas_resources(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of every kernel in an nvcc log (``-Xptxas
    -v``), by :func:`kernel_label`."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = kernel_label(m.group(1))
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX")


def cuobjdump() -> Path | None:
    """The ``cuobjdump`` beside nvcc, else the one Triton ships under
    ``triton/backends/nvidia/bin/``; None where there is neither."""
    try:
        tool = Path(find_nvcc()).with_name("cuobjdump")
    except RuntimeError:
        tool = None
    if tool is not None and tool.is_file():
        return tool
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        tool = Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if tool.is_file():
            return tool
    return None


def sass_counts(binary: Path, match: str = "seip_") -> dict[str, dict[str, int]] | None:
    """:func:`sass_mix` of ``cuobjdump -sass binary`` (a shared library or a
    cubin); None where :func:`cuobjdump` finds no tool."""
    tool = cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([str(tool), "-sass", str(binary)], capture_output=True, text=True,
                          check=True).stdout
    return sass_mix(text, match)


def sass_mix(text: str, match: str = "seip_") -> dict[str, dict[str, int]]:
    """Static instruction mix of each kernel whose name holds ``match`` in a
    ``cuobjdump -sass`` listing: float32 arithmetic (FADD, FMUL, FFMA,
    FMNMX) and FFMA alone, MUFU in all and by function, SHFL, LDS, STS, LDG,
    STG, local loads and stores, barriers and the total, by
    :func:`kernel_label`."""
    out, counts = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts = out.setdefault(kernel_label(name), collections.Counter()) if match in name else None
        elif counts is not None and (m := _SASS_LINE.match(line)):
            op = m.group(1)
            base = op.split(".")[0]
            counts["total"] += 1
            if base in _FP32:
                counts["FP32"] += 1
                if base == "FFMA":
                    counts["FFMA"] += 1
            elif base == "MUFU":
                counts["MUFU"] += 1
                counts[op] += 1
            elif base in ("SHFL", "LDS", "STS", "LDG", "STG", "BAR", "WARPSYNC"):
                counts[base] += 1
            elif base in ("LDL", "STL"):
                counts["LDL/STL"] += 1
    return {name: dict(c) for name, c in out.items()}


def argtypes() -> dict[str, list]:
    """The ctypes argument types of every C entry point, by name; each
    returns an int (a CUDA error code, 0 on success)."""
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    seip_head = [
        i, i, i, i, i, i, i,  # A, J, K, M, L, seasonal, n_knots
        p, p, p,  # consts (host float64), y0, scales
        p, p, p, p,  # out_s, out_e, out_i, out_c (0 where not saved)
    ]
    return {
        "dynode_multistrain_tsit5": [
            i, i, i, i,  # n_age, n_strain, team, threads
            p, p, p, p,  # y0, params, contact, out
            i, f, i, i,  # batch, dt, n_steps, save_stride
            p,  # stream
        ],
        "dynode_multistrain_tsit5_2d": [
            i, i, i, i,  # n_age, n_strain, team, threads
            p, p, p, p,  # y0, rates, contact, out
            i, d, i, i,  # batch, dt, n_steps, save_stride
            p,  # stream
        ],
        "dynode_seip_time_table": seip_head[:8] + [
            d, i, p,  # dt, n_steps, table
            p,  # stream
        ],
        "dynode_seip_rk4": seip_head[:8] + [
            p, p, p,  # table, y0, scales
            p, p, p, p,  # out_s, out_e, out_i, out_c (0 where not saved)
            i, i, i, d, i, i,  # bf16, packed, batch, dt, n_steps, save_stride
            p,  # stream
        ],
        "dynode_seip_bs3": seip_head + [
            p,  # flags
            i, i, i, i, i,  # bf16, packed, batch, block_b, n_saves
            d, d, d, d, i,  # save_every, rtol, atol, dt0, steps_per_save
            p,  # stream
        ],
    }


def _declare(lib: ctypes.CDLL, types: dict[str, list] | None = None) -> ctypes.CDLL:
    """Argument and return types of every C entry point (of the library, or
    ``types`` of a shape build)."""
    for name, arg_types in (argtypes() if types is None else types).items():
        fn = getattr(lib, name)
        fn.argtypes = arg_types
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# shape builds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Family:
    """A kernel family built per shape: its generated unit's text for a
    shape, the ctypes argument types of the unit's entries, and the flags
    on top of :data:`NVCC_FLAGS` (those of the source it includes)."""

    unit: Callable[[tuple], str]
    entries: dict[str, list]
    flags: tuple[str, ...] = ()


def _ms_unit(kernel: str, shape: tuple) -> str:
    """The unit of one multi-strain shape: the library's source of
    ``kernel`` with its templates at ``(A, K)``, teams 1 and A (A at most
    32, a warp), behind the library entry's own arguments."""
    a, k = (int(x) for x in shape)
    is_2d = kernel.endswith("_2d")
    teams = [1] + ([a] if 1 < a <= 32 else [])
    args = f"y0, p, contact, out, batch, {'w' if is_2d else 'dt'}, n_steps, save_stride, threads, st"
    calls = "\n".join(f"  if (team == {t}) return launch_team<{a}, {k}, {t}>({args});" for t in teams)
    weights = """  Weights w{};
  for (int s = 0; s < dynode::kTsit5Stages; ++s) {
    for (int j = 0; j < dynode::kTsit5Stages; ++j) w.a[s][j] = static_cast<float>(dt * dynode::tsit5_a(s, j));
    w.b[s] = static_cast<float>(dt * dynode::tsit5_b(s));
  }
""" if is_2d else ""
    layout = ""
    if is_2d and (a * k) % 8 == 0:
        # every e / i / r / c group fills whole blocks of 8 rows, so only the s
        # group pads: the library's Layout asserts padding in every group
        layout = f"""
namespace {{
template <>
struct Layout<{a}, {k}> {{
  static constexpr int AK = {a * k};
  static constexpr int SA = blk8({a});
  static constexpr int SAK = AK;
  static constexpr int D2 = SA + 4 * SAK;
  static constexpr int kPad = SA - {a};  // zero rows of a save: s rows past A only
  __host__ __device__ static constexpr int pad_row(int j) {{ return {a} + j; }}
}};
}}  // namespace
"""
    dt_type = "double" if is_2d else "float"
    p_name = "rates" if is_2d else "params"
    return f"""// generated by dynode_tpu_torch/ops/_build.py: {kernel}.cu at (A, K) = ({a}, {k})
#include "{kernel}.cu"
{layout}
extern "C" int dynode_{kernel}_shape(int n_age, int n_strain, int team, int threads, const float* y0,
                                     const float* {p_name}, const float* contact, float* out, int batch,
                                     {dt_type} dt, int n_steps, int save_stride, void* stream) {{
  if (n_age != {a} || n_strain != {k} || threads <= 0 || threads > kMaxThreads ||
      threads % dynode_ms::kWarp != 0) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  const float* p = {p_name};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
{weights}{calls}
  return static_cast<int>(cudaErrorInvalidValue);
}}
"""


def _seip_shape(shape: tuple) -> tuple[str, str]:
    """``("A, J, K, M, L, SEASONAL", "(A, J, K, M, L, seasonal)")`` of a SEIP shape."""
    *dims, seasonal = (int(x) for x in shape)
    targs = ", ".join(str(d) for d in dims) + (", true" if seasonal else ", false")
    return targs, str(tuple(dims) + (bool(seasonal),))


def _seip_rk4_unit(shape: tuple) -> str:
    targs, label = _seip_shape(shape)
    dims = targs.rsplit(",", 1)[0]
    return f"""// generated by dynode_tpu_torch/ops/_build.py: shapes/seip_rk4_any.cu at {label}
#include "seip_rk4_any.cu"

using namespace dynode_seip_any;

extern "C" int dynode_seip_any_layout(int n_knots, int* offsets) {{
  layout_offsets<{dims}>(n_knots, offsets);
  return 0;
}}

extern "C" int dynode_seip_any_time_table(int n_knots, const double* consts, double dt, int n_steps,
                                          float* table, void* stream) {{
  return launch_table<{targs}>(consts, n_knots, dt, n_steps, table, static_cast<cudaStream_t>(stream));
}}

extern "C" int dynode_seip_any_rk4(int n_knots, const double* consts, const float* table, const float* y0,
                                   const float* scales, void* out_s, void* out_e, void* out_i, void* out_c,
                                   int bf16, int packed, int batch, double dt, int n_steps, int save_stride,
                                   void* stream) {{
  const Outs outs{{{{out_s, out_e, out_i, out_c}}, bf16, packed}};
  return launch_rk4<{targs}>(consts, n_knots, table, y0, scales, outs, batch, dt, n_steps, save_stride,
                             static_cast<cudaStream_t>(stream));
}}
"""


def _seip_bs3_unit(shape: tuple) -> str:
    targs, label = _seip_shape(shape)
    return f"""// generated by dynode_tpu_torch/ops/_build.py: shapes/seip_bs3_any.cu at {label}
#include "seip_bs3_any.cu"

using namespace dynode_seip_any;

extern "C" int dynode_seip_any_bs3(int n_knots, const double* consts, const float* y0, const float* scales,
                                   void* out_s, void* out_e, void* out_i, void* out_c, int* flags, int bf16,
                                   int packed, int batch, int block_b, int n_saves, double save_every,
                                   double rtol, double atol, double dt0, int steps_per_save, void* stream) {{
  const Outs outs{{{{out_s, out_e, out_i, out_c}}, bf16, packed}};
  return launch_bs3<{targs}>(consts, n_knots, y0, scales, outs, flags, batch, block_b, n_saves, save_every,
                             rtol, atol, dt0, steps_per_save, static_cast<cudaStream_t>(stream));
}}
"""


def _families() -> dict[str, Family]:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib = argtypes()
    outs = [p, p, p, p]  # out_s, out_e, out_i, out_c (0 where not saved)
    return {
        "multistrain_tsit5": Family(
            lambda s: _ms_unit("multistrain_tsit5", s),
            {"dynode_multistrain_tsit5_shape": lib["dynode_multistrain_tsit5"]}),
        "multistrain_tsit5_2d": Family(
            lambda s: _ms_unit("multistrain_tsit5_2d", s),
            {"dynode_multistrain_tsit5_2d_shape": lib["dynode_multistrain_tsit5_2d"]}),
        "seip_rk4": Family(_seip_rk4_unit, {
            "dynode_seip_any_layout": [i, p],
            "dynode_seip_any_time_table": [i, p, d, i, p, p],  # n_knots, consts, dt, n_steps, table, stream
            "dynode_seip_any_rk4": [i, p, p, p, p, *outs,  # n_knots, consts, table, y0, scales
                                    i, i, i, d, i, i, p],  # bf16, packed, batch, dt, n_steps, save_stride, stream
        }),
        "seip_bs3": Family(_seip_bs3_unit, {
            "dynode_seip_any_bs3": [i, p, p, p, *outs, p,  # n_knots, consts, y0, scales, outs, flags
                                    i, i, i, i, i,  # bf16, packed, batch, block_b, n_saves
                                    d, d, d, d, i, p],  # save_every, rtol, atol, dt0, steps_per_save, stream
        }, SOURCE_FLAGS["seip_bs3.cu"]),  # the production BS3's numerics
    }


#: the kernel families built per shape, by name
FAMILIES = _families()


def shape_sources() -> list[Path]:
    """The sources only the shape builds use, in a stable order."""
    return sorted(SHAPES_DIR.glob("*.cu")) + sorted(SHAPES_DIR.glob("*.cuh"))


def shapes_key() -> str:
    """Hash of the library's key (its sources, header and flags) and the
    shape builds' own sources."""
    h = hashlib.sha256(build_key().encode())
    for path in shape_sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def shape_tag(family: str, shape: tuple) -> str:
    """``seip_rk4_4_4_3_4_2_0``: a family and a shape as a directory name."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; one of {tuple(FAMILIES)}")
    return "_".join([family, *(str(int(x)) for x in shape)])


def shape_dir(family: str, shape: tuple) -> Path:
    """Where the shape build of ``family`` at ``shape`` lives."""
    return BUILD_ROOT / shapes_key() / "shapes" / shape_tag(family, shape)


def _shape_command(nvcc: str, family: str, unit: Path, out: Path, include_dir: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, *FAMILIES[family].flags, "-shared", "-I", str(include_dir), "-I", str(SRC_DIR),
            "-I", str(SHAPES_DIR), "-o", str(out), str(unit)]


def prebuild(family_shapes) -> float:
    """Build every ``(family, shape)`` of ``family_shapes`` not built yet,
    one nvcc each, all started together; the round's wall seconds (0 when
    all are built). A failed compile raises ``RuntimeError`` with its log."""
    todo = []
    for family, shape in dict.fromkeys((f, tuple(int(x) for x in s)) for f, s in family_shapes):
        d = shape_dir(family, shape)
        if not (d / LIB_NAME).is_file():
            todo.append((family, shape, d))
    if not todo:
        return 0.0
    start = time.perf_counter()
    nvcc = find_nvcc()
    include_dir = BUILD_ROOT / shapes_key() / "include"
    include_dir.mkdir(parents=True, exist_ok=True)
    header = include_dir / HEADER_NAME
    if not header.is_file():
        tmp = include_dir / f".{HEADER_NAME}.{os.getpid()}"
        tmp.write_text(tableau_header())
        os.replace(tmp, header)
    works, cmds = [], []
    for family, shape, d in todo:
        d.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(dir=d))
        unit = work / f"{shape_tag(family, shape)}.cu"
        unit.write_text(FAMILIES[family].unit(shape))
        works.append(work)
        cmds.append(_shape_command(nvcc, family, unit, work / LIB_NAME, include_dir))
    try:
        results = _run_all(cmds)
        failed = []
        for (family, shape, d), work, (cmd, rc, text) in zip(todo, works, results):
            log = " ".join(cmd) + "\n" + text
            (d / "nvcc.log").write_text(log)
            if rc != 0:
                failed.append(log)
            else:
                os.replace(work / LIB_NAME, d / LIB_NAME)  # atomic: all or none
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for work in works:
            shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - start


@functools.cache
def shape_library(family: str, shape: tuple) -> ctypes.CDLL:
    """The shape build of ``family`` at ``shape`` (built at first use),
    loaded, its entries declared."""
    shape = tuple(int(x) for x in shape)
    prebuild([(family, shape)])
    lib = ctypes.CDLL(str(shape_dir(family, shape) / LIB_NAME))
    return _declare(lib, FAMILIES[family].entries)


def shape_build_log(family: str, shape: tuple) -> str:
    """The nvcc output of a shape build: ptxas registers and spills, and its
    wall time."""
    return (shape_dir(family, shape) / "nvcc.log").read_text()


__all__ = [
    "FAMILIES",
    "NVCC_FLAGS",
    "argtypes",
    "SOURCE_FLAGS",
    "build_key",
    "build_log",
    "cuobjdump",
    "find_nvcc",
    "kernel_label",
    "library_path",
    "load_library",
    "nvcc_commands",
    "prebuild",
    "ptxas_resources",
    "sass_counts",
    "sass_mix",
    "shape_build_log",
    "shape_dir",
    "shape_library",
    "shape_sources",
    "shapes_key",
    "tableau_header",
]
