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
from pathlib import Path

from ..ode.solvers import Tsit5

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "csrc"
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


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and return types of every C entry point."""
    for name, arg_types in argtypes().items():
        fn = getattr(lib, name)
        fn.argtypes = arg_types
        fn.restype = ctypes.c_int
    return lib


__all__ = [
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
    "ptxas_resources",
    "sass_counts",
    "sass_mix",
    "tableau_header",
]
