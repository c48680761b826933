"""Whole-solve multi-strain SEIRS ensemble: CUDA C++ kernel and plain version.

Port of the row kernel of ``dynode_tpu/ops/multistrain_pallas.py``. The packed
state is ``(D, B)``: ``D = A + 4*A*K`` compartment rows (s | e | i | r | c, A
age groups, K strains) by B ensemble members; the per-member rates are
``(4K, B)`` rows (beta | sigma | gamma | omega).

:func:`ensemble_solve_tsit5` takes its route from the device of its inputs:

- CPU tensors go to :func:`ensemble_solve_reference`, the plain PyTorch
  version: the generic plain solve of :mod:`.generic` with the Tsit5 tableau
  on :func:`multistrain_rows_rhs`, whose expression order mirrors the JAX
  ``_tsit5_step_rows`` / ``_rhs_rows``;
- CUDA tensors go to the hand-written kernel ``csrc/multistrain_tsit5.cu``
  (one member per thread, state and stages in registers; see the source
  note there), built for ``sm_90a`` by :mod:`._build`, or raise.

The kernel is instantiated for ``(A, K)`` in :data:`INSTANTIATED`; another
shape on a CUDA tensor raises ``ValueError``.

The second entry point, :func:`ensemble_solve_tsit5_2d`, is the port of the
JAX 2-D variant (``multistrain_pallas.py``'s ``_solve_kernel_2d``): the same
model on an aligned ``(D2, B)`` layout, each compartment group padded to a
multiple of 8 rows, with per-(age, strain)-row rates and the expression
order of ``_rhs_2d`` / ``_tsit5_step_2d``. CPU tensors go to
:func:`_solve_2d_reference`, CUDA tensors to ``csrc/multistrain_tsit5_2d.cu``
(8 lanes per member, one (age, strain) pair per lane).
"""

from __future__ import annotations

import torch

from .. import _device
from ..ode.solvers import Tsit5
from . import _build
from .generic import RowsRHS, ensemble_solve_kernel_reference
from .generic_triton import _import_triton

#: benchmark-workload defaults
A_DIM = 2
K_DIM = 3
D_ROWS = A_DIM + 4 * A_DIM * K_DIM

#: (n_age, n_strain) shapes the CUDA kernel is compiled for
INSTANTIATED = ((2, 3), (3, 2))


def _d_rows(n_age: int, n_strain: int) -> int:
    return n_age + 4 * n_age * n_strain


def pack_state(y0, batch: int, n_age: int = A_DIM, n_strain: int = K_DIM) -> torch.Tensor:
    """``(s (A,), e/i/r/c (A, K))`` -> packed ``(D, B)`` float32, broadcast."""
    s, e, i, r, c = (torch.as_tensor(x) for x in y0)
    flat = torch.cat([s.reshape(-1), e.reshape(-1), i.reshape(-1), r.reshape(-1), c.reshape(-1)])
    d = _d_rows(n_age, n_strain)
    if flat.shape[0] != d:
        raise ValueError(f"state does not match {n_age} ages x {n_strain} strains")
    return flat.to(torch.float32)[:, None].expand(d, batch).contiguous()


def pack_params(beta, sigma, gamma, omega, batch: int, n_strain: int = K_DIM) -> torch.Tensor:
    """Per-strain rates (each ``(K,)`` or ``(B, K)``) -> packed ``(4K, B)`` rows."""

    def rows(x):
        x = torch.as_tensor(x).to(torch.float32)
        if x.ndim == 1:
            x = x[None, :].expand(batch, n_strain)
        return x.T  # (K, B)

    return torch.cat([rows(beta), rows(sigma), rows(gamma), rows(omega)]).contiguous()


def unpack_saves(saves: torch.Tensor, n_age: int = A_DIM, n_strain: int = K_DIM):
    """``(T, D, B)`` packed saves -> ``(s, e, i, r, c)`` as ``(T, B, ...)`` views."""
    T, _, B = saves.shape
    s = saves[:, :n_age, :].permute(0, 2, 1)  # (T, B, A)
    blocks = []
    off = n_age
    ak = n_age * n_strain
    for _ in range(4):
        blk = saves[:, off : off + ak, :]
        blocks.append(blk.reshape(T, n_age, n_strain, B).permute(0, 3, 1, 2))
        off += ak
    e, i, r, c = blocks
    return s, e, i, r, c


def _rhs_rows(y, contact, beta, sigma, gamma, omega, n_age, n_strain):
    """d/dt of the packed state; every op is on ``(B,)`` rows.

    ``beta``/... are lists of K rows; ``contact`` is a nested tuple of floats.
    """
    ak = n_age * n_strain
    s = [y[a] for a in range(n_age)]
    e = [y[n_age + idx] for idx in range(ak)]
    i = [y[n_age + ak + idx] for idx in range(ak)]
    r = [y[n_age + 2 * ak + idx] for idx in range(ak)]

    n = []
    for a in range(n_age):
        tot = s[a]
        for k in range(n_strain):
            idx = a * n_strain + k
            tot = tot + e[idx] + i[idx] + r[idx]
        n.append(tot)

    inv_n = [1.0 / na for na in n]
    d = [None] * _d_rows(n_age, n_strain)
    ds = [torch.zeros_like(s[0]) for _ in range(n_age)]
    for a in range(n_age):
        for k in range(n_strain):
            idx = a * n_strain + k
            mixed = torch.zeros_like(s[0])
            for b in range(n_age):
                mixed = mixed + contact[a][b] * i[b * n_strain + k] * inv_n[b]
            foi = beta[k] * mixed
            new_inf = foi * s[a]
            e_out = sigma[k] * e[idx]
            i_out = gamma[k] * i[idx]
            r_out = omega[k] * r[idx]
            ds[a] = ds[a] - new_inf + r_out
            d[n_age + idx] = new_inf - e_out  # de
            d[n_age + ak + idx] = e_out - i_out  # di
            d[n_age + 2 * ak + idx] = i_out - r_out  # dr
            d[n_age + 3 * ak + idx] = new_inf  # dc
    for a in range(n_age):
        d[a] = ds[a]
    return d


def _contact_tuple(contact) -> tuple[tuple[float, ...], ...]:
    return tuple(tuple(float(v) for v in row) for row in torch.as_tensor(contact).tolist())


def _grid(duration: float, dt: float, save_every: float) -> tuple[int, int, int]:
    """``(n_steps, save_stride, n_saves)`` of the uniform save grid."""
    n_steps = int(round(duration / dt))
    save_stride = int(round(save_every / dt))
    return n_steps, save_stride, n_steps // save_stride + 1


def multistrain_rows_rhs(contact, n_age: int = A_DIM, n_strain: int = K_DIM) -> RowsRHS:
    """The multi-strain RHS as a :class:`RowsRHS` for the generic solve.

    Parameter rows are beta | sigma | gamma | omega, K each (see
    :func:`pack_params`); ``contact`` is the ``(A, A)`` matrix, baked in as
    constants (the JAX version closes over a static tuple the same way).
    """
    contact_t = _contact_tuple(contact)
    K = n_strain

    def rhs(y, p, t):
        return _rhs_rows(
            y, contact_t, p[:K], p[K : 2 * K], p[2 * K : 3 * K], p[3 * K : 4 * K],
            n_age, n_strain,
        )

    flat = tuple(v for row in contact_t for v in row)
    return RowsRHS(rhs, _rhs_rows_triton, consts=(n_age, n_strain, *flat))


def _rhs_rows_triton():
    """The ``@triton.jit`` form of :func:`_rhs_rows`, in the same expression order.

    ``C = (n_age, n_strain, *contact.flatten())``; ``p`` is beta | sigma | gamma | omega,
    K rows each.
    """
    triton, tl = _import_triton()

    # Index arithmetic stays inline: Triton keeps an expression of constexprs
    # a constexpr, but a plain assignment of one makes a runtime scalar, which
    # cannot index a tuple.
    @triton.jit
    def multistrain_rhs(y, p, t, C: tl.constexpr):
        A: tl.constexpr = C[0]
        K: tl.constexpr = C[1]
        AK: tl.constexpr = A * K
        inv_n = ()
        for a in tl.static_range(A):
            tot = y[a]
            for k in tl.static_range(K):
                tot = tot + y[A + a * K + k] + y[A + AK + a * K + k] + y[A + 2 * AK + a * K + k]
            inv_n = inv_n + (1.0 / tot,)
        ds = ()
        de = ()
        di = ()
        dr = ()
        dc = ()
        for a in tl.static_range(A):
            ds_a = tl.zeros_like(y[0])
            for k in tl.static_range(K):
                mixed = tl.zeros_like(y[0])
                for b in tl.static_range(A):
                    mixed = mixed + C[2 + a * A + b] * y[A + AK + b * K + k] * inv_n[b]
                foi = p[k] * mixed
                new_inf = foi * y[a]
                e_out = p[K + k] * y[A + a * K + k]
                i_out = p[2 * K + k] * y[A + AK + a * K + k]
                r_out = p[3 * K + k] * y[A + 2 * AK + a * K + k]
                ds_a = ds_a - new_inf + r_out
                de = de + (new_inf - e_out,)
                di = di + (e_out - i_out,)
                dr = dr + (i_out - r_out,)
                dc = dc + (new_inf,)
            ds = ds + (ds_a,)
        return ds + de + di + dr + dc

    return multistrain_rhs


def ensemble_solve_reference(
    y0,
    beta,
    sigma,
    gamma,
    omega,
    contact,
    *,
    batch: int,
    duration: float,
    dt: float = 0.5,
    save_every: float = 1.0,
    n_age: int = A_DIM,
    n_strain: int = K_DIM,
) -> torch.Tensor:
    """The plain version: the kernel's computation as a Python time loop.

    It is :func:`~.generic.ensemble_solve_kernel_reference` with the Tsit5
    tableau on :func:`multistrain_rows_rhs`: the generic RK step on rows is
    the JAX ``_tsit5_step_rows`` once the tableau is Tsit5's. Runs on
    whatever device the inputs are on. Returns ``(n_saves, D, B)``.
    """
    return ensemble_solve_kernel_reference(
        multistrain_rows_rhs(contact, n_age, n_strain),
        pack_state(y0, batch, n_age, n_strain),
        pack_params(beta, sigma, gamma, omega, batch, n_strain),
        duration=duration, dt=dt, save_every=save_every, method="tsit5",
    )


def launch_multistrain_tsit5(
    y_packed: torch.Tensor,
    p_packed: torch.Tensor,
    contact: tuple[tuple[float, ...], ...],
    *,
    dt: float,
    n_steps: int,
    save_stride: int,
    n_age: int,
    n_strain: int,
) -> torch.Tensor:
    """Launch ``csrc/multistrain_tsit5.cu`` on packed CUDA inputs.

    Adds one to ``launch_multistrain_tsit5.launches`` per launch.
    """
    if (n_age, n_strain) not in INSTANTIATED:
        raise ValueError(
            f"the CUDA kernel is instantiated for (n_age, n_strain) in {INSTANTIATED}, "
            f"not ({n_age}, {n_strain})"
        )
    device = _device.require_hopper(y_packed.device)
    d_rows, batch = y_packed.shape
    if d_rows != _d_rows(n_age, n_strain) or p_packed.shape != (4 * n_strain, batch):
        raise ValueError(f"packed shapes {tuple(y_packed.shape)}, {tuple(p_packed.shape)} "
                         f"do not match {n_age} ages x {n_strain} strains")
    for t in (y_packed, p_packed):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("packed inputs must be contiguous float32 on one CUDA device")
    n_saves = n_steps // save_stride + 1
    contact_dev = torch.tensor(contact, dtype=torch.float32, device=device).reshape(-1)
    out = torch.empty((n_saves, d_rows, batch), dtype=torch.float32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.dynode_multistrain_tsit5(
            n_age, n_strain, y_packed.data_ptr(), p_packed.data_ptr(),
            contact_dev.data_ptr(), out.data_ptr(), batch, dt, n_steps, save_stride,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"multistrain_tsit5 kernel launch failed: CUDA error {rc}")
    launch_multistrain_tsit5.launches += 1
    return out


launch_multistrain_tsit5.launches = 0


def ensemble_solve_tsit5(
    y0,
    beta,
    sigma,
    gamma,
    omega,
    contact,
    *,
    batch: int,
    duration: float,
    dt: float = 0.5,
    save_every: float = 1.0,
    n_age: int = A_DIM,
    n_strain: int = K_DIM,
) -> torch.Tensor:
    """Solve a B-wide multi-strain SEIRS ensemble; returns ``(n_saves, D, B)``.

    Rates may be ``(K,)`` (shared) or ``(B, K)`` (per member); ``contact`` is
    the ``(A, A)`` matrix. The route follows the device of ``y0`` and the
    rates (module docstring); use :func:`unpack_saves` on the result.
    """
    tensors = [torch.as_tensor(x) for x in (*y0, beta, sigma, gamma, omega)]
    device = _device.common_device(*tensors)
    if not _device.uses_kernel(device):
        return ensemble_solve_reference(
            y0, beta, sigma, gamma, omega, contact,
            batch=batch, duration=duration, dt=dt, save_every=save_every,
            n_age=n_age, n_strain=n_strain,
        )
    n_steps, save_stride, _ = _grid(duration, dt, save_every)
    return launch_multistrain_tsit5(
        pack_state(y0, batch, n_age, n_strain),
        pack_params(beta, sigma, gamma, omega, batch, n_strain),
        _contact_tuple(contact),
        dt=float(dt), n_steps=n_steps, save_stride=save_stride,
        n_age=n_age, n_strain=n_strain,
    )


# ---------------------------------------------------------------------------
# the aligned 2-D layout
# ---------------------------------------------------------------------------


def _blk8(n: int) -> int:
    return -(-n // 8) * 8


def _offsets_2d(n_age: int, n_strain: int) -> tuple[tuple[int, ...], int]:
    """Aligned first rows of the s/e/i/r/c groups, and ``D2``."""
    sa = _blk8(n_age)
    sak = _blk8(n_age * n_strain)
    return (0, sa, sa + sak, sa + 2 * sak, sa + 3 * sak), sa + 4 * sak


def _live_rows_2d(n_age: int, n_strain: int) -> list[int]:
    """The rows of the aligned layout that hold state (the rest is padding)."""
    offs, _ = _offsets_2d(n_age, n_strain)
    sizes = (n_age,) + (n_age * n_strain,) * 4
    return [off + j for off, n in zip(offs, sizes) for j in range(n)]


def pack_state_2d(y0, batch: int, n_age: int = A_DIM, n_strain: int = K_DIM) -> torch.Tensor:
    """``(s (A,), e/i/r/c (A, K))`` -> the aligned ``(D2, B)`` state, zero padding rows."""
    offs, d2 = _offsets_2d(n_age, n_strain)
    parts = [torch.as_tensor(x) for x in y0]
    buf = torch.zeros((d2, batch), dtype=torch.float32, device=parts[0].device)
    for off, x in zip(offs, parts):
        flat = x.to(torch.float32).reshape(-1)
        buf[off : off + flat.shape[0]] = flat[:, None]
    return buf


def pack_rates_2d(beta, sigma, gamma, omega, batch: int,
                  n_age: int = A_DIM, n_strain: int = K_DIM) -> torch.Tensor:
    """Per-strain rates (each ``(K,)`` or ``(B, K)``) -> per-(age, strain)-row
    rates, one aligned ``(blk8(A*K), B)`` section each, stacked: row
    ``a*K + k`` of a section is ``rate[k]``."""
    ak = n_age * n_strain
    sak = _blk8(ak)

    def section(x):
        x = torch.as_tensor(x).to(torch.float32)
        if x.ndim == 1:
            x = x[None, :].expand(batch, n_strain)
        out = torch.zeros((sak, batch), dtype=torch.float32, device=x.device)
        out[:ak] = x.T.repeat(n_age, 1)
        return out

    return torch.cat([section(beta), section(sigma), section(gamma), section(omega)])


def unpack_saves_2d(saves: torch.Tensor, n_age: int = A_DIM, n_strain: int = K_DIM):
    """``(T, D2, B)`` aligned saves -> ``(s, e, i, r, c)`` as ``(T, B, ...)`` views."""
    offs, _ = _offsets_2d(n_age, n_strain)
    T, _, B = saves.shape
    ak = n_age * n_strain
    out = [saves[:, offs[0] : offs[0] + n_age, :].permute(0, 2, 1)]
    for off in offs[1:]:
        blk = saves[:, off : off + ak, :]
        out.append(blk.reshape(T, n_age, n_strain, B).permute(0, 3, 1, 2))
    return tuple(out)


def _rhs_2d(y, beta_r, sigma_r, gamma_r, omega_r, contact, n_age, n_strain):
    """d/dt of the aligned ``(D2, B)`` state in the JAX ``_rhs_2d`` order.

    The JAX version's group sums (``jnp.sum`` over K rows) are written out
    in row order.
    """
    A, K = n_age, n_strain
    ak = A * K
    offs, _ = _offsets_2d(A, K)
    sa, sak = _blk8(A), _blk8(ak)
    s = y[offs[0] : offs[0] + sa]
    e = y[offs[1] : offs[1] + sak]
    i = y[offs[2] : offs[2] + sak]
    r = y[offs[3] : offs[3] + sak]

    def group_sum(x, a):
        tot = x[a * K]
        for k in range(1, K):
            tot = tot + x[a * K + k]
        return tot

    eir = e + i + r
    inv_n = [1.0 / (s[a] + group_sum(eir, a)) for a in range(A)]
    i_on = torch.cat([i[a * K : (a + 1) * K] * inv_n[a] for a in range(A)])  # (AK, B)
    mixed = torch.cat([
        sum(contact[a][b] * i_on[b * K : (b + 1) * K] for b in range(A)) for a in range(A)
    ])
    s_rep = torch.cat([s[a : a + 1].expand(K, -1) for a in range(A)])
    new_inf = beta_r[:ak] * mixed * s_rep
    e_out = sigma_r[:ak] * e[:ak]
    i_out = gamma_r[:ak] * i[:ak]
    r_out = omega_r[:ak] * r[:ak]
    net = r_out - new_inf
    ds = torch.stack([group_sum(net, a) for a in range(A)])

    def padto(x, rows):
        return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])

    return torch.cat([
        padto(ds, sa),
        padto(new_inf - e_out, sak),
        padto(e_out - i_out, sak),
        padto(i_out - r_out, sak),
        padto(new_inf, sak),
    ])


def _tsit5_step_2d(y, dt: float, rhs):
    """One constant-step Tsit5 update of the whole block, the JAX
    ``_tsit5_step_2d`` order: ``ys = ys + (dt * a_j) * k_j`` term by term,
    ``dt * a_j`` a Python double rounded once to float32."""
    ks = []
    for stage in range(6):  # b[6] == 0
        ys = y
        if stage:
            for j, coeff in enumerate(Tsit5.a[stage - 1]):
                if coeff != 0.0:
                    ys = ys + (dt * coeff) * ks[j]
        ks.append(rhs(ys))
    out = y
    for j, coeff in enumerate(Tsit5.b[:6]):
        if coeff != 0.0:
            out = out + (dt * coeff) * ks[j]
    return out


def _solve_2d_reference(y_packed, p_packed, *, duration, dt, save_every, contact_tuple,
                        n_age, n_strain) -> torch.Tensor:
    """The plain version of the 2-D solve: ``(n_saves, D2, B)`` float32 on
    the inputs' device, padding rows zero."""
    sak = _blk8(n_age * n_strain)
    rates = [p_packed[q * sak : (q + 1) * sak] for q in range(4)]

    def rhs(y):
        return _rhs_2d(y, *rates, contact_tuple, n_age, n_strain)

    n_steps, save_stride, n_saves = _grid(duration, dt, save_every)
    out = torch.empty((n_saves, *y_packed.shape), dtype=torch.float32, device=y_packed.device)
    out[0] = y_packed
    y = y_packed
    for step in range(1, n_steps + 1):
        y = _tsit5_step_2d(y, dt, rhs)
        if step % save_stride == 0:
            out[step // save_stride] = y
    return out


def launch_multistrain_tsit5_2d(
    y_packed: torch.Tensor,
    p_packed: torch.Tensor,
    contact: tuple[tuple[float, ...], ...],
    *,
    dt: float,
    n_steps: int,
    save_stride: int,
    n_age: int,
    n_strain: int,
) -> torch.Tensor:
    """Launch ``csrc/multistrain_tsit5_2d.cu`` on aligned CUDA inputs.

    Adds one to ``launch_multistrain_tsit5_2d.launches`` per launch.
    """
    if (n_age, n_strain) not in INSTANTIATED:
        raise ValueError(
            f"the CUDA kernel is instantiated for (n_age, n_strain) in {INSTANTIATED}, "
            f"not ({n_age}, {n_strain})"
        )
    device = _device.require_hopper(y_packed.device)
    _, d2 = _offsets_2d(n_age, n_strain)
    batch = y_packed.shape[1]
    if y_packed.shape != (d2, batch) or p_packed.shape != (4 * _blk8(n_age * n_strain), batch):
        raise ValueError(f"packed shapes {tuple(y_packed.shape)}, {tuple(p_packed.shape)} "
                         f"do not match {n_age} ages x {n_strain} strains")
    for t in (y_packed, p_packed):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("packed inputs must be contiguous float32 on one CUDA device")
    n_saves = n_steps // save_stride + 1
    contact_dev = torch.tensor(contact, dtype=torch.float32, device=device).reshape(-1)
    out = torch.empty((n_saves, d2, batch), dtype=torch.float32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.dynode_multistrain_tsit5_2d(
            n_age, n_strain, y_packed.data_ptr(), p_packed.data_ptr(),
            contact_dev.data_ptr(), out.data_ptr(), batch, dt, n_steps, save_stride,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"multistrain_tsit5_2d kernel launch failed: CUDA error {rc}")
    launch_multistrain_tsit5_2d.launches += 1
    return out


launch_multistrain_tsit5_2d.launches = 0


def ensemble_solve_tsit5_2d(
    y0,
    beta,
    sigma,
    gamma,
    omega,
    contact,
    *,
    batch: int,
    duration: float,
    dt: float = 0.5,
    save_every: float = 1.0,
    n_age: int = A_DIM,
    n_strain: int = K_DIM,
) -> torch.Tensor:
    """The multi-strain ensemble on the aligned layout: ``(n_saves, D2, B)``.

    Same arguments as :func:`ensemble_solve_tsit5` (no ``block_b``: the
    kernel masks a ragged batch); returns the aligned buffer with zero
    padding rows, D2 = 40 at (2, 3). Use :func:`unpack_saves_2d` on it.
    """
    tensors = [torch.as_tensor(x) for x in (*y0, beta, sigma, gamma, omega)]
    device = _device.common_device(*tensors)
    y_packed = pack_state_2d(y0, batch, n_age, n_strain)
    p_packed = pack_rates_2d(beta, sigma, gamma, omega, batch, n_age, n_strain)
    contact_tuple = _contact_tuple(contact)
    if not _device.uses_kernel(device):
        return _solve_2d_reference(
            y_packed, p_packed, duration=float(duration), dt=float(dt),
            save_every=float(save_every), contact_tuple=contact_tuple,
            n_age=n_age, n_strain=n_strain,
        )
    n_steps, save_stride, _ = _grid(duration, dt, save_every)
    return launch_multistrain_tsit5_2d(
        y_packed, p_packed, contact_tuple, dt=float(dt), n_steps=n_steps,
        save_stride=save_stride, n_age=n_age, n_strain=n_strain,
    )


__all__ = [
    "INSTANTIATED",
    "pack_state",
    "pack_params",
    "unpack_saves",
    "ensemble_solve_tsit5",
    "ensemble_solve_reference",
    "launch_multistrain_tsit5",
    "multistrain_rows_rhs",
    "pack_state_2d",
    "pack_rates_2d",
    "unpack_saves_2d",
    "ensemble_solve_tsit5_2d",
    "launch_multistrain_tsit5_2d",
]
