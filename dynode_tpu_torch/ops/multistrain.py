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
  (a team of lanes per member, state and stages in registers; see the
  source note there), built for ``sm_90a`` by :mod:`._build`, or raise.

The library instantiates the kernels for ``(A, K)`` in :data:`INSTANTIATED`;
every other shape up to :data:`MAX_ROWS` state rows is built from the same
templates at first use (:func:`~._build.shape_library`), and a larger one
on a CUDA tensor raises ``ValueError``.

The second entry point, :func:`ensemble_solve_tsit5_2d`, is the port of the
JAX 2-D variant (``multistrain_pallas.py``'s ``_solve_kernel_2d``): the same
model on an aligned ``(D2, B)`` layout, each compartment group padded to a
multiple of 8 rows, with per-(age, strain)-row rates and the expression
order of ``_rhs_2d`` / ``_tsit5_step_2d``. CPU tensors go to
:func:`_solve_2d_reference`, CUDA tensors to ``csrc/multistrain_tsit5_2d.cu``.

Both kernels share one right-hand side (``csrc/multistrain_team.cuh``): a
member is served by a team of lanes, one lane for the whole member or one
lane per age; :func:`pick_team` chooses, by batch.
"""

from __future__ import annotations

import functools
import re

import torch

from .. import _device
from ..ode.solvers import Tsit5
from . import _build
from .generic import RowsRHS, check_block_b, ensemble_solve_kernel_reference
from .generic_triton import _import_triton

#: benchmark-workload defaults
A_DIM = 2
K_DIM = 3
D_ROWS = A_DIM + 4 * A_DIM * K_DIM

#: (n_age, n_strain) shapes the library's CUDA kernels are compiled for;
#: any other goes to a shape build of the same templates
INSTANTIATED = ((2, 3), (3, 2))
#: most state rows ``A + 4AK`` a kernel takes: a lane of a one-lane team
#: holds a member's rows and its six stages, fully unrolled, so a shape
#: build's compile grows with them; ``chip_sweep.py shapes`` times the
#: builds up to this limit (``ROADMAP.md`` Queue 3 logs it)
MAX_ROWS = 256
#: most ages a team of one lane per age takes: a team lies within a warp
MAX_TEAM = 32

#: threads a block of the two kernels. ``chip_sweep.py multistrain`` on an
#: H100 80GB HBM3 at 700 W: 64 and 128 level at every team width and batch,
#: 256 up to 49% slower (one lane per member at B = 9,984: 0.507 / 0.508 /
#: 0.755 ms).
THREADS = 128


def teams(n_age: int) -> tuple[int, ...]:
    """Lanes per member the kernels are compiled for: one lane for the whole
    member, or one lane per age up to :data:`MAX_TEAM` ages."""
    return (1, n_age) if 1 < n_age <= MAX_TEAM else (1,)


#: widest batch at which the launchers give each age its own lane. The
#: sweep above, (A, K) = (2, 3), one lane per age against one per member,
#: row / 2-D kernel in ms: B = 9,984 0.468 / 0.443 against 0.507 / 0.449;
#: 39,936 1.055 / 0.989 against 1.495 / 1.174; 65,536 1.643 / 1.455
#: against 1.499 / 1.330; and one lane per member stays ahead up to 655,360.
TEAM_UP_TO = 39936


def pick_team(batch: int, n_age: int) -> int:
    """Lanes per member the launchers use for ``batch`` members of
    ``n_age`` ages: one per age up to :data:`TEAM_UP_TO` members, else one.

    A small batch leaves one-lane warps too few for the card's schedulers
    (312 warps for 528 at B = 9,984) or needs a second wave of them (216
    registers a lane give 8 resident warps an SM); a wide one fills the card
    either way, and there the team's shuffles are extra issue.
    """
    return n_age if batch <= TEAM_UP_TO and n_age <= MAX_TEAM else 1


def _launch_shape(batch: int, n_age: int, team: int | None,
                  threads: int | None) -> tuple[int, int]:
    """``(team, threads)``: the caller's, checked, or the defaults."""
    team = pick_team(batch, n_age) if team is None else int(team)
    threads = THREADS if threads is None else int(threads)
    if team not in teams(n_age):
        raise ValueError(f"team must be one of {teams(n_age)} at {n_age} ages, got {team}")
    if threads <= 0 or threads > 256 or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 up to 256, got {threads}")
    return team, threads


def _contact_on(contact, device: torch.device, n_age: int) -> torch.Tensor:
    """The ``(A*A,)`` float32 contact matrix on ``device``, with no round
    trip: a tensor already there is used as it is; host data goes to the
    card once per matrix and is kept (:func:`_contact_upload`)."""
    if isinstance(contact, torch.Tensor) and contact.device == device:
        flat = contact.to(torch.float32).reshape(-1).contiguous()
    else:
        flat = _contact_upload(_contact_tuple(contact), device)
    if flat.numel() != n_age * n_age:
        raise ValueError(f"contact has {flat.numel()} entries, not {n_age} x {n_age}")
    return flat


@functools.lru_cache(maxsize=16)
def _contact_upload(contact: tuple[tuple[float, ...], ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(contact, dtype=torch.float32, device=device).reshape(-1)


def _d_rows(n_age: int, n_strain: int) -> int:
    return n_age + 4 * n_age * n_strain


def _check_shape(n_age: int, n_strain: int) -> None:
    """``ValueError`` for a shape no kernel takes: past :data:`MAX_ROWS`
    state rows (checked before any device work)."""
    if (n_age, n_strain) not in INSTANTIATED and (
            n_age < 1 or n_strain < 1 or _d_rows(n_age, n_strain) > MAX_ROWS):
        raise ValueError(
            f"the multi-strain kernels take n_age, n_strain >= 1 and at most {MAX_ROWS} state rows "
            f"A + 4AK, not {_d_rows(n_age, n_strain)} at ({n_age}, {n_strain})")


def _kernel_entry(kernel: str, n_age: int, n_strain: int):
    """The C entry of ``kernel`` (``"multistrain_tsit5"`` or ``"_2d"``) for
    ``(n_age, n_strain)``: the library's at an instantiated shape, else the
    shape build's, which takes the same arguments."""
    if (n_age, n_strain) in INSTANTIATED:
        return getattr(_build.load_library(), f"dynode_{kernel}")
    _check_shape(n_age, n_strain)
    return getattr(_build.shape_library(kernel, (n_age, n_strain)), f"dynode_{kernel}_shape")


def pack_state(y0, batch: int, n_age: int = A_DIM, n_strain: int = K_DIM) -> torch.Tensor:
    """``(s (A,), e/i/r/c (A, K))`` -> packed ``(D, B)`` float32, broadcast."""
    flat = torch.cat([torch.as_tensor(x, dtype=torch.float32).reshape(-1) for x in y0])
    d = _d_rows(n_age, n_strain)
    if flat.shape[0] != d:
        raise ValueError(f"state does not match {n_age} ages x {n_strain} strains")
    return flat[:, None].expand(d, batch).contiguous()


def pack_params(beta, sigma, gamma, omega, batch: int, n_strain: int = K_DIM) -> torch.Tensor:
    """Per-strain rates (each ``(K,)`` or ``(B, K)``) -> packed ``(4K, B)`` rows."""

    def rows(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        return x[:, None].expand(n_strain, batch) if x.ndim == 1 else x.T  # (K, B)

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
    """The contact matrix as nested Python floats (from a CUDA tensor this
    waits for the card: the kernel routes use :func:`_contact_on`)."""
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
    contact,
    *,
    dt: float,
    n_steps: int,
    save_stride: int,
    n_age: int,
    n_strain: int,
    team: int | None = None,
    threads: int | None = None,
) -> torch.Tensor:
    """Launch ``csrc/multistrain_tsit5.cu`` on packed CUDA inputs: the
    library's instantiation, or the shape build at another ``(n_age,
    n_strain)`` (:func:`_kernel_entry`).

    ``contact`` is the ``(A, A)`` matrix, a tensor or nested floats;
    ``team`` (lanes per member, one of :func:`teams`) and ``threads`` (a
    block) default to :func:`pick_team` and :data:`THREADS`. Adds one to
    ``launch_multistrain_tsit5.launches`` per launch.
    """
    _check_shape(n_age, n_strain)
    device = _device.require_hopper(y_packed.device)
    d_rows, batch = y_packed.shape
    if d_rows != _d_rows(n_age, n_strain) or p_packed.shape != (4 * n_strain, batch):
        raise ValueError(f"packed shapes {tuple(y_packed.shape)}, {tuple(p_packed.shape)} "
                         f"do not match {n_age} ages x {n_strain} strains")
    for t in (y_packed, p_packed):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("packed inputs must be contiguous float32 on one CUDA device")
    team, threads = _launch_shape(batch, n_age, team, threads)
    n_saves = n_steps // save_stride + 1
    contact_dev = _contact_on(contact, device, n_age)
    out = torch.empty((n_saves, d_rows, batch), dtype=torch.float32, device=device)
    entry = _kernel_entry("multistrain_tsit5", n_age, n_strain)
    with torch.cuda.device(device):
        rc = entry(
            n_age, n_strain, team, threads, y_packed.data_ptr(), p_packed.data_ptr(),
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
    block_b: int | None = None,
    n_age: int = A_DIM,
    n_strain: int = K_DIM,
) -> torch.Tensor:
    """Solve a B-wide multi-strain SEIRS ensemble; returns ``(n_saves, D, B)``.

    Rates may be ``(K,)`` (shared) or ``(B, K)`` (per member); ``contact`` is
    the ``(A, A)`` matrix. The route follows the device of ``y0`` and the
    rates (module docstring); use :func:`unpack_saves` on the result.
    ``block_b`` is the JAX keyword (the TPU kernel's lane-block width): a
    positive value changes nothing, since the kernel picks its own width
    and masks a ragged batch (:func:`~.generic.check_block_b`).
    """
    check_block_b(block_b)
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
        contact,
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
    """``(s (A,), e/i/r/c (A, K))`` -> the aligned ``(D2, B)`` state, zero padding rows.

    Three device operations: one column of the groups and their padding,
    then one broadcast copy over the batch.
    """
    offs, d2 = _offsets_2d(n_age, n_strain)
    parts = [torch.as_tensor(x, dtype=torch.float32).reshape(-1) for x in y0]
    pads = [end - off - x.shape[0] for off, end, x in zip(offs, (*offs[1:], d2), parts)]
    zeros = parts[0].new_zeros(max(pads))
    column = torch.cat([piece for x, pad in zip(parts, pads) for piece in (x, zeros[:pad])])
    return column[:, None].expand(d2, batch).contiguous()


def pack_rates_2d(beta, sigma, gamma, omega, batch: int,
                  n_age: int = A_DIM, n_strain: int = K_DIM) -> torch.Tensor:
    """Per-strain rates (each ``(K,)`` or ``(B, K)``) -> per-(age, strain)-row
    rates, one aligned ``(blk8(A*K), B)`` section each, stacked: row
    ``a*K + k`` of a section is ``rate[k]``."""
    ak = n_age * n_strain
    sak = _blk8(ak)
    # (4, K, B): the per-strain rows, one section per rate; the aligned
    # section repeats them for every age and ends in zero rows
    rows = pack_params(beta, sigma, gamma, omega, batch, n_strain).reshape(4, n_strain, batch)
    zeros = rows.new_zeros((4, sak - ak, batch))
    return torch.cat([rows] * n_age + [zeros], dim=1).reshape(4 * sak, batch)


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
    contact,
    *,
    dt: float,
    n_steps: int,
    save_stride: int,
    n_age: int,
    n_strain: int,
    team: int | None = None,
    threads: int | None = None,
) -> torch.Tensor:
    """Launch ``csrc/multistrain_tsit5_2d.cu`` on aligned CUDA inputs (the
    library's instantiation or a shape build, as
    :func:`launch_multistrain_tsit5`).

    ``contact``, ``team`` and ``threads`` as for
    :func:`launch_multistrain_tsit5`. Adds one to
    ``launch_multistrain_tsit5_2d.launches`` per launch.
    """
    _check_shape(n_age, n_strain)
    device = _device.require_hopper(y_packed.device)
    _, d2 = _offsets_2d(n_age, n_strain)
    batch = y_packed.shape[1]
    if y_packed.shape != (d2, batch) or p_packed.shape != (4 * _blk8(n_age * n_strain), batch):
        raise ValueError(f"packed shapes {tuple(y_packed.shape)}, {tuple(p_packed.shape)} "
                         f"do not match {n_age} ages x {n_strain} strains")
    for t in (y_packed, p_packed):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("packed inputs must be contiguous float32 on one CUDA device")
    team, threads = _launch_shape(batch, n_age, team, threads)
    n_saves = n_steps // save_stride + 1
    contact_dev = _contact_on(contact, device, n_age)
    out = torch.empty((n_saves, d2, batch), dtype=torch.float32, device=device)
    entry = _kernel_entry("multistrain_tsit5_2d", n_age, n_strain)
    with torch.cuda.device(device):
        rc = entry(
            n_age, n_strain, team, threads, y_packed.data_ptr(), p_packed.data_ptr(),
            contact_dev.data_ptr(), out.data_ptr(), batch, dt, n_steps, save_stride,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"multistrain_tsit5_2d kernel launch failed: CUDA error {rc}")
    launch_multistrain_tsit5_2d.launches += 1
    return out


launch_multistrain_tsit5_2d.launches = 0

_KERNEL_NAME = re.compile(r"\d+(multistrain_tsit5(?:_2d)?_kernel)I((?:Li\d+E)+)")


def kernel_label(mangled: str) -> str | None:
    """``multistrain_tsit5_kernel<2,3,2>`` (A, K, team) for the mangled name of
    a multi-strain kernel; None for any other symbol."""
    m = _KERNEL_NAME.search(mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def compile_facts(log: str, sass: dict | None) -> dict[str, dict]:
    """Registers and spill bytes (``ptxas -v``, from the build log ``log``)
    and the static SASS mix (``sass``, :func:`~._build.sass_counts` of the
    library, or None where there is no ``cuobjdump``) of every compiled
    multi-strain kernel, by :func:`kernel_label`."""
    facts = {}
    for name, resources in _build.ptxas_resources(log).items():
        label = kernel_label(name)
        if label is not None:
            facts[label] = {**resources, "sass": None if sass is None else sass.get(name)}
    return facts


def kernel_name(kernel: str, n_age: int, n_strain: int, team: int) -> str:
    """The :func:`kernel_label` of one instantiation: ``kernel`` is
    ``"multistrain_tsit5"`` or ``"multistrain_tsit5_2d"``."""
    return f"{kernel}_kernel<{n_age},{n_strain},{team}>"


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
    block_b: int = 256,
    n_age: int = A_DIM,
    n_strain: int = K_DIM,
) -> torch.Tensor:
    """The multi-strain ensemble on the aligned layout: ``(n_saves, D2, B)``.

    Same arguments as :func:`ensemble_solve_tsit5` (``block_b`` defaults to
    the JAX 256 and, positive, changes nothing); returns the aligned buffer
    with zero padding rows, D2 = 40 at (2, 3). Use :func:`unpack_saves_2d`
    on it.
    """
    check_block_b(block_b)
    tensors = [torch.as_tensor(x) for x in (*y0, beta, sigma, gamma, omega)]
    device = _device.common_device(*tensors)
    y_packed = pack_state_2d(y0, batch, n_age, n_strain)
    p_packed = pack_rates_2d(beta, sigma, gamma, omega, batch, n_age, n_strain)
    if not _device.uses_kernel(device):
        return _solve_2d_reference(
            y_packed, p_packed, duration=float(duration), dt=float(dt),
            save_every=float(save_every), contact_tuple=_contact_tuple(contact),
            n_age=n_age, n_strain=n_strain,
        )
    n_steps, save_stride, _ = _grid(duration, dt, save_every)
    return launch_multistrain_tsit5_2d(
        y_packed, p_packed, contact, dt=float(dt), n_steps=n_steps,
        save_stride=save_stride, n_age=n_age, n_strain=n_strain,
    )


__all__ = [
    "INSTANTIATED",
    "MAX_ROWS",
    "MAX_TEAM",
    "TEAM_UP_TO",
    "THREADS",
    "compile_facts",
    "kernel_label",
    "kernel_name",
    "pick_team",
    "teams",
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
