"""Hamiltonian time evolution: ``dU/dt = -i H(t) U`` as a gate factory.

A time-dependent gate does not solve when it is called.  It records an
:class:`EvolvedOperation` whose matrix is *pending*; when the recording
closes (:func:`~qml_essentials_tpu_torch.ops.tape.recording`), the
pending operations of the tape are grouped by Hamiltonian family — the
coefficient functions, their matrices, the solver options, the dtype and
the device — and each family is solved in **one batched call** over all of
its gates and batch rows (:meth:`Evolution.resolve`).  A pulse-mode circuit
of thousands of pulse gates therefore makes as many solver calls as it has
families (five for the ansaetze's RX, RY, virtual RZ, CZ and H-correction
drives), whatever its size.  An operation made outside a recording solves
when its matrix is first read.

Solvers, the same algorithms as the JAX package's:

* ``"magnus4"`` (default) and ``"magnus2"``: the commutator-free Magnus
  integrators (CFM4:2 of Blanes & Moan 2006, and the midpoint rule) on a
  fixed grid of ``magnus_steps`` steps.  The grid has no data-dependent
  step, so every step's exponentials are formed at once, and the ordered
  product of the step factors is taken as a balanced tree (the same
  product, associated in pairs).
* ``"dopri5"`` and ``"dopri8"``: embedded Dormand-Prince 5(4) and Hairer's
  DOP853 with a PI step controller in real-split arithmetic, each row of
  the batch on its own step sequence (rows that have reached their end
  time stay where they are); a row whose step budget runs out returns NaN.

Every product and exponential is written out elementwise over the batch
axes (a closed form for 2x2 matrices, a scaled Taylor series with a
per-row number of squarings for larger ones), so a row's answer does not
depend on what else is in the batch: a batch solves each row exactly as
that row alone would.

A family is solved in float64 whatever the gates' dtype, and a float32
gate's matrix is rounded once at the end.  In float32 the fixed grid's 512
near-identity factors each round their cosine the same way, so the
propagator's norm drifts by ~1.5e-5 a gate, in one direction for equal
gates; over the ~1,500 pulse gates of a 24-qubit tape that would move
``<Z>`` by far more than the statevector's own float32 rounding.  The
solve is a few hundred elementwise launches a family, whatever its size.
The adaptive solvers' default tolerance still follows the gates' dtype
(1e-10 for float64, 1.4e-8 for float32).

Counterpart of ``qml_essentials_tpu/pulse/evolution.py``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch.func import vmap

from qml_essentials_tpu_torch.ops.dtypes import DEFAULT_RDTYPE, cdtype
from qml_essentials_tpu_torch.ops.operations import (
    Hermitian,
    Operation,
    ParametrizedHamiltonian,
    _placed,
)
from qml_essentials_tpu_torch.pulse import _dop853_tableau as _dp8

# Dormand–Prince 5(4) Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600,
    0.0,
    7571 / 16695,
    393 / 640,
    -92097 / 339200,
    187 / 2100,
    1 / 40,
)

# CFM4:2 (Blanes & Moan 2006, Table II): stage nodes and weights.
_SQRT3 = math.sqrt(3.0)
_C1, _C2 = 0.5 - _SQRT3 / 6.0, 0.5 + _SQRT3 / 6.0
_A1, _A2 = 0.25 + _SQRT3 / 6.0, 0.25 - _SQRT3 / 6.0

# Taylor degree and the norm it is accurate to (float64 rounding) for the
# exponential of matrices larger than 2x2.
_TAYLOR_DEGREE = 18
_TAYLOR_NORM = 0.5
# |s^2| under which the 2x2 closed form switches to its series.
_SERIES_S2 = 1e-6
# Elements (rows x grid points x d^2) of one piece of a fixed-grid solve.
_PIECE_ELEMENTS = 2**24


# ---------------------------------------------------------------------------
# Row-independent matrix arithmetic
# ---------------------------------------------------------------------------


def _matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` over the last two axes, as elementwise products and sums in
    a fixed order: each row is computed the same way whatever the batch."""
    d = x.shape[-1]
    acc = x[..., :, :1] * y[..., :1, :]
    for k in range(1, d):
        acc = acc + x[..., :, k : k + 1] * y[..., k : k + 1, :]
    return acc


def _expm2(x: torch.Tensor) -> torch.Tensor:
    """Exponential of 2x2 matrices in closed form: ``x = mu I + N`` with
    ``N^2 = s^2 I``, so ``exp(x) = e^mu (cosh(s) I + sinh(s)/s N)``."""
    a, b, c, d = x[..., 0, 0], x[..., 0, 1], x[..., 1, 0], x[..., 1, 1]
    mu = (a + d) / 2
    delta = (a - d) / 2
    s2 = delta * delta + b * c
    small = s2.abs() < _SERIES_S2
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    cosh = torch.where(small, 1 + s2 / 2 + s2 * s2 / 24, torch.cosh(s))
    sinhc = torch.where(small, 1 + s2 / 6 + s2 * s2 / 120, torch.sinh(s) / s)
    e = torch.exp(mu)
    es = e * sinhc
    top = torch.stack([e * cosh + es * delta, es * b], dim=-1)
    bottom = torch.stack([es * c, e * cosh - es * delta], dim=-1)
    return torch.stack([top, bottom], dim=-2)


def _expm_taylor(x: torch.Tensor) -> torch.Tensor:
    """Exponential of d x d matrices: each matrix scaled by its own power of
    two into the Taylor series' range, the series in Horner form, then
    squared back as often as that matrix was scaled (masked, so a row's
    squarings do not depend on the other rows)."""
    norm = x.abs().sum(-2).amax(-1)
    s = torch.ceil(torch.log2(norm / _TAYLOR_NORM)).clamp(min=0)
    s = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
    x = x / torch.exp2(s).to(x.dtype)[..., None, None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    acc = eye + x / _TAYLOR_DEGREE
    for k in range(_TAYLOR_DEGREE - 1, 0, -1):
        acc = eye + _matmul(x, acc) / k
    for j in range(int(s.max()) if s.numel() else 0):
        acc = torch.where((s > j)[..., None, None], _matmul(acc, acc), acc)
    return acc


def _expm(x: torch.Tensor) -> torch.Tensor:
    return _expm2(x) if x.shape[-1] == 2 else _expm_taylor(x)


def _ordered_product(factors: torch.Tensor) -> torch.Tensor:
    """``F[L-1] ... F[1] F[0]`` of ``factors`` (rows, L, d, d), associated in
    pairs level by level."""
    while factors.shape[1] > 1:
        length = factors.shape[1]
        even = length - length % 2
        paired = _matmul(factors[:, 1:even:2], factors[:, 0:even:2])
        factors = torch.cat([paired, factors[:, even:]], dim=1) if length % 2 else paired
    return factors[:, 0]


def _per_problem(fn: Callable) -> Callable:
    """A coefficient function as a scalar tensor of the time's dtype (a
    constant coefficient may return a Python number)."""

    def coeff(p, t):
        v = fn(p, t)
        if not isinstance(v, torch.Tensor):
            v = torch.full((), float(v), dtype=t.dtype, device=t.device)
        return v.reshape(()).to(t.dtype)

    return coeff


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


class _Solver:
    """One cached solver: the coefficient functions of a Hamiltonian family,
    its dimension and the solver options.  Called on a batch of problems:
    ``neg_iH`` (terms, d, d), each term's parameters (rows, ...), start and
    end times (rows,); returns the propagators (rows, d, d)."""

    def __init__(self, coeff_fns, dim, solver, magnus_steps, atol, rtol, max_steps):
        self.coeff_fns = tuple(_per_problem(fn) for fn in coeff_fns)
        self.dim, self.solver, self.magnus_steps = dim, solver, magnus_steps
        self.atol, self.rtol, self.max_steps = atol, rtol, max_steps

    def __call__(self, neg_iH, params, t0, t1, rdt=torch.float64) -> torch.Tensor:
        """*rdt*: the precision the gates were asked in, which sets the
        adaptive solvers' default tolerance (the arithmetic is the inputs')."""
        if self.solver in ("magnus2", "magnus4"):
            return self._magnus(neg_iH, params, t0, t1)
        return self._adaptive(neg_iH, params, t0, t1, rdt)

    # ------------------------------------------------------------ fixed grid
    def _coeffs_on(self, params, times: torch.Tensor) -> List[torch.Tensor]:
        """Each term's coefficient at ``times`` (rows, M): (rows, M)."""
        return [vmap(vmap(fn, in_dims=(None, 0)), in_dims=(0, 0))(p, times)
                for fn, p in zip(self.coeff_fns, params)]

    def _magnus(self, neg_iH, params, t0, t1) -> torch.Tensor:
        rows = t0.shape[0]
        points = 2 if self.solver == "magnus4" else 1
        per_row = self.magnus_steps * points * self.dim**2
        piece = max(1, _PIECE_ELEMENTS // per_row)
        if rows > piece:
            return torch.cat([
                self._magnus(neg_iH, tuple(p[i : i + piece] for p in params),
                             t0[i : i + piece], t1[i : i + piece])
                for i in range(0, rows, piece)
            ])
        steps = self.magnus_steps
        cdt = neg_iH.dtype
        h = (t1 - t0) / steps
        n = torch.arange(steps, dtype=t0.dtype, device=t0.device)
        tn = t0[:, None] + n * h[:, None]
        hh = h[:, None, None, None]

        def generator(times: torch.Tensor) -> torch.Tensor:
            cs = self._coeffs_on(params, times)
            out = cs[0].to(cdt)[..., None, None] * neg_iH[0]
            for c, m in zip(cs[1:], neg_iH[1:]):
                out = out + c.to(cdt)[..., None, None] * m
            return out

        if self.solver == "magnus2":
            factors = _expm(hh * generator(tn + 0.5 * h[:, None]))
        else:
            both = generator(torch.stack([tn + _C1 * h[:, None], tn + _C2 * h[:, None]], -1)
                             .reshape(rows, 2 * steps)).reshape(rows, steps, 2, self.dim,
                                                                self.dim)
            A1, A2 = both[:, :, 0], both[:, :, 1]
            Ua = _expm(hh * (_A1 * A1 + _A2 * A2))
            Ub = _expm(hh * (_A2 * A1 + _A1 * A2))
            factors = torch.stack([Ua, Ub], dim=2).reshape(rows, 2 * steps, self.dim, self.dim)
        return _ordered_product(factors)

    # -------------------------------------------------------------- adaptive
    def _adaptive(self, neg_iH, params, t0, t1, asked) -> torch.Tensor:
        rdt = t0.dtype
        default_tol = 1.0e-10 if asked == torch.float64 else 1.4e-8
        eps = torch.finfo(rdt).eps
        # The reference's clamp of the tolerances to what the working
        # precision represents (it binds for float32 arithmetic only).
        atol = max(default_tol if self.atol is None else self.atol, 30 * eps)
        rtol = max(default_tol if self.rtol is None else self.rtol, 30 * eps)
        q = 8.0 if self.solver == "dopri8" else 5.0
        A_all, B_all = neg_iH.real, neg_iH.imag
        rows, d = t0.shape[0], self.dim

        def rhs(t, y):
            cs = [vmap(fn)(p, t) for fn, p in zip(self.coeff_fns, params)]
            A = cs[0][:, None, None] * A_all[0]
            B = cs[0][:, None, None] * B_all[0]
            for c, a, b in zip(cs[1:], A_all[1:], B_all[1:]):
                A = A + c[:, None, None] * a
                B = B + c[:, None, None] * b
            re = _matmul(A, y[:, 0]) - _matmul(B, y[:, 1])
            im = _matmul(A, y[:, 1]) + _matmul(B, y[:, 0])
            return torch.stack([re, im], dim=1)

        def stages(t, y, h, tab_c, tab_a):
            hb = h[:, None, None, None]
            ks = []
            for ci, arow in zip(tab_c, tab_a):
                yi = y
                for aij, k in zip(arow, ks):
                    if aij != 0.0:
                        yi = yi + (hb * aij) * k
                ks.append(rhs(t + ci * h, yi))
            return ks

        def dopri8(t, y, h):
            hb = h[:, None, None, None]
            ks = stages(t, y, h, _dp8.C, _dp8.A)
            y_new = y
            for bi, k in zip(_dp8.B, ks):
                if bi != 0.0:
                    y_new = y_new + (hb * bi) * k
            ks.append(rhs(t + h, y_new))  # FSAL-style 13th row
            with torch.no_grad():
                scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
                err5 = sum((e * k for e, k in zip(_dp8.E5, ks) if e != 0.0),
                           torch.zeros_like(y)) / scale
                err3 = sum((e * k for e, k in zip(_dp8.E3, ks) if e != 0.0),
                           torch.zeros_like(y)) / scale
                n5 = (err5**2).sum((1, 2, 3))
                n3 = (err3**2).sum((1, 2, 3))
                denom = torch.clamp(n5 + 0.01 * n3, min=torch.finfo(rdt).tiny)
                err = h.abs() * n5 / torch.sqrt(denom * y[0].numel())
            return y_new, err

        def dopri5(t, y, h):
            hb = h[:, None, None, None]
            ks = stages(t, y, h, _DP_C, _DP_A)
            y5, y4 = y, y
            for i in range(7):
                y5 = y5 + hb * _DP_B5[i] * ks[i]
                y4 = y4 + hb * _DP_B4[i] * ks[i]
            with torch.no_grad():
                scale = atol + rtol * torch.maximum(y.abs(), y5.abs())
                err = torch.sqrt((((y5 - y4) / scale) ** 2).mean((1, 2, 3)))
            return y5, err

        step_once = dopri8 if self.solver == "dopri8" else dopri5
        eye = torch.eye(d, dtype=rdt, device=t0.device)
        y = torch.stack([eye, torch.zeros_like(eye)]).expand(rows, 2, d, d)
        t = t0
        h = (t1 - t0) / 100.0
        prev = torch.ones(rows, dtype=rdt, device=t0.device)
        n = 0
        # The step controller is control flow: its choices are not
        # differentiated (the end time still is, through the last step).
        while n < self.max_steps:
            active = t < t1
            if not bool(active.any()):
                break
            h = torch.minimum(h, t1 - t)
            y_new, err = step_once(t, y, h)
            with torch.no_grad():
                accept = (err <= 1.0) & active
                err = torch.clamp(err, min=1e-10)
                factor = torch.clamp(0.9 * err ** (-0.7 / q) * prev ** (0.4 / q), 0.2, 5.0)
                h_next = torch.where(active, h * factor, h)
                prev = torch.where(accept, err, prev)
            t = torch.where(accept, t + h, t)
            y = torch.where(accept[:, None, None, None], y_new, y)
            h = h_next
            n += 1
        U = torch.complex(y[:, 0], y[:, 1])
        # Non-convergence (step budget exhausted before t1) yields NaNs so
        # an optimiser can reject the candidate.
        failed = (t < t1)[:, None, None]
        return torch.where(failed, torch.full_like(U, float("nan")), U)


# ---------------------------------------------------------------------------
# Pending operations
# ---------------------------------------------------------------------------


class _Pending:
    """What an :class:`EvolvedOperation` solves: its solver, the family's
    matrices, each term's parameters with a leading rows axis, the start
    time (rows,) or ``None`` for 0 and the end time (rows,) or a number
    shared by the rows, and *batch*: the rows of a batch, or ``None`` (one
    row, which is the operation's matrix).  Times given as numbers become
    tensors once per family, not once per gate."""

    __slots__ = ("solver", "H_mats", "params", "t0", "t1", "batch", "rows", "key")

    def __init__(self, solver, H_mats, params, t0, t1, batch, rdt, device) -> None:
        self.solver, self.H_mats, self.params = solver, H_mats, params
        self.t0, self.t1, self.batch = t0, t1, batch
        self.rows = 1 if batch is None else batch
        self.key = (id(solver), tuple(id(H) for H in H_mats), rdt, str(device),
                    tuple(tuple(p.shape[1:]) for p in params))


class EvolvedOperation(Operation):
    """A gate ``U`` solving ``dU/dt = -i H(t) U``.  Its matrix is pending
    until the recording it belongs to closes, or until it is first read."""

    @property
    def matrix(self) -> torch.Tensor:
        if self.__dict__.get("_pending") is not None:
            Evolution.resolve([self])
        return super().matrix


def _solve_dtype(values: Sequence) -> Tuple[torch.dtype, torch.device]:
    """The real dtype and device of a solve: the promotion of the floating
    tensors among *values* (the default dtype and the CPU when none is)."""
    tensors = [v for v in values if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not tensors:
        return DEFAULT_RDTYPE, torch.device("cpu")
    rdt = tensors[0].dtype
    for v in tensors[1:]:
        rdt = torch.promote_types(rdt, v.dtype)
    return rdt, tensors[0].device


class Evolution:
    """Gate factory engine for static and time-dependent Hamiltonians."""

    _evolve_solver_cache: dict = {}
    _evolve_solver_cache_lock = threading.Lock()

    # Fixed-grid Magnus by default, as in the JAX package.
    _solver_defaults: dict = {
        "max_steps": 2**13,
        "throw": True,
        "solver": "magnus4",
        "magnus_steps": 256,
    }
    _valid_solvers = ("dopri8", "dopri5", "magnus2", "magnus4")

    # Coercions applied to each default on write.
    _DEFAULT_COERCE = {
        "max_steps": int,
        "throw": bool,
        "solver": str,
        "magnus_steps": int,
    }

    # Batched solves made since the process started (one per Hamiltonian
    # family of a closed recording); read the difference around a request.
    solve_calls: int = 0

    # ------------------------------------------------------------- defaults
    @classmethod
    def set_solver_defaults(cls, **overrides) -> dict:
        """Update class-level solver defaults; returns the previous values.

        Accepts any subset of ``max_steps``, ``throw``, ``solver``,
        ``magnus_steps``; ``None`` values are ignored so the return value
        round-trips through a second call to restore.  ``throw`` keys the
        solver cache only: an adaptive solve that runs out of steps returns
        NaN either way, as the JAX package's does.
        """
        prev: dict = {}
        for knob, value in overrides.items():
            if value is None:
                continue
            coerce = cls._DEFAULT_COERCE.get(knob)
            if coerce is None:
                raise TypeError(f"Unknown solver default {knob!r}")
            if knob == "solver" and value not in cls._valid_solvers:
                raise ValueError(
                    f"Unknown solver {value!r}; expected one of {cls._valid_solvers}"
                )
            prev[knob] = cls._solver_defaults[knob]
            cls._solver_defaults[knob] = coerce(value)
        return prev

    @classmethod
    def clear_evolve_solver_cache(cls) -> None:
        """Evict every cached solver (call after coeff-fn rebuilds)."""
        with cls._evolve_solver_cache_lock:
            cls._evolve_solver_cache.clear()

    @classmethod
    def _parse_evolve_solver_options(cls, odeint_kwargs: dict) -> tuple:
        """``(atol, rtol, max_steps, throw, solver, magnus_steps)``; an
        omitted tolerance is ``None``: the solve's dtype sets it (1e-10 at
        float64, 1.4e-8 at float32)."""
        atol = odeint_kwargs.pop("atol", None)
        rtol = odeint_kwargs.pop("rtol", None)
        picked = {
            knob: coerce(odeint_kwargs.pop(knob, cls._solver_defaults[knob]))
            for knob, coerce in cls._DEFAULT_COERCE.items()
        }
        if picked["solver"] not in cls._valid_solvers:
            raise ValueError(
                f"Unknown solver {picked['solver']!r}; expected one of "
                f"{cls._valid_solvers}"
            )
        return (
            atol,
            rtol,
            picked["max_steps"],
            picked["throw"],
            picked["solver"],
            picked["magnus_steps"],
        )

    # ---------------------------------------------------------------- evolve
    @classmethod
    def evolve(
        cls,
        hamiltonian: Union["Hermitian", "ParametrizedHamiltonian"],
        name: Optional[str] = None,
        **odeint_kwargs: Any,
    ) -> Callable:
        """Gate factory dispatch: static ``exp(-itH)`` or time-dependent ODE.

        Static::

            gate = Hermitian(H_mat, wires=0).evolve()
            gate(t=0.5)                    # U = exp(-0.5j * H)

        Time-dependent::

            H_td = coeff_fn * Hermitian(H_mat, wires=0)
            H_td.evolve()([params], T)     # dU/dt = -i f(p,t) H U
        """
        if isinstance(hamiltonian, Hermitian):
            return cls._evolve_static(hamiltonian, name=name)
        if isinstance(hamiltonian, ParametrizedHamiltonian):
            return cls._evolve_parametrized(hamiltonian, name=name, **odeint_kwargs)
        raise TypeError(
            f"evolve() expects a Hermitian or ParametrizedHamiltonian, "
            f"got {type(hamiltonian)}"
        )

    @staticmethod
    def _evolve_static(hermitian: Hermitian, name: Optional[str] = None) -> Callable:
        H_mat = hermitian.matrix

        def _apply(t, wires: Union[int, List[int]] = 0) -> Operation:
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                H = _placed(H_mat, t.device, cdtype(t.dtype))
            else:
                H = H_mat
            U = torch.linalg.matrix_exp(-1j * t * H)
            return Operation(wires=wires, matrix=U, name=name)

        return _apply

    @classmethod
    def _evolve_parametrized(
        cls,
        ph: ParametrizedHamiltonian,
        name: Optional[str] = None,
        **odeint_kwargs: Any,
    ) -> Callable:
        """Gate factory solving the (multi-term) time-dependent Schrödinger
        ODE.  The returned ``apply(coeff_args, T)`` records a pending
        :class:`EvolvedOperation`; solvers are cached on the coefficient
        functions' code objects + dim + options."""
        coeff_fns = ph.coeff_fns
        H_mats = ph.H_mats
        wires = ph.wires
        n_terms = ph.n_terms
        dim = H_mats[0].shape[0]
        options = cls._parse_evolve_solver_options(odeint_kwargs)
        atol, rtol, max_steps, _, solver_name, magnus_steps = options

        cache_key = (tuple(fn.__code__ for fn in coeff_fns), dim) + options
        with cls._evolve_solver_cache_lock:
            solve = cls._evolve_solver_cache.get(cache_key)
            if solve is None:
                solve = cls._evolve_solver_cache[cache_key] = _Solver(
                    coeff_fns, dim, solver_name, magnus_steps, atol, rtol, max_steps)

        def _apply(coeff_args, T, rows: Optional[int] = None) -> Operation:
            """Record the gate for parameters *coeff_args* (one set per
            term) over ``[0, T]`` (or ``[T[0], T[1]]``).  With *rows*, a
            batch: every parameter set has a leading axis of that size and
            *T* is the rows' durations."""
            params = (
                tuple(coeff_args)
                if isinstance(coeff_args, (list, tuple))
                else (coeff_args,)
            )
            if len(params) != n_terms:
                raise ValueError(
                    f"Expected {n_terms} parameter set(s) for a "
                    f"{n_terms}-term ParametrizedHamiltonian, got {len(params)}."
                )
            rdt, device = _solve_dtype(params + (T,))
            params = tuple(torch.as_tensor(p, dtype=rdt, device=device) for p in params)
            if rows is None:
                params = tuple(p[None] for p in params)
            t0 = None  # the family's zeros, made once (see _Pending)
            if isinstance(T, (int, float)):
                t1 = float(T)
            else:
                T = torch.as_tensor(T, dtype=rdt, device=device)
                if T.dim() == 1 and rows is None:
                    t0, t1 = T[:1], T[1:2]
                else:
                    t1 = T.reshape(1) if rows is None else T.expand(rows)
            op = EvolvedOperation(wires=wires, name=name)
            op._pending = _Pending(solve, H_mats, params, t0, t1, rows, rdt, device)
            return op

        return _apply

    # --------------------------------------------------------------- resolve
    @classmethod
    def resolve(cls, ops: Sequence[EvolvedOperation]) -> None:
        """Solve the pending *ops*: one batched solve per family (solver,
        matrices, dtype, device and parameter shapes), over all of the
        family's operations and rows."""
        groups: dict = {}
        for o in ops:
            groups.setdefault(o._pending.key, []).append(o)
        for members in groups.values():
            cls._solve_family(members)

    @classmethod
    def _solve_family(cls, members: List[EvolvedOperation]) -> None:
        first = members[0]._pending
        pend = [m._pending for m in members]
        asked = first.params[0].dtype
        params = tuple(torch.cat([p.params[i] for p in pend]).to(torch.float64)
                       for i in range(len(first.params)))
        like = params[0]
        t0, t1 = (cls._family_times([p.t0 for p in pend], pend, like, 0.0),
                  cls._family_times([p.t1 for p in pend], pend, like, None))
        cdt = cdtype(t0.dtype)
        neg_iH = torch.stack([-1j * _placed(H, t0.device, cdt) for H in first.H_mats])
        U = first.solver(neg_iH, params, t0, t1, asked).to(cdtype(asked))
        cls.solve_calls += 1
        start = 0
        for m, p in zip(members, pend):
            m._matrix = U[start] if p.batch is None else U[start : start + p.rows]
            start += p.rows
            del m._pending

    @staticmethod
    def _family_times(times: list, pend: list, like: torch.Tensor, zero) -> torch.Tensor:
        """The family's start or end times (rows,): one fill when every gate
        gives the same number (``None`` reads as *zero*), else each gate's
        piece."""
        values = [zero if t is None else t for t in times]
        numbers = [v for v in values if not isinstance(v, torch.Tensor)]
        if len(numbers) == len(values) and len(set(numbers)) == 1:
            return torch.full((sum(p.rows for p in pend),), float(numbers[0]),
                              dtype=like.dtype, device=like.device)
        return torch.cat([v.to(like.dtype) if isinstance(v, torch.Tensor) else
                          torch.full((p.rows,), float(v), dtype=like.dtype, device=like.device)
                          for v, p in zip(values, pend)])
