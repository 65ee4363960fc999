"""Plain gate-by-gate reference of the Circuit_19 data-reuploading model.

Written from the circuit's published description (Sim, Johnson and
Aspuru-Guzik, arXiv:1905.10876, circuit 19) and the model's documented
layout, with no code of the program under test:

* a layer is RX on every qubit, RZ on every qubit, then a ring of CRX
  gates, control ``c`` on target ``(c + 1) % n`` for ``c = n-1, n-2, ..., 0``;
  a layer's parameters are ``[RX(q) for q] + [RZ(q) for q] + [CRX in ring
  order]`` (``3 n`` angles);
* ``layers`` encodings, each RX(x) on every qubit after an ansatz layer,
  and a closing ansatz layer after the last one (``layers + 1`` parameter
  layers);
* wire 0 is the first tensor axis; the readout is ``<Z_q>`` for every
  qubit ``q``;
* with depolarizing noise ``p``, every gate is followed by the channel
  ``(1 - p) rho + p/3 (X rho X + Y rho Y + Z rho Z)`` on each of its wires
  (control first), encodings included.

Each gate is a dense product on its own qubits: a state is a tensor with
one axis of size 2 a qubit (two a qubit for a density matrix, rows then
columns) behind a batch axis, and each block of the output is the sum of the
gate's entries times the input's blocks.
A density matrix takes a gate as ``U`` on its rows and ``conj(U)`` on its
columns, and a channel as the superoperator ``sum_k K (x) conj(K)`` on a
qubit's row and column.

``precision="float64"`` computes in complex128.  ``precision="tf32"`` is the
control: complex64 with both operands of every gate product rounded to TF32
(10 mantissa bits) and the sums in float32, as a TF32 tensor core computes.

Gradients follow the adjoint method by hand (no autograd: a 24-qubit batch's
intermediate states would not fit): ``d<O>/dtheta = Im <lambda| G psi>`` for a
gate ``exp(-i theta G / 2)`` with ``psi`` and ``lambda`` both taken after it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

# Kinds of the gate list: a trainable gate carries its parameter slot
# (layer, index); an encoding carries the input.
Gate = Tuple[str, Tuple[int, ...], Optional[Tuple[int, int]]]

_DTYPES = {"float64": torch.complex128, "tf32": torch.complex64}


def gates(n: int, layers: int) -> List[Gate]:
    """The circuit in order: ``(kind, wires, slot)``, kind RX / RZ / CRX /
    ENC (RX of the input)."""
    out: List[Gate] = []

    def ansatz(layer: int) -> None:
        out.extend(("RX", (q,), (layer, q)) for q in range(n))
        out.extend(("RZ", (q,), (layer, n + q)) for q in range(n))
        for j, c in enumerate(range(n - 1, -1, -1)):
            out.append(("CRX", (c, (c + 1) % n), (layer, 2 * n + j)))

    for layer in range(layers):
        ansatz(layer)
        out.extend(("ENC", (q,), None) for q in range(n))
    ansatz(layers)
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round a complex64 tensor's parts to TF32: 10 mantissa bits, to
    nearest."""
    bits = torch.view_as_real(t.resolve_conj().contiguous()).view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return torch.view_as_complex(bits.view(torch.float32))


class Circuit19:
    """The reference simulator of one configuration on one device."""

    def __init__(self, n: int, layers: int, depolarizing: float = 0.0,
                 precision: str = "float64", device="cpu") -> None:
        self.n, self.layers, self.p = n, layers, depolarizing
        self.precision, self.device = precision, torch.device(device)
        self.cdtype = _DTYPES[precision]
        self.rdtype = torch.float64 if precision == "float64" else torch.float32
        self.gates = gates(n, layers)

    # ------------------------------------------------------------ matrices
    def _c(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=self.cdtype, device=self.device)

    def rx(self, theta: torch.Tensor) -> torch.Tensor:
        """``(B, 2, 2)`` for angles ``(B,)``."""
        c, s = torch.cos(theta / 2), torch.sin(theta / 2)
        m = torch.zeros(theta.shape + (2, 2), dtype=self.cdtype, device=self.device)
        m[..., 0, 0] = m[..., 1, 1] = c.to(self.cdtype)
        m[..., 0, 1] = m[..., 1, 0] = -1j * s.to(self.cdtype)
        return m

    def rz(self, theta: torch.Tensor) -> torch.Tensor:
        m = torch.zeros(theta.shape + (2, 2), dtype=self.cdtype, device=self.device)
        m[..., 0, 0] = torch.exp(-0.5j * theta.to(self.cdtype))
        m[..., 1, 1] = torch.exp(0.5j * theta.to(self.cdtype))
        return m

    def crx(self, theta: torch.Tensor) -> torch.Tensor:
        m = torch.zeros(theta.shape + (4, 4), dtype=self.cdtype, device=self.device)
        m[..., 0, 0] = m[..., 1, 1] = 1
        m[..., 2:, 2:] = self.rx(theta)
        return m

    def matrix(self, gate: Gate, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The gate's matrix, ``(B, d, d)`` or ``(1, d, d)``."""
        kind, _, slot = gate
        if kind == "ENC":
            return self.rx(x)
        theta = params[slot].reshape(1)
        return {"RX": self.rx, "RZ": self.rz, "CRX": self.crx}[kind](theta)

    def generator(self, gate: Gate) -> torch.Tensor:
        """``G`` of ``exp(-i theta G / 2)``."""
        X = self._c([[0, 1], [1, 0]])
        if gate[0] == "RX":
            return X
        if gate[0] == "RZ":
            return self._c([[1, 0], [0, -1]])
        g = torch.zeros((4, 4), dtype=self.cdtype, device=self.device)
        g[2:, 2:] = X
        return g

    # ------------------------------------------------------------- products
    def apply(self, state: torch.Tensor, u: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
        """``u`` (``(d, d)`` or ``(B or 1, d, d)``, ``d = 2^k``, k = 1 or 2) on
        the state's qubit axes ``axes`` (counted after the batch axis), in
        their order.  Each output block is the sum of ``u``'s nonzero entries
        times the state's blocks, on views of the state (no axis is moved)."""
        k = len(axes)
        if u.dim() == 2:
            u = u[None]
        if k == 2 and axes[0] > axes[1]:  # the matrix in sorted-axis order
            perm = torch.tensor([0, 2, 1, 3], device=u.device)
            u, axes = u[:, perm][:, :, perm], (axes[1], axes[0])
        if self.precision == "tf32":
            state, u = tf32(state), tf32(u)
        B, m = state.shape[0], state.dim() - 1
        cuts = [0, *(a + 1 for a in axes), m]  # the qubits before, between, after
        shape = [B]
        for i in range(k):
            shape += [2 ** (cuts[i + 1] - 1 - cuts[i]), 2]
        shape.append(2 ** (m - cuts[-2]))
        x = state.reshape(shape)
        out = torch.empty_like(x)
        nz = (u != 0).flatten(1).any(0).view(2**k, 2**k).tolist()
        coef = u.reshape(u.shape[0], 2**k, 2**k, *([1] * (len(shape) - 1 - k)))

        def block(t, idx):
            sel = [slice(None)] * len(shape)
            for i, bit in enumerate(idx):
                sel[2 + 2 * i] = bit
            return t[tuple(sel)]

        bits = [(i,) if k == 1 else (i >> 1, i & 1) for i in range(2**k)]
        for r in range(2**k):
            o = block(out, bits[r])
            terms = [c for c in range(2**k) if nz[r][c]]
            if not terms:
                o.zero_()
                continue
            torch.mul(block(x, bits[terms[0]]), coef[:, r, terms[0]], out=o)
            for c in terms[1:]:
                o.addcmul_(block(x, bits[c]), coef[:, r, c])
        return out.reshape(state.shape)

    def superop(self, mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """``sum_k K (x) conj(K)`` for matrices ``(B or 1, d, d)``."""
        out = 0
        for m in mats:
            b, d = m.shape[0], m.shape[-1]
            out = out + torch.einsum("bij,bkl->bikjl", m, m.conj()).reshape(b, d * d, d * d)
        return out

    def kraus_depolarizing(self) -> List[torch.Tensor]:
        p = self.p
        paulis = ([[1, 0], [0, 1]], [[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]])
        scales = (math.sqrt(1 - p),) + (math.sqrt(p / 3),) * 3
        return [s * self._c(m)[None] for s, m in zip(scales, paulis)]

    # ------------------------------------------------------------- circuits
    def pure(self, params: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Final states ``(B, 2, ..., 2)`` for parameters ``(layers + 1, 3n)``
        and inputs ``(B,)``."""
        B = xs.shape[0]
        psi = torch.zeros((B,) + (2,) * self.n, dtype=self.cdtype, device=self.device)
        psi.view(B, -1)[:, 0] = 1
        for gate in self.gates:
            psi = self.apply(psi, self.matrix(gate, params, xs), gate[1])
        return psi

    def mixed(self, params: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Final density matrices ``(B, 2, ..., 2)`` (rows then columns)."""
        n, B = self.n, xs.shape[0]
        rho = torch.zeros((B,) + (2,) * (2 * n), dtype=self.cdtype, device=self.device)
        rho.view(B, -1)[:, 0] = 1
        noise = self.superop(self.kraus_depolarizing()) if self.p else None
        for gate in self.gates:
            wires = gate[1]
            u = self.matrix(gate, params, xs)
            rho = self.apply(rho, u, wires)  # U rho
            rho = self.apply(rho, u.conj(), [n + w for w in wires])  # (U rho) U^dag
            if noise is not None:
                for w in wires:
                    rho = self.apply(rho, noise, [w, n + w])
        return rho

    def expvals(self, state: torch.Tensor, density: bool = False) -> torch.Tensor:
        """``<Z_q>`` for every qubit, ``(B, n)``, real."""
        n, B = self.n, state.shape[0]
        if density:
            probs = state.reshape(B, 2**n, 2**n).diagonal(dim1=1, dim2=2).real
        else:
            probs = state.reshape(B, -1).abs() ** 2
        probs = probs.reshape((B,) + (2,) * n).to(self.rdtype)
        out = []
        for q in range(n):
            pq = torch.movedim(probs, 1 + q, -1).reshape(B, -1, 2).sum(1)
            out.append(pq[:, 0] - pq[:, 1])
        return torch.stack(out, dim=1)

    def forward(self, params: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """The model's answer ``(B, n)``: pure without noise, else mixed."""
        if self.p:
            return self.expvals(self.mixed(params, xs), density=True)
        return self.expvals(self.pure(params, xs))

    # ------------------------------------------------------------ gradients
    def _z_sum(self) -> torch.Tensor:
        """The diagonal of ``sum_q Z_q`` as a ``(2,) * n`` tensor."""
        n = self.n
        d = torch.zeros((2,) * n, dtype=self.rdtype, device=self.device)
        sign = torch.tensor([1.0, -1.0], dtype=self.rdtype, device=self.device)
        for q in range(n):
            d = d + sign.view([2 if i == q else 1 for i in range(n)])
        return d

    def mse(self, params: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> float:
        """The loss ``mean_b (mean_q <Z_q>_b - y_b)^2`` of the noise-free
        model."""
        f = self.expvals(self.pure(params, xs)).mean(dim=1)
        return float(((f - ys) ** 2).mean())

    def mse_and_grad(self, params: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> Tuple[float, torch.Tensor]:
        """:meth:`mse` and its gradient with respect to ``params``."""
        n, B = self.n, xs.shape[0]
        psi = self.pure(params, xs)
        f = self.expvals(psi).mean(dim=1)
        loss = ((f - ys) ** 2).mean()
        coef = (2 * (f - ys) / (B * n)).view((B,) + (1,) * n)
        lam = psi * (coef * self._z_sum()).to(self.cdtype)
        grad = torch.zeros_like(params, dtype=self.rdtype)
        for gate in reversed(self.gates):
            wires, slot = gate[1], gate[2]
            if slot is not None:
                v = self.apply(psi, self.generator(gate), wires)
                grad[slot] += torch.vdot(lam.reshape(-1), v.reshape(-1)).imag
            u_dag = self.matrix(gate, params, xs).conj().transpose(-1, -2)
            psi = self.apply(psi, u_dag, wires)
            lam = self.apply(lam, u_dag, wires)
        return float(loss), grad


def params_shape(config: dict) -> Tuple[int, int]:
    """The parameters of one model: ``(layers + 1, 3 n)``."""
    return config["n_layers"] + 1, 3 * config["n_qubits"]


def simulator(config: dict, precision: str = "float64", device="cpu") -> Circuit19:
    """The reference of a configuration (Circuit_19, noise-free or with
    depolarizing noise alone)."""
    noise = dict(config.get("noise") or {})
    p = noise.pop("Depolarizing", 0.0)
    if config["circuit"] != "Circuit_19" or any(noise.values()):
        raise NotImplementedError(f"no reference for {config['circuit']} with noise {noise}")
    return Circuit19(config["n_qubits"], config["n_layers"], p, precision, device)


# Kraus operators of each single-qubit channel this reference simulates.
KRAUS = {"Depolarizing": 4}


def flop_inputs(config: dict) -> dict:
    """What the model flops of one circuit evaluation count
    (:func:`benchmark.lib.work.model_flops`): each gate's wires in order, the
    register, whether it is a density matrix, and the Kraus operators that
    follow each gate on each of its wires, summed over the channels."""
    noise = {k: v for k, v in (config.get("noise") or {}).items() if v}
    return {"gate_wires": [g[1] for g in gates(config["n_qubits"], config["n_layers"])],
            "n": config["n_qubits"], "density": bool(noise),
            "kraus": sum(KRAUS[k] for k in noise)}


class Adam:
    """Adam (Kingma and Ba, arXiv:1412.6980) as ``torch.optim.Adam`` states
    it, with its defaults: ``p -= lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + eps)``."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t, self.m, self.v = 0, None, None

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        denom = self.v.sqrt() / math.sqrt(1 - self.b2**self.t) + self.eps
        return p - self.lr / (1 - self.b1**self.t) * self.m / denom
