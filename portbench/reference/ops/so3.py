"""SO(3) machinery for the SE(3) structure track (port of rosettafold_tpu/ops/so3.py).

Host side (float64 numpy, setup time): the real Wigner-D matrices and the
change-of-basis Q_J solved from the kernel constraint's null space, with the
reference sign table. This is the JAX package's numpy code, copied so that the
port never imports jax; tests hold the tables bit-equal to the JAX package's.

Device side (torch, float32, no grad): real spherical harmonics on the edge
vectors and the per-edge equivariant basis K_J = Y_J @ Q_J^T.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side float64 machinery (setup time only)
# ---------------------------------------------------------------------------


def _factorial(n: int) -> float:
    return float(math.factorial(n))


def wigner_small_d(l: int, beta: float) -> np.ndarray:
    """Wigner little-d matrix d^l_{m'm}(beta), (2l+1, 2l+1), rows m'=-l..l."""
    d = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.float64)
    cb, sb = math.cos(beta / 2.0), math.sin(beta / 2.0)
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(
                _factorial(l + mp) * _factorial(l - mp) * _factorial(l + m) * _factorial(l - m)
            )
            s_min = max(0, m - mp)
            s_max = min(l + m, l - mp)
            tot = 0.0
            for s in range(s_min, s_max + 1):
                num = (-1.0) ** (mp - m + s)
                den = (
                    _factorial(l + m - s)
                    * _factorial(s)
                    * _factorial(mp - m + s)
                    * _factorial(l - mp - s)
                )
                tot += (
                    num
                    / den
                    * cb ** (2 * l + m - mp - 2 * s)
                    * sb ** (mp - m + 2 * s)
                )
            d[mp + l, m + l] = pref * tot
    return d


def wigner_D_complex(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Complex Wigner D^l_{m'm}(alpha,beta,gamma) = e^{-i m' a} d^l(b) e^{-i m g}."""
    m = np.arange(-l, l + 1)
    d = wigner_small_d(l, beta)
    return (
        np.exp(-1j * m[:, None] * alpha) * d * np.exp(-1j * m[None, :] * gamma)
    )


def _complex_to_real_U(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex (rows/cols ordered m = -l..l)."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    U[l, l] = 1.0
    rt = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        U[l + m, l + m] = rt
        U[l + m, l - m] = rt * (-1.0) ** m
        U[l - m, l + m] = -1j * rt
        U[l - m, l - m] = 1j * rt * (-1.0) ** m
    return U


@functools.lru_cache(maxsize=None)
def irr_repr_np(order: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Real irreducible representation of SO(3), float64 (2l+1, 2l+1):
    D_real(a,b,c) = (U D_c(c,b,a) U^dagger)^T."""
    U = _complex_to_real_U(order)
    Dc = wigner_D_complex(order, gamma, beta, alpha)
    Dr = U @ Dc @ U.conj().T
    assert np.abs(Dr.imag).max() < 1e-10
    return np.ascontiguousarray(Dr.real.T)


def _kron(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.kron(a, b)


# The five fixed angle triples that pin the kernel constraint.
_CONSTRAINT_ANGLES = (
    (4.41301023, 5.56684102, 4.59384642),
    (4.93325116, 6.12697327, 4.14574096),
    (0.53878964, 4.09050444, 5.36539036),
    (2.16017393, 3.48835314, 5.55174441),
    (2.52385107, 0.2908958, 3.90040975),
)

# Null-space sign per (J, order_in, order_out), measured against the torch
# original's solver; unlisted keys stay canonical (max-|entry| positive).
_REFERENCE_Q_SIGNS = {
    (0, 0, 0): 1, (1, 0, 1): -1, (2, 0, 2): -1, (1, 1, 0): -1, (0, 1, 1): 1,
    (1, 1, 1): 1, (2, 1, 1): -1, (1, 1, 2): -1, (2, 1, 2): 1, (3, 1, 2): -1,
    (2, 2, 0): -1, (1, 2, 1): 1, (2, 2, 1): -1, (3, 2, 1): -1, (0, 2, 2): 1,
    (1, 2, 2): 1, (2, 2, 2): -1, (3, 2, 2): -1, (4, 2, 2): 1,
}


@functools.lru_cache(maxsize=None)
def basis_transformation_Q_J(J: int, order_in: int, order_out: int) -> np.ndarray:
    """Q_J of shape ((2*order_out+1)*(2*order_in+1), 2J+1), float64: the unique
    (up to sign) intertwiner kron(D_out, D_in) Q_J = Q_J D_J, solved as the
    common null space of Sylvester operators at the five fixed angles."""
    mats = []
    for a, b, c in _CONSTRAINT_ANGLES:
        R_tensor = _kron(irr_repr_np(order_out, a, b, c), irr_repr_np(order_in, a, b, c))
        R_J = irr_repr_np(J, a, b, c)
        syl = _kron(R_tensor, np.eye(2 * J + 1)) - _kron(np.eye(R_tensor.shape[0]), R_J.T)
        mats.append(syl)
    A = np.concatenate(mats, axis=0)
    _, s, vt = np.linalg.svd(A)
    null = vt[s < 1e-10]
    assert null.shape[0] == 1, f"non-unique null space for J={J}: {null.shape}"
    q = null[0]
    q = q * np.sign(q[np.argmax(np.abs(q))])
    q = q * _REFERENCE_Q_SIGNS.get((J, order_in, order_out), 1)
    Q = q.reshape((2 * order_out + 1) * (2 * order_in + 1), 2 * J + 1)

    rng = np.random.default_rng(0)
    for a, b, c in rng.uniform(0, 2 * math.pi, size=(4, 3)):
        R_tensor = _kron(irr_repr_np(order_out, a, b, c), irr_repr_np(order_in, a, b, c))
        assert np.allclose(R_tensor @ Q, Q @ irr_repr_np(J, a, b, c), atol=1e-10)
    return Q


# ---------------------------------------------------------------------------
# Device-side torch machinery
# ---------------------------------------------------------------------------


def spherical_from_cartesian(d: torch.Tensor):
    """(..., 3) -> (r, alpha, beta) with the permuted axis convention
    x <- d[...,2], y <- d[...,0], z <- d[...,1]."""
    x, y, z = d[..., 2], d[..., 0], d[..., 1]
    r_xy = x ** 2 + y ** 2
    r = torch.sqrt(r_xy + z ** 2)
    alpha = torch.atan2(y, x)
    beta = torch.atan2(torch.sqrt(r_xy), z)
    return r, alpha, beta


def _semifactorial(x: int) -> float:
    y = 1.0
    for n in range(x, 1, -2):
        y *= n
    return y


def _pochhammer(x: int, k: int) -> float:
    xf = float(x)
    for n in range(x + 1, x + k):
        xf *= n
    return xf


def _assoc_legendre_all(l_max: int, x: torch.Tensor) -> Dict:
    """All P_l^m(x) for 0 <= m <= l <= l_max, Condon-Shortley phase."""
    P = {(0, 0): torch.ones_like(x)}
    if l_max == 0:
        return P
    somx2 = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    for m in range(1, l_max + 1):
        P[(m, m)] = ((-1.0) ** m * _semifactorial(2 * m - 1)) * somx2 ** m
    for m in range(0, l_max):
        P[(m + 1, m)] = x * (2 * m + 1) * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (
                (2 * l - 1) / (l - m) * x * P[(l - 1, m)]
                - (l + m - 1) / (l - m) * P[(l - 2, m)]
            )
    return P


def real_spherical_harmonics(l_max: int, theta, phi) -> Dict[int, torch.Tensor]:
    """Tesseral harmonics Y_l (..., 2l+1) for all l <= l_max, CS phase."""
    ct = torch.cos(theta)
    P = _assoc_legendre_all(l_max, ct)
    out = {}
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            N = math.sqrt((2 * l + 1) / (4 * math.pi))
            if m == 0:
                cols.append(N * P[(l, 0)])
                continue
            N *= math.sqrt(2.0 / _pochhammer(l - am + 1, 2 * am))
            if m > 0:
                cols.append(N * torch.cos(am * phi) * P[(l, am)])
            else:
                cols.append(N * torch.sin(am * phi) * P[(l, am)])
        out[l] = torch.stack(cols, dim=-1)
    return out


def precompute_sh(alpha, beta, max_J: int) -> Dict[int, torch.Tensor]:
    """Y_J at (theta = pi - beta, phi = alpha) for J <= max_J."""
    return real_spherical_harmonics(max_J, math.pi - beta, alpha)


def q_tables(max_degree: int) -> Dict[str, torch.Tensor]:
    """Q_J^T as float32 tensors, keyed '{J}_{d_in}_{d_out}', for every
    (d_in, d_out) up to max_degree: the constants of `equivariant_basis`,
    which modules keep as registered buffers."""
    return {
        f"{J}_{d_in}_{d_out}": torch.as_tensor(
            basis_transformation_Q_J(J, d_in, d_out).T, dtype=torch.float32)
        for d_in in range(max_degree + 1)
        for d_out in range(max_degree + 1)
        for J in range(abs(d_in - d_out), d_in + d_out + 1)
    }


@torch.no_grad()
def equivariant_basis(d: torch.Tensor, max_degree: int,
                      tables: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-edge equivariant basis, float32, without gradient.

    d (..., 3) edge vectors (dst - src); tables: `q_tables(max_degree)` on d's
    device (built here when None). Returns basis['{d_in},{d_out}'] of shape
    (..., 2*d_out+1, 2*d_in+1, 2*min(d_in,d_out)+1)."""
    d = d.detach().float()
    if tables is None:
        tables = {k: v.to(d.device) for k, v in q_tables(max_degree).items()}
    _, alpha, beta = spherical_from_cartesian(d)
    Y = precompute_sh(alpha, beta, 2 * max_degree)
    basis = {}
    for d_in in range(max_degree + 1):
        for d_out in range(max_degree + 1):
            K_Js = []
            for J in range(abs(d_in - d_out), d_in + d_out + 1):
                K_Js.append(Y[J] @ tables[f"{J}_{d_in}_{d_out}"])
            stacked = torch.stack(K_Js, dim=-1)
            od, idim = 2 * d_out + 1, 2 * d_in + 1
            basis[f"{d_in},{d_out}"] = stacked.reshape(
                *stacked.shape[:-2], od, idim, stacked.shape[-1])
    return basis


@torch.no_grad()
def edge_radii(d: torch.Tensor) -> torch.Tensor:
    """Edge lengths (..., 1), without gradient."""
    d = d.detach()
    return torch.sqrt((d ** 2).sum(-1, keepdim=True))
