"""Integrated spherical-harmonic direction encoders
(``nmf_tpu/modules/ish.py``). Each takes ``(vecs (N, 3), roughness)`` and
has no parameters, so none has a state-dict key.

- ``ListISH``: the SH bases of a list of degrees (0, 1, 2, 4, 8), each band
  attenuated by a vMF lobe of concentration 1 / (roughness + 1e-3);
- ``FullISH``: every band up to ``max_degree`` (roughness ignored);
  ``FullISHScaled``: the same, attenuated at 1 / (roughness + 1e-8);
- ``SHBasis``: one degree's [Y_l^0, Re Y_l^l, Im Y_l^l] of the polar
  angles (theta, phi), attenuated; ``ISH`` stacks degrees 1, 2, 4, ...;
- ``RandISH``: ``rand_n`` randomly rotated single-degree bases, two
  channels each; ``RandRotISH``: a core ListISH and ``rand_n`` rotated
  copies of a high-degree ListISH;
- ``LHyperGeom``: a truncated hypergeometric series (no builder target
  reaches it, in nmf_tpu either).

The random rotations are nmf_tpu's: angles U(0, 2 pi) of
``numpy.random.default_rng(seed)`` turned into extrinsic x-y-z rotation
matrices (scipy's ``Rotation.from_euler("xyz", ...)``), computed here in
numpy. The Legendre coefficients are numpy's exact ones
(``legendre.leg2poly``); nmf_tpu takes scipy's, which agree to rounding.
"""
import math

import numpy as np
import torch

from ..ops import sh
from ..ops.safemath import safe_atan2


class ListISH:
    def __init__(self, degs=(0, 1, 2, 4)):
        self.degs = tuple(int(d) for d in degs)

    def dim(self) -> int:
        return sh.sh_basis_dim(self.degs)

    def __call__(self, vecs, roughness=None):
        kappa = 1.0 / (roughness + 1e-3) if roughness is not None else None
        return sh.sh_basis(self.degs, vecs, kappa)


class FullISH:
    def __init__(self, max_degree=1):
        self.max_degree = int(max_degree)

    def dim(self) -> int:
        return (self.max_degree + 1) ** 2

    def __call__(self, vecs, roughness=None):
        return sh.eval_sh_bases(self.dim(), vecs)


class FullISHScaled(FullISH):
    def __call__(self, vecs, roughness):
        kappa = 1.0 / (roughness + 1e-8)
        return sh.eval_sh_bases_scaled(self.dim(), vecs, kappa.reshape(-1))


def legendre_coeffs(l: int):
    """P_l's coefficients, constant term first."""
    return tuple(float(c) for c in
                 np.polynomial.legendre.leg2poly([0] * l + [1]))


class SHBasis:
    """Degree ``deg``'s attenuated [Y_l^0, Re Y_l^l, Im Y_l^l] of the polar
    angle theta and the azimuth phi (each (N, 1)) and kappa (N, 1) ->
    (N, 3)."""

    def __init__(self, deg=1):
        self.deg = int(deg)

    def dim(self) -> int:
        return 3

    def __call__(self, theta, phi, kappa):
        l = self.deg
        c = torch.tensor(legendre_coeffs(l), dtype=theta.dtype,
                         device=theta.device)
        x = torch.cos(theta)
        powers = torch.arange(len(c), dtype=theta.dtype, device=theta.device)
        v = (x[..., None] ** powers * c).sum(-1)
        y0 = math.sqrt((2 * l + 1) / 4 / math.pi) * v
        logcoeff = (-2 * math.log(max(l, 1)) - math.lgamma(l + 1)
                    + 0.5 * (math.lgamma(2 * l + 2) - math.log(4 * math.pi)))
        coeff = (-1) ** l * math.exp(logcoeff)
        sl = torch.sin(theta) ** l
        yl1 = coeff * sl * torch.cos(l * phi)
        yl2 = coeff * sl * torch.sin(l * phi)
        return sh.Al(l, kappa) * torch.cat([y0, yl1, yl2], dim=-1)


def dirs_to_angles(vec):
    """(N, 3) -> polar angle theta (from +z) and azimuth phi, each
    (N, 1)."""
    a, b, c = vec[:, 0:1], vec[:, 1:2], vec[:, 2:3]
    norm2d = torch.sqrt(a ** 2 + b ** 2)
    phi = safe_atan2(b, a)
    theta = safe_atan2(c, norm2d) - math.pi / 2
    return theta, phi


class ISH:
    """SHBasis of degrees 1, 2, 4, ..., 2^(max_degree - 1), side by
    side."""

    def __init__(self, max_degree=1):
        self.max_degree = int(max_degree)

    def dim(self) -> int:
        return 3 * self.max_degree

    def __call__(self, vec, roughness):
        kappa = 1.0 / (roughness + 1e-8)
        theta, phi = dirs_to_angles(vec)
        return torch.cat([SHBasis(2 ** i)(theta, phi, kappa[..., None])
                          for i in range(self.max_degree)], dim=-1)


def random_rotations(n: int, seed: int):
    """(n, 3, 3) float64: Rz(c) Ry(b) Rx(a) of angles (a, b, c) ~ U(0,
    2 pi) from ``default_rng(seed)`` (extrinsic x, y, z)."""
    angs = np.random.default_rng(seed).uniform(0, 2 * np.pi, (n, 3))
    mats = []
    for a, b, c in angs:
        ca, sa, cb, sb, cc, sc = (np.cos(a), np.sin(a), np.cos(b),
                                  np.sin(b), np.cos(c), np.sin(c))
        rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
        mats.append(rz @ ry @ rx)
    return np.stack(mats)


class _Rotated:
    """The rotation matrices as float32 tensors, one copy a device."""

    def mats(self, device):
        if device not in self._mats:
            self._mats[device] = torch.tensor(self.rotations,
                                              dtype=torch.float32,
                                              device=device)
        return self._mats[device]


class RandISH(_Rotated):
    """``rand_n`` single-degree bases of randomly rotated directions, the
    degrees clip(N(0, std), 1, 9) of ``default_rng(seed + 1)``; channels
    Y_l^0 and Re Y_l^l of each."""

    def __init__(self, rand_n=8, std=10.0, seed=0):
        self.rand_n = int(rand_n)
        self.rotations = random_rotations(self.rand_n, seed)
        rng = np.random.default_rng(seed + 1)
        self.degs = tuple(int(d) for d in np.clip(
            rng.normal(0, std, (self.rand_n,)), 1, 9).astype(int))
        self._mats = {}

    def dim(self) -> int:
        return self.rand_n * 2

    def __call__(self, vec, roughness):
        kappa = (1.0 / (roughness + 1e-8)).reshape(-1, 1)
        outs = []
        for mat, deg in zip(self.mats(vec.device), self.degs):
            theta, phi = dirs_to_angles(vec @ mat)
            basis = SHBasis(deg)(theta, phi, kappa)
            outs.append(torch.stack([basis[:, 0], basis[:, 1]], dim=1))
        return torch.cat(outs, dim=1)


class RandRotISH(_Rotated):
    """ListISH(core_degs) of the directions beside ListISH(rand_degs) of
    ``rand_n`` random rotations of them."""

    def __init__(self, rand_n=4, core_degs=(1, 2, 4, 8), rand_degs=(8,),
                 seed=0):
        self.rand_n = int(rand_n)
        self.core = ListISH(core_degs)
        self.rand = ListISH(rand_degs)
        self.rotations = random_rotations(self.rand_n, seed)
        self._mats = {}

    def dim(self) -> int:
        return self.rand_n * self.rand.dim() + self.core.dim()

    def __call__(self, vec, roughness):
        B = vec.shape[0]
        rvecs = torch.einsum("bk,nkj->bnj", vec,
                             self.mats(vec.device)).reshape(-1, 3)
        rrough = roughness.reshape(B, 1).expand(B, self.rand_n).reshape(-1)
        return torch.cat([self.core(vec, roughness),
                          self.rand(rvecs, rrough).reshape(B, -1)], dim=-1)


class LHyperGeom:
    """Truncated generalized hypergeometric series
    sum_k prod (upper)_k / prod (lower)_k x^k / k! over k < N, the rising
    factorials (a)_k taken in float64 on the host and the series in the
    dtype of ``x``; nmf_tpu's, used by its fractional-degree Y0
    experiments. No builder target reaches it."""

    def __init__(self, upper=(), lower=(), N=20):
        self.upper = tuple(upper)
        self.lower = tuple(lower)
        self.N = int(N)

    @staticmethod
    def _rising(z, m):
        if m == 0:
            return 1.0
        if z < 0 and z % 1 == 0:
            return 0.0
        return math.gamma(z + m) / math.gamma(z)

    def coeffs(self):
        """(upper products / k!, lower products) for k < N, float64."""
        up = [math.prod(self._rising(a, k) for a in self.upper)
              / math.factorial(k) for k in range(self.N)]
        lo = [math.prod(self._rising(a, k) for a in self.lower)
              for k in range(self.N)]
        return up, lo

    def __call__(self, x):
        up, lo = (torch.tensor(c, dtype=x.dtype, device=x.device)
                  for c in self.coeffs())
        expx = x[..., None] ** torch.arange(self.N, device=x.device)
        return (up * expx / lo).sum(dim=-1)
