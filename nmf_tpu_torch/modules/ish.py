"""Integrated spherical-harmonic direction encoder ``ListISH``
(``nmf_tpu/modules/ish.py``): the SH bases of a list of degrees, each band
attenuated by a vMF lobe of concentration 1 / (roughness + 1e-3)."""
from ..ops import sh


class ListISH:
    def __init__(self, degs=(0, 1, 2, 4)):
        self.degs = tuple(int(d) for d in degs)

    def dim(self) -> int:
        return sh.sh_basis_dim(self.degs)

    def __call__(self, vecs, roughness=None):
        kappa = 1.0 / (roughness + 1e-3) if roughness is not None else None
        return sh.sh_basis(self.degs, vecs, kappa)
