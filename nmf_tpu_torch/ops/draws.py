"""Named random draws of a render or a train step.

nmf_tpu splits a JAX key per call site; the port takes every draw through a
``Draws``: by name from ``given`` arrays when the caller supplies them (the
parity tests replay nmf_tpu's key splits and pass the arrays in), otherwise
from an explicit ``torch.Generator``. There is no global RNG. A draw is made
on the generator's device and moved to the device the caller asks for, so
one CPU generator gives the same values to a run on the card and on the
CPU.

Names are scoped by the call path, e.g. ``jitter``, ``resample``,
``shade/app_noise``, ``shade/retrace/jitter``.
"""
import torch


class Draws:
    def __init__(self, generator=None, given=None, scope=""):
        self.generator = generator
        self.given = {} if given is None else given
        self.scope = scope

    def scoped(self, name: str) -> "Draws":
        return Draws(self.generator, self.given, f"{self.scope}{name}/")

    def _draw(self, fn, name, shape, device):
        key = self.scope + name
        shape = tuple(int(s) for s in shape)
        if key in self.given:
            t = torch.as_tensor(self.given[key], dtype=torch.float32,
                                device=device)
            if tuple(t.shape) != shape:
                raise ValueError(f"draw {key!r}: given shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            return t
        if self.generator is None:
            raise KeyError(f"draw {key!r} was not given and there is no "
                           "generator")
        return fn(shape, generator=self.generator,
                  device=self.generator.device).to(device)

    def uniform(self, name, shape, device):
        """U[0, 1) float32."""
        return self._draw(torch.rand, name, shape, device)

    def normal(self, name, shape, device):
        """N(0, 1) float32."""
        return self._draw(torch.randn, name, shape, device)
