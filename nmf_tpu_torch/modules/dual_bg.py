"""Several envmaps behind one selector (``nmf_tpu/modules/dual_bg.py``,
``MultiBG``): dual-scene training (``train_dualbg.py``) keeps one envmap a
scene and selects the active one before each step and each scene's eval.

The renderer, the trainer and the eval reach the active envmap through
the pass-throughs. Every envmap is a parameter of the model: an inactive
one takes a zero gradient and Adam still moves it through its moments.
State-dict keys: ``.bg_module.bgs[i].bg_mat`` and so on, as nmf_tpu's.
"""
import torch.nn as nn


class MultiBG(nn.Module):
    def __init__(self, bgs, bg_index: int = 0):
        super().__init__()
        self.bgs = nn.ModuleList(bgs)
        self.bg_index = int(bg_index)

    @property
    def active(self):
        return self.bgs[self.bg_index]

    def select(self, idx: int) -> "MultiBG":
        """Make envmap ``idx`` the active one (in place)."""
        self.bg_index = int(idx)
        return self

    # pass-throughs used by the renderer, the trainer and the eval
    @property
    def lr(self):
        return self.active.lr

    @property
    def mipbias_lr(self):
        return self.active.mipbias_lr

    @property
    def brightness_lr(self):
        return self.active.brightness_lr

    @property
    def mul_lr(self):
        return self.active.mul_lr

    @property
    def bg_mat(self):
        return self.active.bg_mat

    def activation_fn(self, x):
        return self.active.activation_fn(x)

    def prepare(self, with_sh: bool = True):
        return self.active.prepare(with_sh=with_sh)

    def mean_color(self):
        return self.active.mean_color()

    def tv_loss(self):
        return self.active.tv_loss()

    def get_spherical_harmonics(self, G: int = 100, mipval: float = -5.0,
                                cache=None):
        return self.active.get_spherical_harmonics(G, mipval, cache=cache)

    def forward(self, viewdirs, sa_sample, cache=None, draws=None):
        return self.active(viewdirs, sa_sample, cache=cache, draws=draws)
