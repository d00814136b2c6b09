"""Plain TensoRF shading (``nmf_tpu/models/tensorf.py``): one
view-dependent colour head (MLPRender_Fea, or MLPRender_PE with
``head="pe"``), no normals."""
import torch.nn as nn

from ..modules.render_modules import MLPRenderFea, MLPRenderPE


class TensoRFShade(nn.Module):
    def __init__(self, diffuse_module):
        super().__init__()
        self.diffuse_module = diffuse_module

    def needs_normals(self, recur: int) -> bool:
        return False

    def check_schedule(self, iteration: int) -> bool:
        return False

    def shade(self, xyz, xyz_normed, app_features, viewdirs, normals,
              weights, valid, B, **kwargs):
        return self.diffuse_module(xyz_normed, viewdirs, app_features), {}


def init_tensorf_shade(app_dim, viewpe=6, feape=6, pospe=6, featureC=128,
                       lr=1e-3, head="fea", generator=None, **_):
    if head == "pe":
        return TensoRFShade(MLPRenderPE(app_dim, viewpe=viewpe, pospe=pospe,
                                        featureC=featureC, lr=lr,
                                        generator=generator))
    return TensoRFShade(MLPRenderFea(app_dim, viewpe=viewpe, feape=feape,
                                     featureC=featureC, lr=lr,
                                     generator=generator))
