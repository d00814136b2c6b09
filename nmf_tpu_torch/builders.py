"""Instantiate the composed model from a hydra-style config dict
(``nmf_tpu/builders.py``) for the targets of this slice: the TensorVMSplit
field, the AlphaGridSampler and the TensoRF shading model. Every other
target raises ``NotImplementedError`` naming the slice that brings it.
"""
import torch

from .fields.tensorf import init_tensorvm_split
from .models.tensorf import init_tensorf_shade
from .render import NMF
from .samplers.alphagrid import AlphaGridSampler

_LATER = "is not ported yet: it comes with the microfacet slice of nmf_tpu_torch"


def _target(cfg):
    return (cfg or {}).get("_target_", "")


def _clean(cfg):
    return {k: v for k, v in (cfg or {}).items() if not k.startswith("_")}


def build_field(generator, cfg, aabb):
    t = _target(cfg)
    if not (t.endswith("TensorVMSplit") or not t):
        raise NotImplementedError(f"field {t!r} {_LATER}")
    kw = _clean(cfg)
    for key, why in (("fixed_shape", "fixed_shape padding"),
                     ("dbasis", "dbasis"), ("contract_space",
                                            "contract_space"),
                     ("num_pretrain", "density pretraining"),
                     ("calibrate", "density calibration")):
        if kw.get(key):
            raise NotImplementedError(f"field.{key} ({why}) {_LATER}")
    allowed = {"density_n_comp", "appearance_n_comp", "app_dim", "grid_size",
               "N_voxel_init", "N_voxel_final", "upsamp_list", "init_mode",
               "d_init_val", "app_init_val", "activation", "density_shift",
               "step_ratio", "gather_dtype", "lr", "lr_net",
               "distance_scale"}
    kw = {k: v for k, v in kw.items() if k in allowed}
    if "upsamp_list" in kw:
        kw["upsamp_list"] = tuple(kw["upsamp_list"])
    return init_tensorvm_split(generator, aabb, **kw)


def build_sampler(cfg, aabb, near_far):
    t = _target(cfg)
    if t and not t.endswith("AlphaGridSampler"):
        raise NotImplementedError(f"sampler {t!r} {_LATER}")
    kw = _clean(cfg)
    allowed = {"enable_alpha_mask", "update_list", "multiplier",
               "alphaMask_thres"}
    kw = {k: v for k, v in kw.items() if k in allowed}
    if "update_list" in kw:
        kw["update_list"] = tuple(kw["update_list"])
    if "alphaMask_thres" in kw:
        kw["alpha_mask_thres"] = kw.pop("alphaMask_thres")
    return AlphaGridSampler(aabb, near_far=near_far, **kw)


def build_model(generator, cfg, app_dim):
    t = _target(cfg)
    if not (t.endswith("TensoRF") or not t):
        raise NotImplementedError(f"model {t!r} {_LATER}")
    dm_cfg = _clean(cfg).get("diffuse_module") or {}
    if _target(dm_cfg).endswith("MLPRender_PE"):
        raise NotImplementedError(f"diffuse module MLPRender_PE {_LATER}")
    return init_tensorf_shade(app_dim, generator=generator, **_clean(dm_cfg))


def build_nmf(arch_cfg, aabb, near_far, seed=0, device="cuda") -> NMF:
    """Build the composed model from cfg.model.arch on ``device``. Initial
    values are drawn on the CPU from a generator seeded with ``seed``, so a
    seed gives the same model on every device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch sees no CUDA device; "
                           "pass device=cpu to run on the CPU")
    for key in ("bg_module", "normal_module", "hdr"):
        if arch_cfg.get(key):
            raise NotImplementedError(f"model.arch.{key} {_LATER}")
    for key in ("proposal_samples_per_ray", "app_samples_per_ray",
                "merge_runs"):
        if int(arch_cfg.get(key, -1) or -1) > 0:
            raise NotImplementedError(f"model.arch.{key} {_LATER}")
    gen = torch.Generator().manual_seed(int(seed))
    rf = build_field(gen, arch_cfg.get("rf", {}), aabb)
    sampler = build_sampler(arch_cfg.get("sampler", {}), aabb, near_far)
    model = build_model(gen, arch_cfg.get("model", {}), rf.app_dim)
    tm_t = _target(arch_cfg.get("tonemap") or {})
    if tm_t and "SRGB" not in tm_t:
        raise NotImplementedError(f"tonemap {tm_t!r} {_LATER}")
    nmf = NMF(rf, sampler, model,
              max_samples_per_ray=arch_cfg.get("max_samples_per_ray", -1),
              eval_batch_size=arch_cfg.get("eval_batch_size", 4096),
              lr_scale=arch_cfg.get("lr_scale", 1.0)).to(device)
    sampler.update(rf, init=True)
    return nmf
