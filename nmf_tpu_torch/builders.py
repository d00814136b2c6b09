"""Instantiate the composed model from a hydra-style config dict
(``nmf_tpu/builders.py``) for the targets of the ported slices: every
field nmf_tpu builds (TensorVMSplit with all its options, the hash-grid
field HashGridRF and TCNNRF, which nmf_tpu maps onto it, and the dense
voxel field GridRF / Grid), the AlphaGridSampler and the occupancy-grid
sampler (which the upstream NerfAccSampler / Raymarcher /
ContinuousAlphagrid targets map onto), the TensoRF (MLPRender_Fea or
MLPRender_PE head), Microfacet, RefNeRF and DualModel shading models
(the material heads RandHydraMLPDiffuse, HydraMLPDiffuse, MLPDiffuse and
PassthroughDiffuse; MLPBRDF with every activation and ``dotpe``; every
direction encoder of nmf_tpu's; GGX, Beckmann, cosine-lobe or mixed
bounce sampling; the VisibilityMLP cache and the bright-ray samplers),
the MLPNormal / AppDimNormal normal modules, the IntegralEquirect envmap
with its activations, ``mipnoise`` and ``sh_grad``, the SRGB / HDR /
Linear tonemaps, bf16 MLP operands (``mlp_dtype``) and the renderer's
sample budgets. The targets nmf_tpu itself cannot run (a Specular BRDF in
a Microfacet, an SHBasis encoder) raise naming ROADMAP C.12. Every other
target does what nmf_tpu's builders do with it: an unknown field, model,
envmap, normal module, visibility module, bright sampler, BRDF sampler,
material head or encoder raises ``ValueError`` "unknown ... target"; any
other sampler target builds the AlphaGridSampler, and any other BRDF
target the MLPBRDF.
"""
import math

import torch

from .fields.grid import init_grid_rf
from .fields.hashgrid import init_hashgrid_rf
from .fields.tensorf import init_tensorvm_split
from .models.microfacet import init_microfacet
from .models.refnerf import DualModel, init_refnerf
from .models.tensorf import init_tensorf_shade
from .modules.bg import init_integral_equirect
from .modules.brdf import init_mlp_brdf
from .modules.brdf_samplers import (BeckmannSampler, CosineLobeSampler,
                                    GGXSampler, MultiSampler)
from .modules.ish import (ISH, FullISH, FullISHScaled, ListISH, RandISH,
                          RandRotISH)
from .modules.mlp import set_mlp_dtype
from .modules.render_modules import (PE, AppDimNormal, HydraMLPDiffuse,
                                     MLPDiffuse, PassthroughDiffuse,
                                     RandHydraMLPDiffuse, init_mlp_normal)
from .modules.visibility import (CubeBrightSampler, ERBrightSampler,
                                 init_visibility_mlp)
from .render import NMF
from .samplers.alphagrid import AlphaGridSampler
from .samplers.occgrid import OccGridSampler

def _target(cfg):
    return (cfg or {}).get("_target_", "")


def _clean(cfg):
    return {k: v for k, v in (cfg or {}).items() if not k.startswith("_")}


# nmf_tpu's keys of the hash field; it pops ``distance_scale`` before it
# reads them, so the hash field keeps its default 25 whatever the yaml
# says, and it ignores ``grid_size``
HASHGRID_KEYS = {"n_levels", "n_features", "log2_hashmap_size",
                 "base_resolution", "finest_resolution", "app_dim",
                 "hidden_w", "activation", "density_shift", "step_ratio",
                 "lr", "lr_net"}
# nmf_tpu's keys of the grid field, which keeps its default distance_scale
# for the same reason
GRID_KEYS = {"grid_size", "app_dim", "init_scale", "activation",
             "density_shift", "step_ratio", "lr", "lr_net"}
# nmf_tpu's keys of TensorVMSplit that the port reads (the others it
# accepts are dead in nmf_tpu too: density_res_multi, interp_mode, and
# scatter_kernel, which picks nmf_tpu's scatter, not a result)
TENSORF_KEYS = {"density_n_comp", "appearance_n_comp", "app_dim",
                "grid_size", "N_voxel_init", "N_voxel_final", "upsamp_list",
                "init_mode", "d_init_val", "app_init_val", "activation",
                "density_shift", "contract_space", "dbasis", "step_ratio",
                "smoothing", "numer_grad", "lr", "lr_net", "num_pretrain",
                "calibrate", "gather_dtype", "fixed_shape", "distance_scale"}


def build_field(generator, cfg, aabb, grid_size=None):
    t = _target(cfg)
    kw = _clean(cfg)
    if t.endswith("HashGridRF") or t.endswith("TCNNRF"):
        return init_hashgrid_rf(generator, aabb, **{
            k: v for k, v in kw.items() if k in HASHGRID_KEYS})
    if t.endswith("GridRF") or t.endswith("Grid"):
        kw = {k: v for k, v in kw.items() if k in GRID_KEYS}
        if grid_size is not None:
            kw["grid_size"] = grid_size
        return init_grid_rf(generator, aabb, **kw)
    if not (t.endswith("TensorVMSplit") or not t):
        raise ValueError(f"unknown field target {t}")
    kw = {k: v for k, v in kw.items() if k in TENSORF_KEYS}
    if grid_size is not None:
        kw["grid_size"] = grid_size
    if "upsamp_list" in kw:
        kw["upsamp_list"] = tuple(kw["upsamp_list"])
    return init_tensorvm_split(generator, aabb, **kw)


# the upstream samplers that nmf_tpu maps onto its occupancy grid
OCCGRID_TARGETS = ("NerfAccSampler", "Raymarcher", "ContinuousAlphagrid",
                   "OccGridSampler")


def build_occgrid(kw, aabb, near_far):
    """nmf_tpu's occupancy-grid mapping: ``grid_size`` is the grid's
    resolution (``grid_reso``) and ``occ_thre`` its ``density_thresh``;
    ``max_samples``, which nmf_tpu's march never reads, is ignored."""
    okw = {"grid_reso": int(kw.get("grid_reso", kw.get("grid_size", 128)))}
    for key, cast in (("update_freq", int), ("ema_decay", float),
                      ("multiplier", int), ("test_multiplier", float),
                      ("shrink_iters", tuple)):
        if key in kw:
            okw[key] = cast(kw[key])
    if "occ_thre" in kw or "density_thresh" in kw:
        okw["density_thresh"] = float(kw.get("density_thresh",
                                             kw.get("occ_thre")))
    return OccGridSampler(aabb, near_far=near_far, **okw)


def build_sampler(cfg, aabb, near_far):
    t = _target(cfg)
    kw = _clean(cfg)
    if any(t.endswith(n) for n in OCCGRID_TARGETS):
        return build_occgrid(kw, aabb, near_far)
    # as in nmf_tpu, every other target builds the AlphaGridSampler
    allowed = {"enable_alpha_mask", "update_list", "multiplier",
               "alphaMask_thres", "superstep", "fine_alpha_test"}
    kw = {k: v for k, v in kw.items() if k in allowed}
    if "update_list" in kw:
        kw["update_list"] = tuple(kw["update_list"])
    if "alphaMask_thres" in kw:
        kw["alpha_mask_thres"] = kw.pop("alphaMask_thres")
    return AlphaGridSampler(aabb, near_far=near_far, **kw)


def build_encoder(cfg):
    """A direction encoder by nmf_tpu's target suffixes, in its order. As
    in nmf_tpu, an ``IPE`` target ends with ``PE`` and builds PE (ROADMAP
    C.12): the IPE encoder is reached only directly. nmf_tpu builds an
    ``SHBasis`` target that fails at its first call (it takes angles, not
    directions); the port raises here, naming C.12."""
    if not cfg:
        return None
    t = _target(cfg)
    kw = _clean(cfg)
    if t.endswith("ListISH"):
        return ListISH(degs=tuple(kw.get("degs", (0, 1, 2, 4))))
    if t.endswith("FullISH"):
        return FullISH(max_degree=kw.get("max_degree", 1))
    if t.endswith("PE"):
        return PE(max_degree=kw.get("max_degree", 8))
    if t.endswith("FullISHScaled"):
        return FullISHScaled(max_degree=kw.get("max_degree", 1))
    if t.endswith("RandRotISH"):
        return RandRotISH(rand_n=kw.get("rand_n", 4),
                          core_degs=tuple(kw.get("core_degs", (1, 2, 4, 8))),
                          rand_degs=tuple(kw.get("rand_degs", (8,))))
    if t.endswith("RandISH"):
        return RandISH(rand_n=kw.get("rand_n", 8), std=kw.get("std", 10.0))
    if t.endswith("SHBasis"):
        raise NotImplementedError(
            f"encoder {t!r}: SHBasis takes (theta, phi, kappa), not an "
            "encoder's (directions, roughness); nmf_tpu builds it and fails "
            "at its first call (ROADMAP C.12)")
    if t.endswith("ISH"):
        return ISH(max_degree=kw.get("max_degree", 1))
    raise ValueError(f"unknown encoder target {t}")


# the keys RandHydraMLPDiffuse reads (nmf_tpu's init_rand_hydra_diffuse)
RAND_HYDRA_KEYS = {"pospe", "feape", "hidden_w", "num_layers", "initializer",
                   "lr", "start_roughness", "tint_bias", "diffuse_bias",
                   "diffuse_mul", "roughness_bias", "f0_bias",
                   "roughness_cfg"}


def build_diffuse(generator, dm_cfg, app_dim):
    """The material head by nmf_tpu's target suffixes, in its order
    (RandHydraMLPDiffuse ends with HydraMLPDiffuse, which ends with
    MLPDiffuse); RandHydraMLPDiffuse when none is given."""
    dt = _target(dm_cfg)
    kw = _clean(dm_cfg)
    if dt.endswith("PassthroughDiffuse"):
        return PassthroughDiffuse()
    if dt.endswith("RandHydraMLPDiffuse") or not dt:
        encoders = {k: build_encoder(kw.get(k)) for k in (
            "view_encoder", "roughness_view_encoder")}
        return RandHydraMLPDiffuse(app_dim, generator=generator, **encoders,
                                   **{k: v for k, v in kw.items()
                                      if k in RAND_HYDRA_KEYS})
    if dt.endswith("HydraMLPDiffuse"):
        return HydraMLPDiffuse(app_dim, generator=generator, **kw)
    if dt.endswith("MLPDiffuse"):
        return MLPDiffuse(app_dim, generator=generator, **kw)
    raise ValueError(f"unknown diffuse module {dt}")


def build_brdf_sampler(cfg):
    """The bounce-ray sampler, by nmf_tpu's target suffixes (GGX when
    none is given); a MultiSampler mixes GGX and the cosine lobe. As in
    nmf_tpu, an ``SGGXSampler`` target ends with ``GGXSampler`` and builds
    GGX (ROADMAP C.10): the SGGX sampler is reached only directly."""
    t = _target(cfg)
    if t.endswith("GGXSampler") or not t:
        return GGXSampler()
    for name, cls in (("CosineLobeSampler", CosineLobeSampler),
                      ("BeckmannSampler", BeckmannSampler),
                      ("MultiSampler", MultiSampler)):
        if t.endswith(name):
            return cls()
    raise ValueError(f"unknown brdf sampler {t}")


def build_visibility(generator, cfg, app_dim):
    """The visibility cache (VisibilityMLP; nmf_tpu also maps the upstream
    NaiveVisCache onto it), or None."""
    if not cfg:
        return None
    t = _target(cfg)
    if not (t.endswith("VisibilityMLP") or t.endswith("NaiveVisCache")
            or not t):
        raise ValueError(f"unknown visibility module {t}")
    return init_visibility_mlp(app_dim, generator=generator, **{
        k: v for k, v in _clean(cfg).items()
        if k in ("feape", "featureC", "num_layers", "lr")})


def build_bright_sampler(cfg):
    """The bright-ray sampler, or None. The cube sampler builds, as in
    nmf_tpu, and raises when the model samples it (ROADMAP C.10)."""
    if not cfg:
        return None
    t = _target(cfg)
    if t.endswith("ERBrightSampler") or not t:
        return ERBrightSampler()
    if t.endswith("CubeBrightSampler") or t.endswith(
            "BrightnessImportanceSampler"):
        kw = _clean(cfg)
        return CubeBrightSampler(n_spots=kw.get("n_spots", 16),
                                 scale=kw.get("scale", 1),
                                 update_freq=kw.get("update_freq", 1000))
    raise ValueError(f"unknown bright sampler {t}")


def build_microfacet(generator, kw, app_dim):
    vis_cfg = kw.pop("visibility_module", None)
    bright = build_bright_sampler(kw.pop("bright_sampler", None))
    dm = build_diffuse(generator, kw.pop("diffuse_module", None) or {},
                       app_dim)

    brdf_cfg = kw.pop("brdf", None) or {}
    bt = _target(brdf_cfg)
    if bt.endswith("Specular"):
        raise NotImplementedError(
            f"brdf {bt!r}: nmf_tpu's Microfacet cannot build the Specular "
            "BRDF (its init sets init_val, a field Specular lacks: "
            "TypeError); modules.brdf.Specular is reached only directly "
            "(ROADMAP C.12)")
    # as in nmf_tpu, every other BRDF target builds the MLPBRDF
    brdf_kw = _clean(brdf_cfg)
    brdf_kw["h_encoder"] = build_encoder(brdf_kw.pop("h_encoder", None))
    brdf_kw["d_encoder"] = build_encoder(brdf_kw.pop("d_encoder", None))
    brdf = init_mlp_brdf(app_dim, generator=generator, **brdf_kw)
    # drawn after the material heads, so a model without it keeps the
    # same initial values
    vis = build_visibility(generator, vis_cfg, app_dim)

    sampler = build_brdf_sampler(kw.pop("brdf_sampler", None) or {})
    mr = kw.pop("max_retrace_rays", None)
    if mr is not None:
        # retrace buffers are rounded up to powers of two
        kw["max_retrace_rays"] = tuple(
            int(2 ** math.ceil(math.log2(max(m, 1)))) for m in mr)
    return init_microfacet(app_dim, dm, brdf, sampler,
                           visibility_module=vis, bright_sampler=bright,
                           **kw)


def build_refnerf(generator, kw, app_dim):
    dm = build_diffuse(generator, kw.pop("diffuse_module", None) or {},
                       app_dim)
    ref_kw = _clean(kw.pop("ref_module", None) or {})
    if "ref_encoder" in ref_kw:
        ref_kw["ref_encoder"] = build_encoder(ref_kw["ref_encoder"])
    return init_refnerf(app_dim, dm, generator=generator, **ref_kw)


def build_model(generator, cfg, app_dim):
    t = _target(cfg)
    kw = _clean(cfg)
    if t.endswith("Microfacet"):
        return build_microfacet(generator, kw, app_dim)
    if t.endswith("RefNeRF"):
        return build_refnerf(generator, kw, app_dim)
    if t.endswith("DualModel"):
        # nmf_tpu: the upstream key is warmup_iters; model1 shades every
        # retrace pass, so the alternating mode has no switch of its own
        m1 = build_model(generator, kw.pop("model1"), app_dim)
        m2 = build_model(generator, kw.pop("model2"), app_dim)
        return DualModel(m1, m2, switch_iter=int(
            kw.get("switch_iter", kw.get("warmup_iters", 0))))
    if not (t.endswith("TensoRF") or not t):
        raise ValueError(f"unknown model target {t}")
    dm_cfg = kw.get("diffuse_module") or {}
    dm_kw = _clean(dm_cfg)
    if _target(dm_cfg).endswith("MLPRender_PE"):
        dm_kw["head"] = "pe"
    return init_tensorf_shade(app_dim, generator=generator, **dm_kw)


def build_normal_module(generator, cfg, app_dim):
    if not cfg:
        return None
    t = _target(cfg)
    if t.endswith("MLPNormal"):
        return init_mlp_normal(app_dim, generator=generator, **_clean(cfg))
    if t.endswith("AppDimNormal"):
        return AppDimNormal()
    raise ValueError(f"unknown normal module {t}")


def build_bg(cfg):
    if not cfg:
        return None
    t = _target(cfg)
    if not t.endswith("IntegralEquirect"):
        raise ValueError(f"unknown bg target {t}")
    return init_integral_equirect(**_clean(cfg))


def tonemap_name(cfg):
    """nmf_tpu's curve for a tonemap target: SRGB (or none) -> srgb, HDR
    -> hdr, Linear -> linear, anything else -> srgb."""
    t = _target(cfg or {})
    if "SRGB" in t or not t:
        return "srgb"
    if "HDR" in t:
        return "hdr"
    return "linear" if "Linear" in t else "srgb"


def build_nmf(arch_cfg, aabb, near_far, seed=0, device="cuda",
              grid_size=None) -> NMF:
    """Build the composed model from cfg.model.arch on ``device``, its field
    at ``grid_size`` when given (a checkpoint's). Initial values are drawn
    on the CPU from a generator seeded with ``seed``, so a seed gives the
    same model on every device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch sees no CUDA device; "
                           "pass device=cpu to run on the CPU")
    gen = torch.Generator().manual_seed(int(seed))
    rf = build_field(gen, arch_cfg.get("rf", {}), aabb, grid_size)
    sampler = build_sampler(arch_cfg.get("sampler", {}), aabb, near_far)
    if rf.fixed_shape and isinstance(sampler, OccGridSampler):
        raise ValueError(
            "field.fixed_shape requires the AlphaGridSampler march "
            "(occupancy-grid samplers have no live-resolution step "
            "scaling); disable one")
    model = build_model(gen, arch_cfg.get("model", {}), rf.app_dim)
    bg = build_bg(arch_cfg.get("bg_module"))
    normal_module = build_normal_module(gen, arch_cfg.get("normal_module"),
                                        rf.app_dim)
    # mlp_dtype reaches the shading model's and the normal module's MLPs
    mlp_dtype = arch_cfg.get("mlp_dtype") or "f32"
    for module in (model, normal_module):
        if module is not None:
            set_mlp_dtype(module, mlp_dtype)
    nmf = NMF(rf, sampler, model, bg_module=bg, normal_module=normal_module,
              max_samples_per_ray=arch_cfg.get("max_samples_per_ray", -1),
              recur_samples_per_ray=arch_cfg.get("recur_samples_per_ray",
                                                 -1),
              proposal_samples_per_ray=arch_cfg.get(
                  "proposal_samples_per_ray", -1),
              proposal_pad=arch_cfg.get("proposal_pad", 0.01),
              recur_stepmul=arch_cfg.get("recur_stepmul", 1.0),
              eval_batch_size=arch_cfg.get("eval_batch_size", 4096),
              lr_scale=arch_cfg.get("lr_scale", 1.0),
              use_predicted_normals=arch_cfg.get("use_predicted_normals",
                                                 False),
              align_pred_norms=arch_cfg.get("align_pred_norms", True),
              geonorm_iters=arch_cfg.get("geonorm_iters", -1),
              geonorm_interp_iters=arch_cfg.get("geonorm_interp_iters",
                                                1000),
              detach_inter=arch_cfg.get("detach_inter", False),
              tonemap=tonemap_name(arch_cfg.get("tonemap")),
              hdr=bool(arch_cfg.get("hdr", False)),
              app_samples_per_ray=arch_cfg.get("app_samples_per_ray", -1),
              merge_runs=arch_cfg.get("merge_runs", 0),
              recur_proposal_samples_per_ray=arch_cfg.get(
                  "recur_proposal_samples_per_ray", -1),
              proposal_pad_init=arch_cfg.get("proposal_pad_init", -1.0),
              proposal_pad_iters=arch_cfg.get("proposal_pad_iters", 0)
              ).to(device)
    sampler.update(rf, init=True)
    return nmf
