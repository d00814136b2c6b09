"""Dataset loading (numpy, host side).

The port's counterpart of ``nmf_tpu/data/blender.py:load_dataset`` for the
procedural scenes: ``synthetic_sphere`` and the protocol scenes
``synthetic_shiny`` / ``synthetic_cluster`` / ``synthetic_studio``. The
Blender, LLFF, NSVF and EXR loaders come with a later slice (ROADMAP A.2).
"""


def load_dataset(cfg_dataset, datadir=None, split="train"):
    """Dispatch on ``dataset_name``; returns the dict of
    ``nmf_tpu.data.blender.load_dataset`` (all_rays, all_rgbs, img_wh,
    focal, near_far, scene_bbox, and for the protocol scenes all_norms,
    all_tints and gt_bg_im)."""
    name = cfg_dataset["dataset_name"]
    if name == "synthetic_sphere":
        from .synthetic import make_sphere_dataset

        n_views = cfg_dataset.get("n_views", 12)
        size = cfg_dataset.get("image_size", 64)
        phi = -30.0 if split == "train" else -25.0
        ds = make_sphere_dataset(n_views=n_views, H=size, W=size,
                                 seed=0 if split == "train" else 1,
                                 phi_deg=phi)
    elif name in ("synthetic_shiny", "synthetic_cluster",
                  "synthetic_studio"):
        from .synthetic import make_shiny_dataset

        size = cfg_dataset.get("image_size", 128)
        ds = make_shiny_dataset(
            n_views=cfg_dataset.get("n_views", 24), H=size, W=size,
            split=split, env_bg=cfg_dataset.get("env_bg", False),
            hemisphere=cfg_dataset.get("hemisphere", False),
            interreflect=cfg_dataset.get("interreflect", True),
            n_gi_samples=cfg_dataset.get("n_gi_samples", 64),
            scene=name.split("_", 1)[1])
    else:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: nmf_tpu_torch loads the "
            "procedural scenes only; the file loaders come with a later "
            "slice (ROADMAP A.2)")
    if cfg_dataset.get("near_far"):
        ds["near_far"] = tuple(cfg_dataset["near_far"])
    return ds
