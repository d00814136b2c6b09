"""Dataset loading (numpy, host side).

The port's counterpart of ``nmf_tpu/data/blender.py:load_dataset``. This
slice carries the procedural ``synthetic_sphere`` scene only; the Blender,
LLFF, NSVF and shiny loaders come with later slices.
"""


def load_dataset(cfg_dataset, datadir=None, split="train"):
    """Dispatch on ``dataset_name``; returns the dict of
    ``nmf_tpu.data.blender.load_dataset`` (all_rays, all_rgbs, img_wh,
    focal, near_far, scene_bbox, ...)."""
    name = cfg_dataset["dataset_name"]
    if name != "synthetic_sphere":
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: this slice of "
            "nmf_tpu_torch loads synthetic_sphere only (the other loaders "
            "come with the microfacet slice)")
    from .synthetic import make_sphere_dataset

    n_views = cfg_dataset.get("n_views", 12)
    size = cfg_dataset.get("image_size", 64)
    phi = -30.0 if split == "train" else -25.0
    ds = make_sphere_dataset(n_views=n_views, H=size, W=size,
                             seed=0 if split == "train" else 1, phi_deg=phi)
    if cfg_dataset.get("near_far"):
        ds["near_far"] = tuple(cfg_dataset["near_far"])
    return ds
