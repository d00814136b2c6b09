"""Compose trained scenes and render them along an orbit
(``nmf_tpu/scripts/compose_scenes.py``).

    python -m nmf_tpu_torch.scripts.compose_scenes \\
        --ckpt log/car/car.th --ckpt log/toaster/toaster.th \\
        --offset 0,0,0 --offset 1.2,0,0 [--rot-z 0 --rot-z 45] \\
        [--bg envmap.th] --out /tmp/composed [--frames 30] \\
        [--image-size 200] [--radius 4.0] [--chunk 4096] [--device cuda]

The checkpoints' fields are placed together by a ``ListRF``
(``fields/listrf.py``) at their offsets and z-rotations; the FIRST
checkpoint's shading model, sampler and envmap render the composition.
The sampler takes the union of the shifted boxes and rebuilds its alpha
mask from the composed density. ``--bg`` swaps the envmap for a fitted
one (``ckpt.load_envmap``: a ``pano2env`` file or a checkpoint's). The
orbit is ``eval.render_path`` at focal 0.5 W / tan(0.3456), written to
``--out`` as ``path/<i>.png`` and ``path.gif``.
"""
import argparse
import math


def parse_vec3(s):
    v = [float(x) for x in s.split(",")]
    if len(v) != 3:
        raise ValueError(f"expected x,y,z got {s}")
    return v


def rot_z(deg):
    a = math.radians(deg)
    return [[math.cos(a), -math.sin(a), 0.0],
            [math.sin(a), math.cos(a), 0.0],
            [0.0, 0.0, 1.0]]


def compose(ckpts, offsets=None, rotations_deg=None, bg=None,
            device="cuda"):
    """The first checkpoint's model on ``device`` with its field replaced
    by the ``ListRF`` of every checkpoint's field (``offsets`` x, y, z and
    ``rotations_deg`` about z per checkpoint) and, given ``bg``, its envmap
    by that file's."""
    from .. import ckpt as ckpt_lib
    from ..fields.listrf import make_listrf

    models = [ckpt_lib.load(p, device)[0] for p in ckpts]
    offsets = offsets or [[0.0, 0.0, 0.0]] * len(models)
    if len(offsets) != len(models):
        raise ValueError("--offset count must match --ckpt count")
    rots = (None if rotations_deg is None
            else [rot_z(d) for d in rotations_deg])
    host = models[0]
    host.rf = make_listrf([m.rf for m in models], offsets=offsets,
                          rotations=rots)
    host.sampler.update(host.rf, init=False)
    if bg is not None:
        host.bg_module = ckpt_lib.load_envmap(bg, device)
    return host


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", action="append", required=True,
                    help="checkpoint path; repeat per scene")
    ap.add_argument("--offset", action="append", default=None,
                    help="x,y,z world offset per scene")
    ap.add_argument("--rot-z", action="append", default=None, type=float,
                    help="z-rotation in degrees per scene")
    ap.add_argument("--bg", default=None,
                    help="envmap file (pano2env output) to relight the "
                         "composition")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--image-size", type=int, default=200)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..eval import render_path

    host = compose(args.ckpt,
                   [parse_vec3(s) for s in args.offset] if args.offset
                   else None, args.rot_z, args.bg, args.device)
    H = W = args.image_size
    focal = 0.5 * W / math.tan(0.5 * 0.6911)
    frames = render_path(host, (H, W), focal, n_frames=args.frames,
                         radius=args.radius, chunk=args.chunk,
                         save_dir=args.out)
    print(f"wrote {args.frames} frames to {args.out}")
    return frames


if __name__ == "__main__":
    main()
