"""The streaming evaluation render (``render_streaming.py``) and the
MLPRender_PE head of nmf_tpu_torch against nmf_tpu's: the PE head's colour
and gradients, the streaming render of a tiny model=tensorf and a tiny
model=refnerf (normals) against nmf_tpu's and against the port's batch
render, ``evaluate(streaming=True)``, the early stop, and the refusal of
shading models with bounce rays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu.render_streaming import render_streaming as jstream  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import render_streaming as tstream_mod  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from nmf_tpu_torch.render_streaming import render_streaming  # noqa: E402
from torch_inputs import DUALREF, FLAGSHIP, REFNERF  # noqa: E402
from torch_parity import AABB, NEAR_FAR, build_pair, close  # noqa: E402

FWD, GRAD = 1e-5, 1e-4
PE = ["model.arch.model.diffuse_module._target_="
      "modules.render_modules.MLPRender_PE"]
# a denser start (density_shift -1): rays turn opaque inside the box, so
# the carried transmittance and the early stop matter
DENSE = ["field.density_shift=-1"]
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 2,
           "image_size": 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rays():
    ds = jload(DATASET, None, "test")
    return ds["all_rays"][::3][:128]


def test_mlp_render_pe_matches():
    """The PE head's colour of (position, view, features) and the
    gradients of a loss on it: the MLP's and the features'."""
    jn, tn, _ = build_pair(extra=PE)
    rng = np.random.default_rng(0)
    M = 200
    pts = rng.uniform(-1, 1, (M, 4)).astype(np.float32)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    feat = rng.normal(0, 0.3, (M, 24)).astype(np.float32)
    cot = rng.normal(size=(M, 3)).astype(np.float32)
    dm = jn.model.diffuse_module

    def jloss(dm, f):
        return (dm(jnp.asarray(pts), jnp.asarray(vd), f) * cot).sum()

    jl, (jg_dm, jg_f) = jax.value_and_grad(jloss, argnums=(0, 1))(
        dm, jnp.asarray(feat))
    tf = torch.tensor(feat, requires_grad=True)
    rgb, _ = tn.model.shade(None, torch.from_numpy(pts), tf,
                            torch.from_numpy(vd), None, None, None, M)
    close(rgb.detach().numpy(), dm(jnp.asarray(pts), jnp.asarray(vd),
                                   jnp.asarray(feat)), FWD, "rgb")
    (rgb * torch.from_numpy(cot)).sum().backward()
    close(tf.grad.numpy(), jg_f, GRAD, "d features")
    for layer, g in zip(tn.model.diffuse_module.mlp.layers,
                        jg_dm.mlp.layers):
        close(layer.weight.grad.numpy().T, g["w"], GRAD, "w")
        close(layer.bias.grad.numpy(), g["b"], GRAD, "b")


@pytest.mark.parametrize("model", ["tensorf", "refnerf"])
def test_render_streaming_matches(rays, model):
    """The port's streaming render against nmf_tpu's (blocks of 16, the
    early stop at T <= 1e-4): rgb, acc and depth; Ref-NeRF shades with
    the field's smoothed normals. nmf_tpu runs op by op: a
    ray's first sample lies on the box's face, where XLA's fused
    arithmetic inside the compiled loop flips the box test (ROADMAP
    C.3)."""
    base = REFNERF if model == "refnerf" else None
    jn, tn, _ = build_pair(extra=DENSE, base=None if base is None
                           else [*base, *DENSE])
    r = rays[:64]
    with jax.disable_jit():
        jims = jstream(jn, jnp.asarray(r), block=16, t_thresh=1e-4)
    tims, stats = render_streaming(tn, torch.from_numpy(r), block=16,
                                   t_thresh=1e-4)
    assert stats["blocks"] >= 2
    for k in ("rgb_map", "acc_map", "depth"):
        close(tims[k].numpy(), jims[k], FWD, k)


def test_streaming_matches_batch_render(rays):
    """As nmf_tpu's test_matches_batch_renderer: the blockwise
    transmittance reproduces the batch render's (the first sample of a
    ray differs by where the two marches start, within a step)."""
    _, tn, _ = build_pair(extra=DENSE)
    r = torch.from_numpy(rays)
    with torch.no_grad():
        batch, _ = trender(tn, r, is_train=False)
    stream, _ = render_streaming(tn, r, block=32, t_thresh=0.0)
    assert float(batch["acc_map"].max()) > 0.9
    close(stream["rgb_map"].numpy(), batch["rgb_map"].numpy(), 5e-3, "rgb",
          scale=1.0)
    close(stream["acc_map"].numpy(), batch["acc_map"].numpy(), 5e-3, "acc",
          scale=1.0)


def test_streaming_marches_past_the_batch_cap(rays):
    """Where the mask culls nothing, the batch render keeps the first
    ``max_samples_per_ray`` valid samples a ray (16 of the 52 march steps
    here) while the streaming render marches the whole box: on a thin fog
    (density_shift -4) the streamed acc exceeds the batch one. nmf_tpu
    does the same (ROADMAP C.7), and the port reproduces both of its
    renders (op by op, as above)."""
    jn, tn, _ = build_pair(extra=["field.density_shift=-4",
                                  "model.arch.max_samples_per_ray=16"])
    r = rays[:64]
    with jax.disable_jit():
        jb, _ = jrender(jn, jnp.asarray(r), jax.random.PRNGKey(0),
                        is_train=False)
        js = jstream(jn, jnp.asarray(r))
    with torch.no_grad():
        tb, _ = trender(tn, torch.from_numpy(r), is_train=False)
    ts, _ = render_streaming(tn, torch.from_numpy(r))
    gap = np.asarray(js["acc_map"]) - np.asarray(jb["acc_map"])
    assert gap.min() > -1e-6 and gap.max() > 0.1
    for k in ("rgb_map", "acc_map"):
        close(tb[k].numpy(), jb[k], FWD, "batch " + k)
        close(ts[k].numpy(), js[k], FWD, "streamed " + k)


def test_blocks_come_from_the_composite_kernel(monkeypatch):
    """Each block's weights, rgb, acc and depth come from
    ``composite_rays`` (K1 in full mode on the card), once a block; the
    loop stops early once every ray's transmittance is spent."""
    _, tn, _ = build_pair(extra=["field.density_shift=2"])
    # the centre of a view: every ray crosses the box (a ray that misses
    # it keeps T = 1 to the end)
    center = jload(DATASET, None, "test")["all_rays"][:256].reshape(
        16, 16, 6)[6:10, 6:10].reshape(-1, 6)
    calls = []
    real = tstream_mod.composite_rays

    def counted(sigma, *args):
        calls.append(tuple(sigma.shape))
        return real(sigma, *args)

    monkeypatch.setattr(tstream_mod, "composite_rays", counted)
    _, stats = render_streaming(tn, torch.from_numpy(center), block=8)
    near, far = tn.sampler.near_far
    n_blocks = -(-int(np.ceil((far - near) / tn.sampler.live_stepsize)) // 8)
    assert len(calls) == stats["blocks"] < n_blocks
    assert set(calls) == {(16, 8)}


def test_evaluate_streaming_matches(tmp_path):
    """evaluate(streaming=True) on a test view: the PSNR of nmf_tpu's
    streaming eval (op by op, as above), and maps of rgb, acc and depth
    only."""
    jn, tn, _ = build_pair(extra=DENSE)
    ds = jload(DATASET, None, "test")
    with jax.disable_jit():
        jres = jeval.evaluate(jn, ds, jax.random.PRNGKey(0), n_vis=1,
                              compute_extra_metrics=False, streaming=True)
    tres = teval.evaluate(tn, ds, save_dir=str(tmp_path), n_vis=1,
                          compute_extra_metrics=False, streaming=True)
    close(tres["psnr"], jres["psnr"], 1e-5, "psnr")
    assert (tmp_path / "000.png").exists()
    assert not (tmp_path / "surf_width").exists()


@pytest.mark.parametrize("base", [FLAGSHIP, DUALREF],
                         ids=["microfacet", "dualref"])
def test_streaming_refuses_bounce_ray_models(rays, base):
    cfg = tconfig.compose(base)
    tn = tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    with pytest.raises(ValueError):
        render_streaming(tn, torch.from_numpy(rays[:4]))
