"""The tensorf slice of nmf_tpu_torch as a whole, against nmf_tpu: three
train steps (loss, every gradient, every updated tensor), an eval render,
a CPU reconstruction run, the import boundary and chip_smoke.py's refusal
to run without a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu import utils as jutils  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from torch_parity import AABB, NEAR_FAR, build_pair  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B = 64
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
# clip at 0.01 so the global-norm clip (which counts rf.aabb's gradient)
# is active; K = 32 < N = 52 so the two-level march runs
SLICE = ["model.arch.max_samples_per_ray=32", "model.params.n_iters=100",
         "model.params.clip_grad=0.01"]


def _port_value(tn, key):
    t, transpose = weights.port_tensor(tn, key)
    v = t.detach().numpy()
    return v.T if transpose else v


def test_three_train_steps_match():
    jn, tn, cfg = build_pair("f32", SLICE)
    params = cfg["model"]["params"]
    ds = jload(DATASET, None, "train")
    opt_cfg = jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"],
        lr_init=params["lr_init"], lr_final=params["lr_final"],
        lr_delay_steps=params["lr_delay_steps"],
        lr_delay_mult=params["lr_delay_mult"], n_iters=100,
        clip_grad=params["clip_grad"])
    tx = jtrainer.make_optimizer(jn, opt_cfg)
    state = tx.init(jn)
    jstep = jtrainer.make_train_step(tx, donate=False)
    jw = jtrainer.LossWeights(ori_lambda=0.0, pred_lambda=0.0,
                              l1_weight=params["L1_weight_initial"])
    jgrad = jax.jit(jax.value_and_grad(
        lambda n, r, g, k: jtrainer.compute_loss(n, r, g, k, jw,
                                                 jnp.ones(3))[0]))
    topt = ttrain.make_optimizer(tn, params, 100)
    tw = ttrain.make_loss_weights(params)
    rng = np.random.default_rng(0)
    N = jn.sampler.n_samples
    for i in range(3):
        ids = rng.choice(ds["all_rays"].shape[0], B, replace=False)
        rays, rgb = ds["all_rays"][ids], ds["all_rgbs"][ids]
        key = jax.random.PRNGKey(i)
        jitter = np.asarray(jax.random.uniform(jax.random.split(key, 4)[0],
                                               (B, N)))
        jl, jg = jgrad(jn, jnp.asarray(rays), jnp.asarray(rgb), key)
        topt.zero_grad()
        tl, _ = ttrainer.compute_loss(
            tn, torch.from_numpy(rays), torch.from_numpy(rgb), tw,
            (1.0, 1.0, 1.0), jitter=torch.from_numpy(jitter))
        tl.backward()
        # f32 everywhere; sums (field scatters, MLP products) in another
        # order
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k, g in jckpt.state_dict(jg).items():
            t, transpose = weights.port_tensor(tn, k)
            if t.grad is None:
                # tensors the port does not differentiate: nmf_tpu's
                # gradient is exactly zero there
                assert not np.any(g), k
                continue
            tg = t.grad.numpy()
            np.testing.assert_allclose(tg.T if transpose else tg, g,
                                       rtol=1e-4, atol=1e-8 + 1e-5
                                       * np.abs(g).max(), err_msg=k)
        jn, state, _ = jstep(jn, state, jnp.asarray(rays), jnp.asarray(rgb),
                             jnp.ones(3), key, jw)
        topt.step()
        # Adam's first steps are ~lr * sign(g): entries whose gradient sits
        # at the f32 summation noise may move differently, by at most
        # lr * sched ~ 2e-4 here, and rarely; 1e-5 covers what is seen
        for k, v in jckpt.state_dict(jn).items():
            np.testing.assert_allclose(_port_value(tn, k), v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_render_image_matches():
    jn, tn, _ = build_pair("f32", ["model.arch.max_samples_per_ray=32"])
    ds = jload(DATASET, None, "test")
    rays = ds["all_rays"][:256]
    gt = ds["all_rgbs"][:256].reshape(16, 16, 3)
    # nmf_tpu's render run op by op: under jit, XLA's fused arithmetic
    # moves z_vals by an ulp and flips a few samples at box and mask-cell
    # edges (22 of 256 x 32 here), which jit-vs-eager nmf_tpu shows too
    jm = jeval.render_image(
        jn, rays, (16, 16), jax.random.PRNGKey(0), chunk=100,
        render_fn=lambda n, r, k, c: jrender(n, r, k, is_train=False,
                                             draw_debug=True)[0])
    tm = teval.render_image(tn, rays, (16, 16), chunk=100)
    for k in ("rgb_map", "acc_map", "depth"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    jp = jutils.rgb_psnr(np.clip(jm["rgb_map"], 0, 1), gt)
    tp = teval.utils.rgb_psnr(np.clip(tm["rgb_map"], 0, 1), gt)
    assert abs(tp - jp) < 1e-3


def test_reconstruction_on_cpu_writes_eval_images(tmp_path):
    lines = []
    _, res = ttrain.reconstruction(ttrain.config_lib.compose([
        "model=tensorf", "dataset=synthetic_sphere", "device=cpu",
        "model.params.n_iters=20", "model.params.batch_size=128",
        "field.N_voxel_init=4096", "field.N_voxel_final=8000",
        "field.upsamp_list=[]", "model.arch.sampler.update_list=[10]",
        "model.arch.max_samples_per_ray=32",
        "model.arch.model.diffuse_module.featureC=16",
        "dataset.image_size=12", "dataset.n_views=3",
        f"basedir={tmp_path}", "expname=t", "progress_refresh_rate=5"]),
        log=lines.append)
    out = tmp_path / "synthetic_sphere_t" / "imgs_test_all"
    assert sorted(p.name for p in out.glob("*.png")) == [
        "000.png", "001.png", "002.png"]
    assert (out / "rgbd" / "000.png").read_bytes()[:4] == b"\x89PNG"
    assert (out / "mean.txt").exists()
    assert any("schedule event" in ln for ln in lines)
    assert np.isfinite(res["loss"]) and res["psnr"] > 5


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nmf_tpu_torch\n"
        "for m in pkgutil.walk_packages(nmf_tpu_torch.__path__, "
        "'nmf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nmf_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('nmf_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_unported_targets_raise():
    cfg = ttrain.config_lib.compose(["model=microfacet_tensorf2"])
    with pytest.raises(NotImplementedError):
        tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    if not torch.cuda.is_available():
        cfg = ttrain.config_lib.compose(["model=tensorf"])
        with pytest.raises(RuntimeError):
            tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cuda")
