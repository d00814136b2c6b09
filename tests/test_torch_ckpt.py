"""Checkpoints of nmf_tpu_torch against nmf_tpu's: the state dict's keys,
shapes and dtypes, files moving both ways (each renders what the other
package renders), format 1 refused, resume from nmf_tpu's _latest.th, the
lr schedule across a resume and an event, and a tiny pause / resume /
render_only run on the CPU."""
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from torch_inputs import FLAGSHIP  # noqa: E402
from torch_parity import (build_flagship_pair, build_pair,  # noqa: E402
                          port_copy)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores (torch's thread pool beside JAX's oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_dataset_cache(monkeypatch):
    """Both packages read NMF_DATASET_CACHE; empty turns their scene memo
    off, so no test writes into the checkout or reads a stale file."""
    monkeypatch.setenv("NMF_DATASET_CACHE", "")


DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
# one upsample (16^3 -> 20^3) and one mask rebuild, both at iteration 2
EVENTS = ["field.upsamp_list=[2]", "model.arch.sampler.update_list=[2]"]
FIXED = ["field.fixed_shape=true"]
# the tiny tensorf of the CPU runs below
TINY_RUN = [
    "model=tensorf", "dataset=synthetic_sphere", "device=cpu",
    "field.N_voxel_init=4096", "field.N_voxel_final=8000",
    "model.arch.max_samples_per_ray=32",
    "model.arch.model.diffuse_module.featureC=16", "dataset.image_size=12",
    "dataset.n_views=3", "model.params.batch_size=64",
    "progress_refresh_rate=5"]


@pytest.fixture(scope="module")
def pairs():
    """``pairs(model, shape, extra)``: nmf_tpu's tiny model, built once a
    module for each (model, shape, extra), and a fresh port copy of it for
    each case (a schedule event changes the port's model in place)."""
    built = {}

    def _pair(model, shape, extra=()):
        key = (model, shape, tuple(extra))
        if key not in built:
            ov = [*(FIXED if shape == "fixed" else []), *extra]
            jn, _, cfg = (build_pair("f32", ov) if model == "tensorf"
                          else build_flagship_pair(ov))
            built[key] = jn, cfg
        jn, cfg = built[key]
        return jn, port_copy(jn, cfg), cfg

    return _pair


@pytest.mark.parametrize("stage", ["built", "after events"])
@pytest.mark.parametrize("shape", ["exact", "fixed"])
@pytest.mark.parametrize("model", ["tensorf", "flagship"])
def test_state_dict_matches_nmf_tpu(pairs, model, shape, stage):
    """to_jax_state_dict gives nmf_tpu's keys, shapes, dtypes and values,
    also after an upsample and a mask rebuild (the alpha volumes change
    shape, or keep the padded one)."""
    jn, tn, _ = pairs(model, shape, EVENTS)
    if stage == "after events":
        jn, changed = jn.check_schedule(2)
        assert changed and tn.check_schedule(2)
    jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape and tsd[k].dtype == v.dtype, k
        np.testing.assert_allclose(tsd[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if shape == "fixed":
        assert ".rf.live_reso" in tsd and ".sampler.step_scale" in tsd


def _render_pair(jn, tn):
    """nmf_tpu's eval render (op by op, as test_render_image_matches runs
    it) and the port's, of 256 test rays."""
    rays = jload(DATASET, None, "test")["all_rays"][:256]
    jm = jeval.render_image(
        jn, rays, (16, 16), jax.random.PRNGKey(0), chunk=100,
        render_fn=lambda n, r, k, c: jrender(n, r, k, is_train=False,
                                             draw_debug=True)[0])
    return jm, teval.render_image(tn, rays, (16, 16), chunk=100)


def _assert_renders_match(jm, tm):
    # test_render_image_matches' tolerance
    for k in ("rgb_map", "acc_map", "depth"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shape", ["exact", "fixed"])
def test_nmf_tpu_checkpoint_loads_into_the_port(pairs, tmp_path, shape):
    """A file of nmf_tpu.ckpt.save (a model built by build_nmf, upsampled
    and its mask rebuilt, no training) loads through the port's ckpt.load
    and renders as nmf_tpu renders it."""
    jn, _, cfg = pairs("tensorf", shape,
                       ["model.arch.max_samples_per_ray=32", *EVENTS])
    jn, _ = jn.check_schedule(2)
    jckpt.save(tmp_path / "j.th", jn, cfg, extra={"iteration": 2})
    tn, tcfg, extra = tckpt.load(tmp_path / "j.th", device="cpu")
    assert extra == {"iteration": 2} and tcfg == cfg
    assert tn.rf.live_grid_size == (20, 20, 20)
    _assert_renders_match(*_render_pair(jn, tn))


@pytest.mark.parametrize("shape", ["exact", "fixed"])
def test_port_checkpoint_loads_into_nmf_tpu(pairs, tmp_path, shape):
    """A file of the port's ckpt.save (after its own upsample and mask
    rebuild) holds numpy arrays and builtins only, loads through
    nmf_tpu.ckpt.load, and renders as the port renders it."""
    _, tn, cfg = pairs("tensorf", shape,
                       ["model.arch.max_samples_per_ray=32", *EVENTS])
    assert tn.check_schedule(2)
    tckpt.save(tmp_path / "t.th", tn, cfg, extra={"iteration": 2})

    def leaves(x):
        if isinstance(x, dict):
            return [y for k, v in x.items() for y in leaves(k) + leaves(v)]
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in leaves(v)]
        return [x]

    with open(tmp_path / "t.th", "rb") as f:
        payload = pickle.load(f)
    assert payload["format"] == 2
    kinds = {type(x) for x in leaves(payload)}
    assert kinds <= {np.ndarray, str, int, float, bool, type(None)}, kinds
    jn, jcfg, extra = jckpt.load(tmp_path / "t.th")
    assert extra == {"iteration": 2} and jcfg == cfg
    _assert_renders_match(*_render_pair(jn, tn))


@pytest.mark.parametrize("payload", ["flax pytree", "no format key",
                                     "missing jax module"])
def test_format_1_checkpoint_raises(tmp_path, payload):
    if payload == "flax pytree":
        jn, _, _ = build_pair("f32")
        jckpt.save(tmp_path / "old.th", jn.rf)
    elif payload == "no format key":
        with open(tmp_path / "old.th", "wb") as f:
            pickle.dump({"model": {"w": np.zeros(3)}, "config": None}, f)
    else:
        # what unpickling a flax pytree meets where JAX is missing: a
        # class of a jax module that cannot be imported
        (tmp_path / "old.th").write_bytes(b"cjax._gone\nLeaf\n.")
    with pytest.raises(tckpt.Format1Checkpoint, match="format-1"):
        tckpt.load(tmp_path / "old.th", device="cpu")


def test_unreadable_checkpoint_error_passes_through(tmp_path):
    """A pickle that names a module of neither package is not taken for a
    format-1 file: the restricted reader refuses it, naming the module
    (it imports nothing beyond numpy's array reconstruction)."""
    (tmp_path / "odd.th").write_bytes(b"cno_such_module_here\nLeaf\n.")
    with pytest.raises(pickle.UnpicklingError, match="no_such_module_here"):
        tckpt.load(tmp_path / "odd.th", device="cpu")


def test_port_resumes_from_nmf_tpu_latest(tmp_path):
    """The port resumes a run from the _latest.th that nmf_tpu writes,
    with its iteration, batch size and budget multiplier."""
    ov = [*TINY_RUN, "model.params.n_iters=8", "field.upsamp_list=[]",
          "model.arch.sampler.update_list=[4]", f"basedir={tmp_path}",
          "expname=r", "resume=True", "vis_every=4", "N_vis=1",
          "render_train=true"]
    cfg = tconfig.compose(ov)
    jn, _, _ = build_pair("f32", ["model.arch.max_samples_per_ray=32",
                                  "model.arch.sampler.update_list=[4]"])
    folder = tmp_path / "synthetic_sphere_r"
    jckpt.save(folder / "synthetic_sphere_r_latest.th", jn, cfg,
               extra={"iteration": 6, "cur_bs": 32, "budget_mult": 1})
    lines = []
    _, res = ttrain.reconstruction(cfg, log=lines.append)
    assert any("resume:" in ln and "at iter 6" in ln for ln in lines)
    assert res["batch"] == 32 and np.isfinite(res["loss"])
    assert (folder / "synthetic_sphere_r.th").exists()
    # the vis_every eval at iteration 7 and the train-split eval
    assert (folder / "imgs_vis" / "000007_000.png").exists()
    assert set(res["train_split"]) >= {"psnr", "ssim"}


def _jax_lr(jn, params, n_iters, count):
    """nmf_tpu's lr multiplier at a fresh optimizer state fast-forwarded
    to ``count``: every step counter of the state, through its schedule."""
    opt_cfg = jtrainer.OptimConfig(
        lr_init=params["lr_init"], lr_final=params["lr_final"],
        lr_delay_steps=params["lr_delay_steps"],
        lr_delay_mult=params["lr_delay_mult"], n_iters=n_iters)
    state = jtrainer.fast_forward_opt_state(
        jtrainer.make_optimizer(jn, opt_cfg).init(jn), count)
    counts = {int(x) for x in jax.tree_util.tree_leaves(state)
              if hasattr(x, "dtype") and x.ndim == 0
              and jnp.issubdtype(x.dtype, jnp.integer)}
    assert counts == {count}
    sched = jtrainer.lr_decay_schedule(
        opt_cfg.lr_init, opt_cfg.lr_final, n_iters, opt_cfg.lr_delay_steps,
        opt_cfg.lr_delay_mult)
    return float(sched(count))


@pytest.mark.parametrize("lr_reset", [True, False])
def test_lr_after_a_resume_and_an_event(tmp_path, monkeypatch, lr_reset):
    """The port's step count and lr multiplier at the first step after an
    event (upsample at 4) and after a resume (paused at 6) equal nmf_tpu's
    schedule at the count fast_forward_opt_state sets: the distance from
    the last event with lr_upsample_reset=true, the global iteration with
    false."""
    seen = []
    step = ttrainer.train_step

    def recording(nmf, opt, *args, **kwargs):
        seen.append((opt.count, opt.sched(opt.count)))
        return step(nmf, opt, *args, **kwargs)

    monkeypatch.setattr(ttrainer, "train_step", recording)
    ov = [*TINY_RUN, "model.params.n_iters=8", "field.upsamp_list=[4]",
          "model.arch.sampler.update_list=[]", f"basedir={tmp_path}",
          "expname=lr", f"model.params.lr_upsample_reset={lr_reset}",
          "render_test=false"]
    ttrain.reconstruction(tconfig.compose([*ov, "stop_iter=6"]),
                          log=lambda s: None)
    ttrain.reconstruction(tconfig.compose([*ov, "resume=True"]),
                          log=lambda s: None)
    counts = [c for c, _ in seen]
    assert counts == ([0, 1, 2, 3, 0, 1, 2, 3] if lr_reset
                      else list(range(8)))
    jn, _, cfg = build_pair("f32")
    for it in (4, 6):  # after the event, after the resume
        assert seen[it][1] == pytest.approx(
            _jax_lr(jn, cfg["model"]["params"], 8, counts[it]), rel=1e-6)


def _state(path):
    with open(path, "rb") as f:
        return pickle.load(f)["state_dict"]


def test_pause_resume_and_render_only(tmp_path):
    """The tiny flagship on the studio scene with the 8k arms' knobs
    (fixed shape, lr_upsample_reset=false, hemisphere): a stop_iter pause
    writes _latest.th, a resume finishes and writes {expname}.th, a second
    resume from the same _latest.th trains identically, and render_only on
    the checkpoint reproduces the final eval within 0.1 dB."""
    ov = [*FLAGSHIP, "dataset=synthetic_studio", "dataset.hemisphere=true",
          "dataset.image_size=12", "dataset.n_views=2",
          "dataset.n_gi_samples=4", "device=cpu", "field.fixed_shape=true",
          "field.upsamp_list=[6]", "model.arch.sampler.update_list=[]",
          "model.params.lr_upsample_reset=false",
          "model.params.distortion_lambda=1e-3", "model.params.n_iters=10",
          "model.params.batch_size=64", "model.params.max_batch_size=64",
          "expname=s", "progress_refresh_rate=5"]
    runs = [tmp_path / "a", tmp_path / "b"]
    folder = runs[0] / "synthetic_studio_s"
    _, paused = ttrain.reconstruction(
        tconfig.compose([*ov, f"basedir={runs[0]}", "stop_iter=4"]),
        log=lambda s: None)
    assert paused["paused_at"] == 4
    latest = folder / "synthetic_studio_s_latest.th"
    assert _state(latest)[".rf.live_reso"].tolist() == [16.0] * 3
    shutil.copytree(folder, runs[1] / "synthetic_studio_s")
    finals, results = [], []
    for base in runs:
        _, res = ttrain.reconstruction(
            tconfig.compose([*ov, f"basedir={base}", "resume=True"]),
            log=lambda s: None)
        finals.append(base / "synthetic_studio_s" / "synthetic_studio_s.th")
        results.append(res)
        assert finals[-1].exists()
        assert set(res) >= {"psnr", "ssim", "norm_err", "tint_psnr",
                            "envmap_psnr"}
    a, b = _state(finals[0]), _state(finals[1])
    assert a[".rf.live_reso"].tolist() == [20.0] * 3
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, rendered = ttrain.dispatch(tconfig.compose(
        [*ov, f"basedir={runs[0]}", "render_only=True",
         f"ckpt={finals[0]}"]), log=lambda s: None)
    assert abs(rendered["psnr"] - results[0]["psnr"]) <= 0.1
    assert (runs[0] / "synthetic_studio_s" / "imgs_render" / "mean.txt"
            ).exists()
    assert (folder / "metrics.jsonl").read_text().count('"step"') >= 3
