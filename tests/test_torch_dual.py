"""Dual-scene training in nmf_tpu_torch against nmf_tpu: ``MultiBG`` (its
state-dict keys, a dual checkpoint), two alternating train steps of the
tiny flagship with one envmap a scene, and ``reconstruction_dual`` of a
tiny model=tensorf; the scene generator's turned environment that
chip_smoke.py's dual path trains on."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu import train_dualbg as jdual  # noqa: E402
from nmf_tpu.builders import build_bg as jbuild_bg  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.modules.dual_bg import MultiBG as JMultiBG  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import train_dualbg as tdual  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_bg as tbuild_bg  # noqa: E402
from nmf_tpu_torch.data.synthetic import make_shiny_dataset  # noqa: E402
from nmf_tpu_torch.modules.dual_bg import MultiBG as TMultiBG  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from torch_parity import (build_flagship_pair, close,  # noqa: E402
                          grads_match, render_draws)

B = 64
FWD = 1e-5
# every lookup box spans the map (test_torch_flagship.py's MIPBIAS)
MIPBIAS = 12.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dual_pair():
    """The tiny flagship of both packages with a MultiBG of two envmaps of
    other texels (random, one a scene), each at MIPBIAS."""
    jn, tn, cfg = build_flagship_pair()
    bg_cfg = cfg["model"]["arch"]["bg_module"]
    rng = np.random.default_rng(7)
    mats = rng.normal(-0.5, 0.4, (2, 3, 32, 64)).astype(np.float32)
    jbgs = [b.replace(bg_mat=jnp.asarray(m), mipbias=jnp.asarray(MIPBIAS))
            for b, m in zip((jn.bg_module, jbuild_bg(jax.random.PRNGKey(1),
                                                      bg_cfg)), mats)]
    jn = jn.replace(bg_module=JMultiBG(bgs=tuple(jbgs)))
    tn.bg_module = TMultiBG([tn.bg_module, tbuild_bg(bg_cfg)])
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    return jn, tn, cfg


def test_multibg_state_dict_keys_both_ways():
    """The port's state dict of a dual model has nmf_tpu's keys
    (``.bg_module.bgs[i]...``) and arrays, and loads nmf_tpu's."""
    jn, tn, _ = _dual_pair()
    jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    assert ".bg_module.bgs[1].bg_mat" in tsd
    for k, v in jsd.items():
        np.testing.assert_array_equal(tsd[k], v, err_msg=k)
    assert not torch.equal(tn.bg_module.bgs[0].bg_mat,
                           tn.bg_module.bgs[1].bg_mat)


def test_dual_checkpoint_read_by_each_package(tmp_path):
    """A dual checkpoint: nmf_tpu's ``load`` builds its one envmap afresh
    and drops the saved ones with a warning (ROADMAP C.9); the port's
    raises, naming the limit."""
    jn, tn, cfg = _dual_pair()
    tckpt.save(tmp_path / "dual.th", tn, cfg)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        jm, _, _ = jckpt.load(tmp_path / "dual.th")
    assert any(".bg_module.bgs[0].bg_mat" in str(w.message) for w in seen)
    fresh = jbuild_bg(jax.random.PRNGKey(0), cfg["model"]["arch"]["bg_module"])
    np.testing.assert_array_equal(np.asarray(jm.bg_module.bg_mat),
                                  np.asarray(fresh.bg_mat))
    with pytest.raises(NotImplementedError, match="dual-scene checkpoint"):
        tckpt.load(tmp_path / "dual.th", device="cpu")


def test_nmf_tpu_freezes_the_multibg_envmaps():
    """nmf_tpu's optimizer labels label every leaf of a MultiBG "frozen"
    (lr 0: its dual run never trains its envmaps, ROADMAP C.9); the
    port's give them the envmap's groups."""
    jn, tn, _ = _dual_pair()
    labels = jax.tree_util.tree_leaves(
        jtrainer.make_label_tree(jn).bg_module)
    assert labels and set(labels) == {"frozen"}
    ours = {p: label for p, _, label in ttrainer.differentiated_tensors(tn)
            if p.startswith("bg_module")}
    assert ours["bg_module/bgs/1/bg_mat"] == "bg"
    assert ours["bg_module/bgs/0/mipbias"] == "bg_mipbias"


def test_two_alternating_steps_match_nmf_tpu(monkeypatch):
    """Two steps, scene 0 then scene 1 with its envmap selected, against
    nmf_tpu's jitted step under the port's optimizer labels (the envmaps
    train): the loss, every gradient (test_torch_flagship.py's tolerances)
    and every tensor after each update, the inactive envmap among them:
    its gradient is zero, and Adam's moments move it. Each step starts the
    port from nmf_tpu's tensors; the moments carry on in each package.
    nmf_tpu's update takes the trees with envmap 0 selected, the structure
    its optimizer state was built with: with envmap 1 selected, its step
    raises (ROADMAP C.9)."""
    monkeypatch.setattr(jtrainer, "label_for_path", ttrainer.label_for_path)
    jn, tn, cfg = _dual_pair()
    params = cfg["model"]["params"]
    tx = jtrainer.make_optimizer(jn, jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"],
        lr_init=params["lr_init"], lr_final=params["lr_final"],
        lr_delay_steps=params["lr_delay_steps"],
        lr_delay_mult=params["lr_delay_mult"], n_iters=100))
    state = tx.init(jn)
    jw = jtrainer.LossWeights(ori_lambda=params["ori_lambda"],
                              pred_lambda=params["pred_lambda"],
                              l1_weight=params["L1_weight_initial"])
    jgrad = jax.jit(jax.value_and_grad(
        lambda n, r, g, k: jtrainer.compute_loss(n, r, g, k, jw,
                                                 jnp.ones(3))[0]))
    jupdate = jax.jit(lambda g, st, n: (lambda u: (
        optax.apply_updates(n, u[0]), u[1]))(tx.update(g, st, n)))
    topt = ttrain.make_optimizer(tn, params, 100)
    tw = ttrain.make_loss_weights(params)
    max_lr = max(ttrainer.group_lrs(tn).values())
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    for i in (0, 1):
        jn = jn.replace(bg_module=jn.bg_module.select(i))
        tn.bg_module.select(i)
        weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
        r, g = ds["all_rays"][i * B:(i + 1) * B], ds["all_rgbs"][i * B:
                                                                (i + 1) * B]
        key = jax.random.PRNGKey(40 + i)
        jl, jg = jgrad(jn, jnp.asarray(r), jnp.asarray(g), key)
        topt.zero_grad()
        tl, _ = ttrainer.compute_loss(
            tn, torch.from_numpy(r), torch.from_numpy(g), tw, (1.0, 1.0, 1.0),
            draws=Draws(None, render_draws(key, jn, B, True)))
        tl.backward()
        close(float(tl), float(jl), FWD, "loss")
        grads_match(tn, jg, 5e-4)
        assert tn.bg_module.bgs[1 - i].bg_mat.grad is None
        before = tn.bg_module.bgs[1 - i].bg_mat.detach().clone()
        if i == 1:
            # nmf_tpu's own dual step stops here: the selected envmap is
            # a static field of the tree, so the optimizer state built
            # with envmap 0 selected no longer matches (ROADMAP C.9)
            with pytest.raises(ValueError, match="custom dataclass"):
                jupdate(jg, state, jn)
        # the update of the step, with the optimizer's tree structure
        jn, state = jupdate(
            jg.replace(bg_module=jg.bg_module.select(0)), state,
            jn.replace(bg_module=jn.bg_module.select(0)))
        topt.step()
        if i == 1:
            assert not torch.equal(before, tn.bg_module.bgs[0].bg_mat)
        move = 2 * max_lr * topt.sched(i)
        jgd = jckpt.state_dict(jg)
        for k, v in jckpt.state_dict(jn).items():
            t, transpose = weights.port_tensor(tn, k)
            tv = t.detach().numpy()
            err = np.abs((tv.T if transpose else tv) - v)
            gk = np.abs(jgd[k])
            tight = gk >= 1e-3 * gk.max()
            assert (err[tight] <= 1e-5 + 1e-5 * np.abs(v[tight])).all(), k
            assert (err <= 1e-5 + move).all(), k


TINY = ["model=tensorf", "dataset=synthetic_sphere", "device=cpu",
        "model.params.n_iters=6", "model.params.batch_size=64",
        "field.N_voxel_init=4096", "field.N_voxel_final=8000",
        "field.upsamp_list=[3]", "model.arch.sampler.update_list=[]",
        "model.arch.max_samples_per_ray=32",
        "model.arch.model.diffuse_module.featureC=16",
        "dataset.image_size=12", "dataset.n_views=2", "N_vis=1",
        "progress_refresh_rate=1", "expname=d"]


@pytest.mark.parametrize("given", ["list", "dataset2"])
def test_reconstruction_dual_matches_nmf_tpu(tmp_path, monkeypatch, given):
    """A tiny model=tensorf dual run (two sphere scenes of 2 and 3 views,
    an upsample at 3) in both packages, the port's reached through a
    list-valued ``dataset`` (``train.dispatch``) or ``dataset2=``
    (``train_dualbg.main``): the scene of every iteration, the ray ids it
    drew and the schedule's optimizer rebuild match, and so do the test
    PSNRs to 0.2 dB: the march jitter comes from each package's own
    generator (nmf_tpu folds its key with the step), so the fields differ
    by what other jitter teaches in 6 steps (0.09 dB seen)."""
    drawn = {"jax": [], "torch": []}
    for name, module in (("jax", jtrainer), ("torch", ttrainer)):
        def nextids(self, *a, name=name, fn=module.SimpleSampler.nextids):
            ids = fn(self, *a)
            drawn[name].append((self.total, ids.copy()))
            return ids

        monkeypatch.setattr(module.SimpleSampler, "nextids", nextids)
    argv = [*TINY, f"basedir={tmp_path}", "dataset2=synthetic_sphere",
            "dataset2.n_views=3", "dataset2.image_size=12"]
    jcfg = jconfig.compose(argv)
    if given == "list":
        jcfg["dataset"] = [jcfg["dataset"], jcfg.pop("dataset2")]
    jlines, tlines = [], []
    _, jres = jdual.reconstruction_dual(jcfg, log=jlines.append)
    if given == "list":
        tcfg = ttrain.config_lib.compose(argv)
        tcfg["dataset"] = [tcfg["dataset"], tcfg.pop("dataset2")]
        _, tres = ttrain.dispatch(tcfg, log=tlines.append)
    else:
        run = tdual.reconstruction_dual
        monkeypatch.setattr(tdual, "reconstruction_dual",
                            lambda cfg: run(cfg, log=tlines.append))
        _, tres = tdual.main(argv)
    scenes = [[ln.split()[2] for ln in lines if ln.startswith("iter ")
               and " ds" in ln] for lines in (jlines, tlines)]
    assert scenes[0] == scenes[1] == ["ds0", "ds1"] * 3
    assert len(drawn["jax"]) == len(drawn["torch"]) == 6
    for (na, a), (nb, b) in zip(drawn["jax"], drawn["torch"]):
        assert na == nb and np.array_equal(a, b)
    assert [ln for ln in tlines if "schedule event" in ln]
    assert len(jres) == len(tres) == 2
    for a, b in zip(tres, jres):
        assert abs(a["psnr"] - b["psnr"]) < 0.2, (a, b)
    out = tmp_path / "dual_d"
    assert (out / "dual_d.th").exists()
    assert (out / "imgs_test_0" / "mean.txt").exists()
    assert (out / "imgs_test_1" / "mean.txt").exists()


def test_turned_environment():
    """``make_shiny_dataset(env_yaw_deg=180)`` renders the studio scene
    under its environment turned by half a turn: the panorama rolls by
    half its width, the alpha is the same, the colours are not; a turn
    that is no whole number of the maps' columns raises."""
    kw = dict(n_views=1, H=8, W=8, n_gi_samples=2, scene="studio",
              hemisphere=True, split="test")
    a = make_shiny_dataset(**kw)
    b = make_shiny_dataset(**kw, env_yaw_deg=180.0)
    W = a["gt_bg_im"].shape[1]
    np.testing.assert_array_equal(np.roll(a["gt_bg_im"], W // 2, axis=1),
                                  b["gt_bg_im"])
    np.testing.assert_array_equal(a["all_rgbs"][:, 3], b["all_rgbs"][:, 3])
    assert np.abs(a["all_rgbs"][:, :3] - b["all_rgbs"][:, :3]).max() > 0.05
    with pytest.raises(ValueError, match="columns"):
        make_shiny_dataset(**kw, env_yaw_deg=1.0)
