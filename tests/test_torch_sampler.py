"""nmf_tpu_torch's AlphaGridSampler against nmf_tpu's: the alpha-mask
rebuild, and the flat and two-level marches in eval and, with nmf_tpu's
jitter injected, in training."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from torch_parity import build_pair  # noqa: E402

# a threshold between the cells' alphas, so the rebuilt mask is mixed
THRES = "model.arch.sampler.alphaMask_thres=0.0021"


def _rays(n=96, seed=0):
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    ids = np.random.default_rng(seed).choice(ds["all_rays"].shape[0], n,
                                             replace=False)
    return ds["all_rays"][ids]


@pytest.fixture(scope="module")
def masked_pair():
    """A pair whose alpha mask has been rebuilt by nmf_tpu and carried
    over, so the marches see a mixed mask."""
    jn, tn, _ = build_pair("f32", [THRES])
    jn = jn.replace(sampler=jn.sampler.update(jn.rf))
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    occ = float(np.asarray(jn.sampler.alpha_mask.alpha_volume).mean())
    assert 0.05 < occ < 0.95, occ
    return jn, tn


def test_update_alpha_mask_matches():
    jn, tn, _ = build_pair("f32", [THRES])
    jsamp, jbox = jn.sampler.update_alpha_mask(jn.rf)
    tbox = tn.sampler.update_alpha_mask(tn.rf)
    for name in ("alpha_volume", "coarse_volume"):
        np.testing.assert_array_equal(
            getattr(tn.sampler.alpha_mask, name).numpy(),
            np.asarray(getattr(jsamp.alpha_mask, name)), err_msg=name)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=1e-6)


def _compare(samp_j, samp_t, exact_z=True):
    np.testing.assert_array_equal(samp_t["valid"].numpy(),
                                  np.asarray(samp_j["valid"]))
    for k in ("z_vals", "dists", "xyz"):
        a, b = samp_t[k].numpy(), np.asarray(samp_j[k])
        if exact_z:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            # the jittered march is a cumsum; its f32 rounding depends on
            # the order of the additions
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("k", [-1, 32], ids=["flat", "two_level"])
def test_eval_march_matches(masked_pair, k):
    jn, tn = masked_pair
    rays = _rays()
    sj = jn.sampler.sample(jnp.asarray(rays), is_train=False,
                           max_samples_per_ray=k)
    st = tn.sampler.sample(torch.from_numpy(rays), is_train=False,
                           max_samples_per_ray=k)
    _compare(sj, st)


@pytest.mark.parametrize("k", [-1, 20, 32], ids=["flat", "flat_topk",
                                                 "two_level"])
def test_train_march_with_injected_jitter_matches(masked_pair, k):
    jn, tn = masked_pair
    rays = _rays(seed=1)
    key = jax.random.PRNGKey(7)
    # exactly as render draws it: keys = split(key, 4), uniform(keys[0])
    keys = jax.random.split(key, 4)
    jitter = np.asarray(jax.random.uniform(keys[0],
                                           (96, jn.sampler.n_samples)))
    sj = jn.sampler.sample(jnp.asarray(rays), key=keys[0], is_train=True,
                           max_samples_per_ray=k)
    st = tn.sampler.sample(torch.from_numpy(rays), is_train=True,
                           jitter=torch.from_numpy(jitter),
                           max_samples_per_ray=k)
    _compare(sj, st, exact_z=False)


def test_sampler_schedule_matches():
    jn, tn, _ = build_pair("f32", [THRES,
                                   "model.arch.sampler.update_list=[2]"])
    for it in range(1, 4):
        new, changed = jn.sampler.check_schedule(it, 1, jn.rf)
        assert tn.sampler.check_schedule(it, tn.rf) == changed
        jn = jn.replace(sampler=new)
    np.testing.assert_array_equal(
        tn.sampler.alpha_mask.alpha_volume.numpy(),
        np.asarray(jn.sampler.alpha_mask.alpha_volume))
    assert tn.sampler.n_samples == jn.sampler.n_samples
    assert tn.sampler.stepsize == pytest.approx(jn.sampler.stepsize)
