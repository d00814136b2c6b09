"""Field distillation and mesh export of nmf_tpu_torch against nmf_tpu's,
on the CPU at tiny sizes: ``scripts/fit_field.py`` (a 16^3 TensorVMSplit
source, as nmf_tpu's own test; a 24^3 grid and a 4-level hash field of
2^10 rows as targets; nmf_tpu's key splits replayed as the port's named
draws), ``scripts/export_mesh.py`` (``density_volume``, the PLY),
``ops/marching.py`` and ``scripts/graph_brdfs.py``, and the distilled
checkpoint's config (ROADMAP C.15: the port's file loads back as the
distilled field in both packages; nmf_tpu's loads as the source's field
type with the distilled arrays dropped).

Tolerances: the first step's loss, every gradient and the Adam moments
1e-5 of each array's largest; the losses of five steps 1e-4 relative;
the density volume 1e-5; the mesh's vertices 1e-4 with equal faces; the
BRDF lobe image 1e-5 of its largest.
"""
import argparse
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu.fields.grid import init_grid_rf as jinit_grid  # noqa: E402
from nmf_tpu.fields.hashgrid import init_hashgrid_rf as jinit_hash  # noqa: E402
from nmf_tpu.fields.tensorf import FactorGrid  # noqa: E402
from nmf_tpu.fields.tensorf import init_tensorvm_split as jinit_vm  # noqa: E402
from nmf_tpu.ops.marching import marching_tets as jmarch  # noqa: E402
from nmf_tpu.scripts import export_mesh as jexport  # noqa: E402
from nmf_tpu.scripts import fit_field as jfit  # noqa: E402
from nmf_tpu.scripts.graph_brdfs import graph_brdfs as jgraph  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.fields.grid import GridRF, init_grid_rf  # noqa: E402
from nmf_tpu_torch.fields.hashgrid import (HashGridRF,  # noqa: E402
                                           init_hashgrid_rf)
from nmf_tpu_torch.fields.tensorf import init_tensorvm_split  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.ops.marching import marching_tets  # noqa: E402
from nmf_tpu_torch.scripts import export_mesh, fit_field  # noqa: E402
from nmf_tpu_torch.scripts.graph_brdfs import graph_brdfs  # noqa: E402
from torch_parity import AABB, NEAR_FAR, build_flagship_pair, close  # noqa: E402

FWD, STEP_LOSS = 1e-5, 1e-4
BATCH = 4096
VM = dict(grid_size=[16, 16, 16], N_voxel_init=16 ** 3,
          N_voxel_final=16 ** 3, upsamp_list=())
TARGETS = {"grid": dict(grid_size=(24, 24, 24)),
           "hashgrid": dict(n_levels=4, log2_hashmap_size=10)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(module, jtree):
    """The port's ``module`` with nmf_tpu's arrays of ``jtree``."""
    return weights.from_jax_state_dict(module, jckpt.state_dict(jtree))


def _pair(target):
    """(nmf_tpu source, its port; nmf_tpu target, its port)."""
    jsrc = jinit_vm(jax.random.PRNGKey(0), AABB, **VM)
    tsrc = _port(init_tensorvm_split(torch.Generator().manual_seed(0), AABB,
                                     **VM), jsrc)
    jinit, tinit = {"grid": (jinit_grid, init_grid_rf),
                    "hashgrid": (jinit_hash, init_hashgrid_rf)}[target]
    jtgt = jinit(jax.random.PRNGKey(1), AABB, **TARGETS[target])
    ttgt = _port(tinit(torch.Generator().manual_seed(1), AABB,
                       **TARGETS[target]), jtgt)
    return jsrc, tsrc, jtgt, ttgt


def _replayed_points(key, steps):
    """nmf_tpu's fit_field key splits as the port's named draws: step
    ``it``'s U[0, 1) points under ``points{it}``."""
    given = {}
    for it in range(steps):
        key, sk = jax.random.split(key)
        given[f"points{it}"] = np.asarray(jax.random.uniform(sk, (BATCH, 3)))
    return given


def _jax_loss(src, fit_app=True):
    """nmf_tpu's fit_field loss (its ``loss_fn``)."""
    def loss_fn(rf, xyz):
        s_sig = jax.lax.stop_gradient(
            src.compute_densityfeature(xyz, activate=False))
        loss = ((rf.compute_densityfeature(xyz, activate=False) - s_sig)
                ** 2).mean()
        if fit_app:
            s_app = jax.lax.stop_gradient(src.compute_appfeature(xyz))
            loss = loss + ((rf.compute_appfeature(xyz) - s_app) ** 2).mean()
        return loss
    return loss_fn


def _port_view(module, tensor, key):
    """``tensor`` (a port tensor's gradient or moment) in nmf_tpu's layout
    under the state-dict ``key``."""
    if hasattr(module, "jax_leaves") and key.lstrip(".") in module.jax_leaves():
        return module.jax_leaves(tensor)[key.lstrip(".")]
    _, transpose = weights.port_tensor(module, key)
    return tensor.t() if transpose else tensor


@pytest.mark.parametrize("target", ["grid", "hashgrid"])
def test_fit_first_step_matches(target):
    """One fit step: the loss, the gradient of every target leaf (its box
    too: nmf_tpu differentiates it, ROADMAP C.16) and optax.adam's
    moments."""
    jsrc, tsrc, jtgt, ttgt = _pair(target)
    given = _replayed_points(jax.random.PRNGKey(2), 1)
    aabb = jnp.asarray(jsrc.aabb)
    xyz = jax.random.uniform(jax.random.split(jax.random.PRNGKey(2))[1],
                             (BATCH, 3), minval=aabb[0], maxval=aabb[1])
    jloss, jgrads = jax.value_and_grad(_jax_loss(jsrc))(jtgt, xyz)
    tx = optax.adam(1e-2)
    _, jopt = tx.update(jgrads, tx.init(jtgt), params=jtgt)

    txyz = fit_field.sample_points(Draws(given=given), 0, tsrc.aabb, BATCH)
    # XLA fuses the scale and shift (1 ulp)
    np.testing.assert_allclose(txyz.numpy(), np.asarray(xyz), rtol=0,
                               atol=1e-6)
    tensors = fit_field.fit_tensors(ttgt)
    for t in tensors:
        t.requires_grad_(True)
    loss = fit_field.fit_loss(tsrc, ttgt, txyz)
    loss.backward()
    close(float(loss.detach()), float(jloss), FWD, "loss")
    grads = {id(t): t.grad.clone() for t in tensors}
    opt = fit_field.FitAdam(tensors, 1e-2)
    opt.step()
    moments = {id(t): (m, v) for t, m, v in zip(tensors, opt.m, opt.v)}
    mu, nu = jopt[0].mu, jopt[0].nu
    for key, g in jckpt.state_dict(jgrads).items():
        t, _ = weights.port_tensor(ttgt, key)
        owner = next(p for p in tensors if p is t or (
            hasattr(ttgt, "grid_rows") and p is ttgt.grid_rows
            and key in (".density_grid", ".app_grid")))
        close(_port_view(ttgt, grads[id(owner)], key).numpy(), g, FWD,
              f"grad {key}")
        for name, tree, mom in (("mu", mu, moments[id(owner)][0]),
                                ("nu", nu, moments[id(owner)][1])):
            close(_port_view(ttgt, mom, key).numpy(),
                  jckpt.state_dict(tree)[key], FWD, f"{name} {key}")


@pytest.mark.parametrize("target", ["grid", "hashgrid"])
def test_fit_five_steps_match(target):
    """fit_field's logged losses over five steps, the box moved as
    nmf_tpu moves it."""
    jsrc, tsrc, jtgt, ttgt = _pair(target)
    jfitted, jlosses = jfit.fit_field(jsrc, jtgt, jax.random.PRNGKey(2),
                                      steps=5, batch=BATCH, lr=1e-2,
                                      log_every=1)
    given = _replayed_points(jax.random.PRNGKey(2), 5)
    fitted, losses = fit_field.fit_field(tsrc, ttgt, steps=5, batch=BATCH,
                                         lr=1e-2, log_every=1,
                                         draws=Draws(given=given),
                                         log=lambda s: None)
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_LOSS)
    # the box's gradient sums terms of every point that nearly cancel, and
    # Adam scales it to ~lr a step: rounding moves it by up to ~lr / 10
    moved = np.abs(fitted.aabb.numpy() - AABB)
    assert moved.max() > 2e-2 and np.abs(np.asarray(jfitted.aabb)
                                         - AABB).max() > 2e-2
    np.testing.assert_allclose(fitted.aabb.numpy(), jfitted.aabb, rtol=0,
                               atol=2e-3)
    assert not fitted.aabb.requires_grad


def _source_checkpoint(tmp_path):
    """A tiny model=tensorf checkpoint written by the port."""
    cfg = tconfig.compose(["model=tensorf", "dataset=synthetic_sphere",
                           "field.N_voxel_init=4096",
                           "field.N_voxel_final=4096",
                           "model.arch.model.diffuse_module.featureC=16"])
    nmf = tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    path = tmp_path / "src.th"
    tckpt.save(path, nmf, cfg)
    return path


@pytest.mark.parametrize("target,cls,jcls", [
    ("grid", GridRF, "GridRF"), ("hashgrid", HashGridRF, "HashGridRF")])
def test_distilled_checkpoint_loads_as_its_field(tmp_path, target, cls,
                                                 jcls):
    """The port's CLI saves the target field's config (ROADMAP C.15): its
    file loads back as the distilled field, arrays and all, in both
    packages, and keeps distilled_from and fit_losses."""
    src = _source_checkpoint(tmp_path)
    out = tmp_path / f"{target}.th"
    res = fit_field.main(["--ckpt", str(src), "--target", target,
                          "--steps", "3", "--batch", "256",
                          "--grid-size", "8", "--out", str(out),
                          "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    nmf, cfg, extra = tckpt.load(out, device="cpu")
    assert isinstance(nmf.rf, cls)
    assert extra["distilled_from"] == str(src)
    assert extra["fit_losses"] == res["losses"]
    assert cfg["model"]["arch"]["rf"] == cfg["field"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jn, jcfg, _ = jckpt.load(str(out))
    assert type(jn.rf).__name__ == jcls
    sd = weights.to_jax_state_dict(nmf)
    for key, v in jckpt.state_dict(jn).items():
        np.testing.assert_array_equal(sd[key], np.asarray(v), err_msg=key)
    if target == "grid":
        assert nmf.rf.grid_size == (8, 8, 8) == jn.rf.grid_size


def test_nmf_tpu_distilled_checkpoint_drops_the_field(tmp_path):
    """nmf_tpu's CLI saves the source's config (ROADMAP C.15): its file
    loads as a TensorVMSplit, the distilled arrays dropped with a warning;
    the port refuses the keys it has no tensor for."""
    jsrc = tmp_path / "jsrc.th"
    cfg = tconfig.compose(["model=tensorf", "dataset=synthetic_sphere",
                           "field.N_voxel_init=4096",
                           "field.N_voxel_final=4096",
                           "model.arch.model.diffuse_module.featureC=16"])
    jckpt.save(str(jsrc), jckpt.load(str(_source_checkpoint(tmp_path)))[0],
               config=cfg)
    out = tmp_path / "jgrid.th"
    jfit.main(["--ckpt", str(jsrc), "--target", "grid", "--steps", "2",
               "--batch", "256", "--grid-size", "8", "--out", str(out)])
    with pytest.warns(UserWarning, match="no matching leaf"):
        jn, _, _ = jckpt.load(str(out))
    assert type(jn.rf).__name__ == "TensorVMSplit"
    with pytest.raises(KeyError, match="density_grid"):
        tckpt.load(out, device="cpu")


def read_ply(path):
    """(verts (V, 3) float32, faces (F, 3) int32) of a binary PLY as
    export_mesh writes it (float xyz, uchar-counted int triangles)."""
    data = open(path, "rb").read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    head = data[:end].decode().splitlines()
    n_v = int(next(ln for ln in head if ln.startswith("element vertex"))
              .split()[-1])
    n_f = int(next(ln for ln in head if ln.startswith("element face"))
              .split()[-1])
    verts = np.frombuffer(data, "<f4", 3 * n_v, end).reshape(n_v, 3)
    rec = np.frombuffer(data, [("n", "u1"), ("idx", "<i4", 3)], n_f,
                        end + 12 * n_v)
    if n_f and not np.all(rec["n"] == 3):
        raise ValueError(f"{path}: a face that is not a triangle")
    return verts, rec["idx"]


def _blob_fields():
    """A 16^3 TensorVMSplit whose density is a positive blob in the
    middle (nmf_tpu's mesh test's), in both packages."""
    rf = jinit_vm(jax.random.PRNGKey(0), AABB, **VM)
    bump = jnp.exp(-((jnp.linspace(-1, 1, 16)) ** 2) * 4)
    planes = tuple(jnp.ones((16, 16, 16)) * 0.5 for _ in range(3))
    lines = tuple(jnp.broadcast_to(bump[None], (16, 16)) for _ in range(3))
    rf = rf.replace(density_rf=FactorGrid(planes=planes, lines=lines),
                    density_shift=0.0)
    trf = _port(init_tensorvm_split(torch.Generator().manual_seed(0), AABB,
                                    density_shift=0.0, **VM), rf)
    return argparse.Namespace(rf=rf), argparse.Namespace(rf=trf)


def test_density_volume_matches():
    jn, tn = _blob_fields()
    jvol, jaabb = jexport.density_volume(jn, reso=32)
    tvol, taabb = export_mesh.density_volume(tn, reso=32)
    np.testing.assert_array_equal(taabb, np.asarray(jaabb))
    close(tvol, jvol, FWD, "density volume")


def test_marching_tets_equal():
    n = 20
    lin = np.linspace(-1, 1, n)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = 0.6 - np.sqrt(gx ** 2 + (1.3 * gy) ** 2 + gz ** 2)
    verts, faces = marching_tets(vol, level=0.0)
    jverts, jfaces = jmarch(vol, level=0.0)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


def test_export_mesh_matches(tmp_path, monkeypatch):
    """The blob's mesh at reso 32 and the default level 5. The two volumes
    differ by rounding (1e-6 of the largest), which moves some vertices
    across the marcher's 1e-5 weld grid, so the vertex lists differ in
    length: the triangles, each as its three corners, are held within
    1e-4. On nmf_tpu's volume the port's mesh is nmf_tpu's, faces and
    vertices equal, and both PLY files parse to it with the same
    header."""
    jn, tn = _blob_fields()
    jv, jf = jexport.export_mesh(jn, str(tmp_path / "j.ply"), reso=32)
    tv, tf = export_mesh.export_mesh(tn, str(tmp_path / "t.ply"), reso=32)
    assert len(tf) == len(jf) > 1000
    np.testing.assert_allclose(tv[tf], jv[jf], rtol=0, atol=1e-4)
    jvol = jexport.density_volume(jn, reso=32)
    monkeypatch.setattr(export_mesh, "density_volume",
                        lambda nmf, reso: (np.asarray(jvol[0]),
                                           np.asarray(jvol[1])))
    tv, tf = export_mesh.export_mesh(tn, str(tmp_path / "t.ply"), reso=32)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)
    pv, pf = read_ply(tmp_path / "t.ply")
    jpv, jpf = read_ply(tmp_path / "j.ply")
    np.testing.assert_array_equal(pf, jpf)
    np.testing.assert_array_equal(pv, jpv)
    np.testing.assert_array_equal(pv, tv.astype(np.float32))
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())


def test_export_mesh_cli(tmp_path):
    """export_mesh's CLI on a port checkpoint: the PLY holds what it
    printed."""
    src = _source_checkpoint(tmp_path)
    res = export_mesh.main([str(src), str(tmp_path / "m.ply"), "--reso",
                            "16", "--device", "cpu"])
    v, f = read_ply(tmp_path / "m.ply")
    assert len(v) == len(res["verts"]) and len(f) == len(res["faces"])
    assert res["density"] >= 0 and res["marching"] >= 0


def test_graph_brdfs_matches():
    """The tiny flagship's lobes at res 16 for 2 points and 2 views."""
    jn, tn, _ = build_flagship_pair()
    rng = np.random.default_rng(4)
    xyz = np.concatenate([rng.uniform(-1, 1, (2, 3)),
                          np.full((2, 1), 0.01)], -1).astype(np.float32)
    v = rng.normal(size=(2, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    feats = rng.normal(size=(2, tn.rf.app_dim)).astype(np.float32)
    jim = np.asarray(jgraph(jn.model, jnp.asarray(xyz), jnp.asarray(v),
                            jnp.asarray(feats), res=16))
    tim = graph_brdfs(tn.model, torch.from_numpy(xyz), torch.from_numpy(v),
                      torch.from_numpy(feats), res=16).numpy()
    assert tim.shape == jim.shape == (2 * 16, 2 * 2 * 16, 3)
    close(tim, jim, FWD, "lobe image")
