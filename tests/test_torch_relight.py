"""Relighting in nmf_tpu_torch against nmf_tpu: the restricted checkpoint
reader on nmf_tpu's fitted-envmap file (in a process without JAX), the
envmap files, PFM images and ``scripts/pano2env.py``'s fit (``render_only
fixed_bg=`` is in test_torch_paths.py, with nmf_tpu's other eval
renders)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu.data import ray_utils as jray  # noqa: E402
from nmf_tpu.modules.bg import init_integral_equirect as jinit_bg  # noqa: E402
from nmf_tpu.scripts import pano2env as jpano2env  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch.data import exr as texr  # noqa: E402
from nmf_tpu_torch.data import ray_utils as tray  # noqa: E402
from nmf_tpu_torch.scripts import pano2env as tpano2env  # noqa: E402
from torch_parity import build_flagship_pair, close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FWD = 1e-5
# the fit of the parity tests: an HDR panorama of 8 x 16, an envmap of 16
# x 32, 512 pixels a step
RES, BATCH, STEPS = 16, 512, 5



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _pano(seed=0, shape=(8, 16, 3)):
    return np.random.default_rng(seed).gamma(0.6, 2.0, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_envmap(tmp_path_factory):
    """nmf_tpu's fit of ``_pano()`` (STEPS steps), written by its
    ``ckpt.save`` as pano2env writes it: (path, the fitted envmap)."""
    path = tmp_path_factory.mktemp("env") / "env.th"
    bg = jpano2env.fit_pano(_pano(), bg_resolution=RES, iters=STEPS,
                            batch=BATCH, log=lambda s: None)
    jckpt.save(path, bg, {"source": "pano"})
    return path, bg


def _lookup_inputs(n=300):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d, rng.uniform(-8, -1, n).astype(np.float32)


def test_nmf_tpu_envmap_file_reads_without_jax(tmp_path, jax_envmap):
    """A process that loads no JAX reads nmf_tpu's fitted-envmap file
    through ``load_envmap``; jax, flax and nmf_tpu stay unloaded, its
    arrays and settings are nmf_tpu's, and its lookups agree with nmf_tpu's
    on the same directions and solid angles to 1e-2 of the map's largest
    value: the SAT sums in another order, and a box of a few texels
    carries that error times 1000 / area
    (``test_torch_flagship_modules.py::test_envmap_matches``)."""
    path, jbg = jax_envmap
    d, sa = _lookup_inputs()
    np.save(tmp_path / "d.npy", d)
    np.save(tmp_path / "sa.npy", sa)
    code = (
        "import sys, numpy as np, torch\n"
        "from nmf_tpu_torch import ckpt\n"
        f"bg = ckpt.load_envmap({str(path)!r}, 'cpu')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nmf_tpu')]\n"
        "assert not bad, bad\n"
        f"d = torch.from_numpy(np.load({str(tmp_path / 'd.npy')!r}))\n"
        f"sa = torch.from_numpy(np.load({str(tmp_path / 'sa.npy')!r}))\n"
        "with torch.no_grad():\n"
        f"    np.save({str(tmp_path / 'out.npy')!r}, bg(d, sa).numpy())\n"
        f"np.save({str(tmp_path / 'mat.npy')!r}, bg.bg_mat.detach().numpy())\n"
        "print(bg.lr, bg.mipbias_lr, bg.brightness_lr, bg.mul_lr)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert [float(x) for x in out.stdout.split()] == [
        jbg.lr, jbg.mipbias_lr, jbg.brightness_lr, jbg.mul_lr]
    np.testing.assert_array_equal(np.load(tmp_path / "mat.npy"),
                                  np.asarray(jbg.bg_mat))
    close(np.load(tmp_path / "out.npy"),
          np.asarray(jbg(jnp.asarray(d), jnp.asarray(sa))), 1e-2, "lookups",
          scale=float(np.exp(np.asarray(jbg.bg_mat)).max()))


def test_envmap_files_round_trip(tmp_path, jax_envmap):
    """``load_envmap`` reads nmf_tpu's file, the port's own
    (``save_envmap``) and a format-2 checkpoint's envmap, each exactly."""
    path, jbg = jax_envmap
    bg = tckpt.load_envmap(path, "cpu")
    for k in ("bg_mat", "mipbias", "brightness", "mul"):
        np.testing.assert_array_equal(getattr(bg, k).detach().numpy(),
                                      np.asarray(getattr(jbg, k)), err_msg=k)
    tckpt.save_envmap(tmp_path / "own.th", bg)
    own = tckpt.load_envmap(tmp_path / "own.th", "cpu")
    _, tn, cfg = build_flagship_pair()
    tckpt.save(tmp_path / "f.th", tn, cfg)
    inner = tckpt.load_envmap(tmp_path / "f.th", "cpu")
    for a, b in ((own, bg), (inner, tn.bg_module)):
        for k in ("bg_mat", "mipbias", "brightness", "mul"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        assert (a.lr, a.mipbias_lr) == (b.lr, b.mipbias_lr)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tckpt.load_envmap(path)


def test_reader_refuses_other_classes(tmp_path):
    """The restricted reader imports nothing a file names beyond numpy's
    array reconstruction."""
    import pickle

    class Probe:
        def __reduce__(self):
            return (subprocess.getoutput, ("echo hi",))

    (tmp_path / "x.th").write_bytes(pickle.dumps({"format": 2, "p": Probe()}))
    with pytest.raises(pickle.UnpicklingError, match="subprocess.getoutput"):
        tckpt.load(tmp_path / "x.th", device="cpu")


@pytest.mark.parametrize("shape", [(5, 7, 3), (5, 7)], ids=["rgb", "grey"])
def test_pfm_round_trip_and_cross_read(tmp_path, shape):
    img = _pano(2, shape) - 1.0
    tray.write_pfm(tmp_path / "t.pfm", img, scale=2.0)
    jray.write_pfm(tmp_path / "j.pfm", img, scale=2.0)
    assert ((tmp_path / "t.pfm").read_bytes()
            == (tmp_path / "j.pfm").read_bytes())
    for path in ("t.pfm", "j.pfm"):
        for read in (tray.read_pfm, jray.read_pfm):
            data, scale = read(tmp_path / path)
            np.testing.assert_array_equal(data, img)
            assert scale == 2.0


def _jax_first_step(pano):
    """nmf_tpu's pano fit, its first step taken op by op: (loss, grads,
    Adam's first and second moments), leaves in the port's order."""
    bg = jinit_bg(jax.random.PRNGKey(0), bg_resolution=RES,
                  init_val=float(np.log(max(pano.mean(), 1e-3))),
                  activation="exp", mipbias=0.0)
    dirs = tpano2env.pano_directions(*pano.shape[:2])
    ids = np.random.default_rng(0).integers(0, dirs.shape[0], size=(BATCH,))
    d = jnp.asarray(dirs[ids])
    c = jnp.asarray(pano.reshape(-1, 3)[ids])

    def loss_fn(bg):
        return jnp.abs(bg(d, jnp.full((BATCH,), -6.0)) - c).mean()

    loss, grads = jax.value_and_grad(loss_fn)(bg)
    tx = optax.adam(0.15, b1=0.9, b2=0.99)
    _, state = tx.update(grads, tx.init(bg))
    names = ("bg_mat", "mipbias", "brightness", "mul")
    return (float(loss), [np.asarray(getattr(grads, k)) for k in names],
            [np.asarray(getattr(state[0].mu, k)) for k in names],
            [np.asarray(getattr(state[0].nu, k)) for k in names])


def test_fit_pano_matches_nmf_tpu(jax_envmap):
    """Both fits on the same pixels. The first step: the gradients and
    Adam's moments at FWD relative to each tensor's largest entry (3e-6
    seen), the loss to 1e-3 (1e-4 seen: at log solid angle -6 a lookup box
    is one texel, a difference of SAT entries summed in another order,
    ``test_torch_flagship_modules.py::test_envmap_matches``). After STEPS
    steps the texels are not comparable one by one: the SAT's backward
    leaves the texels that no box covers a gradient of rounding noise,
    which Adam's first steps (~lr * sign(g)) turn into moves of up to lr
    in either direction, in both packages alike. So the two fitted maps
    are held by what the fit minimizes, the mean absolute error over every
    pixel of the panorama, each under its own package's lookups: to 1e-2
    (2e-3 seen)."""
    pano = _pano()
    first = {}

    def on_step(it, loss, tensors, grads, m, v):
        if it == 0:
            first.update(loss=float(loss), grads=[g.numpy() for g in grads],
                         m=[x.numpy().copy() for x in m],
                         v=[x.numpy().copy() for x in v])

    bg = tpano2env.fit_pano(pano, bg_resolution=RES, iters=STEPS,
                            batch=BATCH, device="cpu", log=lambda s: None,
                            on_step=on_step)
    jloss, jgrads, jm, jv = _jax_first_step(pano)
    assert first["loss"] == pytest.approx(jloss, rel=1e-3)
    for name, ours, theirs in (("grad", first["grads"], jgrads),
                               ("m", first["m"], jm), ("v", first["v"], jv)):
        for i, (a, b) in enumerate(zip(ours, theirs)):
            close(a, b, FWD, f"{name} {i}")
    _, jbg = jax_envmap
    dirs = tpano2env.pano_directions(*pano.shape[:2])
    cols = pano.reshape(-1, 3)
    sa = np.full((dirs.shape[0],), -6.0, np.float32)
    with torch.no_grad():
        ours = float((bg(torch.from_numpy(dirs), torch.from_numpy(sa))
                      - torch.from_numpy(cols)).abs().mean())
    theirs = float(jnp.abs(jbg(jnp.asarray(dirs), jnp.asarray(sa))
                           - cols).mean())
    assert ours == pytest.approx(theirs, rel=1e-2)


def test_pano2env_cli_reads_exr_and_pfm(tmp_path):
    """The script on an EXR and on a PFM of the same panorama writes the
    same envmap file."""
    pano = _pano()
    texr.write_exr(tmp_path / "p.exr", pano)
    tray.write_pfm(tmp_path / "p.pfm", pano)
    for name in ("p.exr", "p.pfm"):
        tpano2env.main([str(tmp_path / name), str(tmp_path / f"{name}.th"),
                        "--resolution", "8", "--iters", "2",
                        "--device", "cpu"])
    a, b = (tckpt.load_envmap(tmp_path / f"{n}.th", "cpu")
            for n in ("p.exr", "p.pfm"))
    assert torch.equal(a.bg_mat, b.bg_mat) and a.bg_mat.shape == (3, 8, 16)


def test_pano2env_fit_is_mirrored_against_gt_bg():
    """nmf_tpu's fit (so the port's) reads a panorama mirrored left to
    right against the gt_bg convention of the envmap metrics: the fit of
    the mirrored panorama scores the higher envmap_psnr against it
    (ROADMAP C.9)."""
    rng = np.random.default_rng(3)
    gt = np.full((16, 32, 3), 0.2, np.float32)
    gt[3:7, 4:10] = rng.uniform(1, 4, 3)   # a lamp off the centre column
    scores = []
    for pano in (gt, gt[:, ::-1]):
        bg = tpano2env.fit_pano(np.ascontiguousarray(pano), bg_resolution=16,
                                iters=60, batch=2048, device="cpu",
                                log=lambda s: None)
        scores.append(teval.calc_envmap_metrics(bg, gt)["envmap_psnr"])
    assert scores[1] > scores[0] + 1, scores  # 14.6 against 12.4 dB seen
