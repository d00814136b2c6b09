"""nmf_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor nmf_tpu, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nmf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from nmf_tpu_torch.ops.kernels import binsum as tbin  # noqa: E402
from nmf_tpu_torch.ops.kernels import composite as tcomp  # noqa: E402
from torch_inputs import binsum_case, composite_inputs, cotangents  # noqa: E402,E501


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["moderate", "opaque"])
def test_composite_kernel_matches_plain_on_card(cuda, opaque):
    args = [torch.from_numpy(a).to(cuda) for a in
            composite_inputs(B=300, K=192, seed=6, opaque=opaque)]
    cots = [torch.from_numpy(c).to(cuda) for c in cotangents(300, 192)]
    results = []
    for fn in (tcomp.composite_rays, tcomp.composite_rays_plain):
        ts = [a.clone().requires_grad_(True) for a in args]
        outs = fn(*ts)
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        results.append(([o.detach() for o in outs], [t.grad for t in ts]))
    torch.cuda.synchronize()
    for a, b in zip(results[0][0], results[1][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_transmittance_kernel_matches_plain_on_card(cuda):
    sigma, dists = (torch.from_numpy(a).to(cuda) for a in
                    composite_inputs(B=500, K=192, seed=7, opaque=True)[:2])
    g = torch.randn(500, 192, device=cuda)
    grads = []
    for fn in (tcomp.transmittance_weights, tcomp.transmittance_weights_plain):
        s = sigma.clone().requires_grad_(True)
        d = dists.clone().requires_grad_(True)
        w = fn(s, d)
        (w * g).sum().backward()
        grads.append((w.detach(), s.grad, d.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["collisions", "runs"])
def test_binsum_kernel_matches_plain_on_card(cuda, case):
    # atomics add in a varying order: rtol/atol 1e-4
    idx, vals, R = binsum_case(case)
    idx_t, vals_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    out = tbin.binsum_rows(idx_t, vals_t, R)
    ref = tbin.binsum_rows_plain(idx_t, vals_t, R)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_quad_gather_backward_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(8)
    plane = rng.normal(size=(40, 33, 33)).astype(np.float32)
    coords = rng.uniform(-1.05, 1.05, size=(4096, 2)).astype(np.float32)
    g = rng.normal(size=(4096, 40)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = torch.tensor(plane, device=dev, requires_grad=True)
        out = tgs.quad_gather_2d(p, torch.from_numpy(coords).to(dev))
        (out * torch.from_numpy(g).to(dev)).sum().backward()
        grads.append(p.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device():
    # tensors on cuda:1 while cuda:0 is current: each wrapper must launch
    # on cuda:1, where the pointers live
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    idx, vals, R = binsum_case("runs")
    sigma, dists, rgb, z = (torch.from_numpy(a).to(dev) for a in
                            composite_inputs(B=64, K=32, seed=9, opaque=True))
    with torch.cuda.device(0):
        idx_t, vals_t = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
        torch.testing.assert_close(tbin.binsum_rows(idx_t, vals_t, R),
                                   tbin.binsum_rows_plain(idx_t, vals_t, R),
                                   rtol=1e-4, atol=1e-4)
        s = sigma.clone().requires_grad_(True)
        w = tcomp.transmittance_weights(s, dists)
        w.sum().backward()
        s_ref = sigma.clone().requires_grad_(True)
        w_ref = tcomp.transmittance_weights_plain(s_ref, dists)
        w_ref.sum().backward()
        torch.cuda.synchronize(dev)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s.grad, s_ref.grad, rtol=1e-4, atol=1e-4)
