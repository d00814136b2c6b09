"""Inputs shared by the nmf_tpu_torch kernel tests (numpy only, so the
on-card tests run where JAX is not installed)."""
import numpy as np


def composite_inputs(B=37, K=16, seed=0, opaque=False):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0, 5, (B, K)).astype(np.float32)
    dists = rng.uniform(0, 0.2, (B, K)).astype(np.float32)
    if opaque:
        # sigma * dist up to 60: T underflows to 0 within a few samples
        sigma = rng.uniform(0, 300, (B, K)).astype(np.float32)
        sigma[::3, ::2] = 0.0
    rgb = rng.uniform(0, 1, (B, K, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (B, K)), -1).astype(np.float32)
    return sigma, dists, rgb, z


def cotangents(B, K, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, K)).astype(np.float32),
            rng.normal(size=(B, 3)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32))


def binsum_case(case):
    rng = np.random.default_rng(11)
    if case == "collisions":
        # the pattern of tests/test_pallas.py: everything piles into 7 rows
        # and 100 rows are out of range
        N, C, R = 4000, 8, 1500
        idx = rng.integers(0, 7, N).astype(np.int32)
        idx[:100] = R + 999
        idx[100:150] = -3
    else:
        # runs of repeated ids, as consecutive samples of a ray give
        N, C, R = 5000, 24, 3000
        idx = np.repeat(rng.integers(0, R, N // 10), 10).astype(np.int32)
    vals = rng.normal(size=(N, C)).astype(np.float32)
    return idx, vals, R
