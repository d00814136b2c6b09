"""Inputs shared by the nmf_tpu_torch kernel tests (numpy only, so the
on-card tests run where JAX is not installed)."""
import numpy as np

# the tiny flagship of __graft_entry__.py's multi-chip dry run: grid 16,
# envmap 32 x 64, 16 samples a ray (8 after the proposal, 8 retraced),
# bounce budgets [512, 128], 32 retrace rays; f32 gathers
FLAGSHIP = ["model=microfacet_tensorf2", "dataset=synthetic_sphere",
            "field.N_voxel_init=4096", "field.N_voxel_final=8000",
            "field.upsamp_list=[]", "field.gather_dtype=f32",
            "model.arch.max_samples_per_ray=16",
            "model.arch.recur_samples_per_ray=8",
            "model.arch.proposal_samples_per_ray=8",
            "model.arch.model.brdf_ray_budget=[512,128]",
            "model.arch.model.max_retrace_rays=[32]",
            "model.arch.bg_module.bg_resolution=32"]

# the tiny flagship on the dense voxel field: a 16^3 grid (table rows of
# 28 f32 columns)
GRID = ["field=grid", "field.grid_size=[16,16,16]",
        *(o for o in FLAGSHIP if not o.startswith("field."))]

# the tiny occupancy-grid NMF (model=microfacet_tensorf): the flagship's
# tiny widths and a 16^3 occupancy grid
OCCGRID = ["model=microfacet_tensorf", *FLAGSHIP[1:],
           "model.arch.sampler.grid_size=16"]

# the tiny Ref-NeRF on the tensorf field: grid 16, 16 samples a ray
REFNERF = ["model=refnerf", *FLAGSHIP[1:7],
           "model.arch.sampler.update_list=[]"]

# the tiny Ref-NeRF on the hash field (tests/test_extras.py's: 4 levels,
# tables of 2^12 rows, finest resolution 64), a 16^3 occupancy grid
REFNERF_TCNN = ["model=refnerf_tcnn", "field=hashgrid",
                "dataset=synthetic_sphere", "field.n_levels=4",
                "field.log2_hashmap_size=12", "field.finest_resolution=64",
                "model.arch.sampler.grid_size=16",
                "model.arch.max_samples_per_ray=16",
                "model.arch.bg_module.bg_resolution=32"]

# the tiny DualModel warmup (model1 Ref-NeRF, model2 the flagship's tiny
# microfacet), switching at iteration 3
DUALREF = ["model=microfacet_dualref", *FLAGSHIP[1:9],
           "model.arch.model.warmup_iters=3",
           "model.arch.model.model2.brdf_ray_budget=[512,128]",
           "model.arch.model.model2.max_retrace_rays=[32]",
           "model.arch.bg_module.bg_resolution=32"]


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


def sorted_runs(rng, N, R, longest):
    """N sorted row ids in [0, R), in runs of 1 to ``longest`` equal ids."""
    ids = np.sort(rng.choice(R, N, replace=False))
    return np.repeat(ids, rng.integers(1, longest + 1, N))[:N].astype(
        np.int32)


def binsum_case(case):
    """(idx, vals, R) of a named K3 case; vals are f32 (the bf16 cases
    round them to bf16 where they use them)."""
    rng = np.random.default_rng(11)
    if case.startswith("bf16"):
        # the field's bf16 gradient rows: plane ids walking the texels in
        # runs of 10 (C = 288, 160); line ids piling into 128 cells
        # (C = 112, 80)
        C = int(case.split("C=")[1])
        N = 20000
        if C in (288, 160):
            R = 4096
            idx = np.repeat(rng.integers(0, R, N // 10), 10)
        else:
            R = 128
            idx = np.sort(rng.integers(0, R, N))
        idx = idx.astype(np.int32)
        idx[:40] = R + 3
        return idx, rng.normal(size=(N, C)).astype(np.float32), R
    if case.startswith("long runs"):
        # sorted runs of 1-100 equal ids: they cross the 32-lane warps and
        # every run boundary of the kernel's threads (8 to 64 rows)
        C = int(case.split("C=")[1])
        N, R = 30000, 50000
        idx = sorted_runs(rng, N, R, 100)
        idx[-25:] = R
        return idx, rng.normal(size=(N, C)).astype(np.float32), R
    if case == "all out of range":
        N, C, R = 3000, 12, 700
        idx = rng.choice(np.array([-2 ** 31, -1, R, R + 5, 2 ** 31 - 1],
                                  np.int32), N)
        return idx, rng.normal(size=(N, C)).astype(np.float32), R
    if case.startswith("flagship"):
        # the flagship's narrow K3 launches: runs of 1-32 bounce rays a
        # parent sample (C = 9 segment sums, C = 44 parent gathers),
        # scattered SAT corners (C = 12), retrace rows (C = 6), a field
        # plane (C = 288)
        C = int(case.split("C=")[1])
        if C == 6:
            N, R = 1024, 65536
            idx = rng.choice(R, N, replace=False).astype(np.int32)
        elif C == 12:
            N, R = 40000, 90000
            idx = rng.integers(0, R, N).astype(np.int32)
        elif C == 288:
            N, R = 30000, 4096
            idx = np.repeat(rng.integers(0, R, N // 10), 10).astype(np.int32)
        else:
            N, R = 20000, 60000
            idx = sorted_runs(rng, N, R, 32)
        idx[:50] = R + 3
        return idx, rng.normal(size=(N, C)).astype(np.float32), R
    if case == "hash C=2":
        # the hash tables' gradient rows (8-byte rows, the kernel's
        # scalar-atomic branch): 4 levels of T = 4,096 rows, 8 corners of
        # 5,000 points a level; the coarse levels pile into 17 and 300
        # rows, the fine ones spread over the table
        T, n = 4096, 5000
        idx = np.concatenate([
            level * T + rng.integers(0, cells, 8 * n)
            for level, cells in enumerate((17, 300, T, T))]).astype(np.int32)
        idx[::97] = 4 * T + 1
        return idx, rng.normal(size=(idx.size, 2)).astype(np.float32), 4 * T
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
