"""BPLA kernel: batched implementation vs brute-force oracles + AD gradients."""

import jax.numpy as jnp
import numpy as np
import pytest

from stem_kernel_tpu.models.bpla import (
    BPLAKernel,
    DEFAULT_BPLA_SCORE_TABLE,
    bpla_kernel_batch,
    bpla_profiles,
    bpla_score_parts,
    la_score_matrix,
    local_alignment_exp,
    local_alignment_exp_flank,
    local_alignment_max,
    pair_mask,
)

from reference_dp import bpla_exp_ref, bpla_forward_ref, bpla_max_ref

rng = np.random.default_rng(1)


def rand_scores(b, n, m, lo=-3.0, hi=4.0):
    return rng.uniform(lo, hi, size=(b, n, m)).astype(np.float32)


def test_exp_matches_bruteforce():
    beta, gap, ext = 0.11, -8.0, -0.75
    S = rand_scores(3, 9, 7)
    mask = np.ones((3, 9, 7), bool)
    got = np.asarray(local_alignment_exp(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    want = np.array([bpla_exp_ref(S[b].astype(np.float64), beta, gap, ext) for b in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_flank_matches_seven_state_forward():
    # the optimizer's kernel: 7-state forward with flanking states
    beta, gap, ext = 0.2, -4.0, -0.5
    S = rand_scores(2, 8, 6)
    mask = np.ones((2, 8, 6), bool)
    got = np.asarray(local_alignment_exp_flank(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    want = np.array([bpla_forward_ref(S[b].astype(np.float64), beta, gap, ext)[0] for b in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_flank_padding_invariance():
    beta, gap, ext = 0.11, -8.0, -0.75
    S = rand_scores(1, 6, 5)
    big = np.zeros((1, 10, 9), np.float32)
    big[:, :6, :5] = S
    mask = np.zeros((1, 10, 9), bool)
    mask[:, :6, :5] = True
    got = np.asarray(local_alignment_exp_flank(jnp.asarray(big), jnp.asarray(mask), beta, gap, ext))[0]
    want = bpla_forward_ref(S[0].astype(np.float64), beta, gap, ext)[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_exp_padding_invariance():
    beta, gap, ext = 0.11, -8.0, -0.75
    S = rand_scores(1, 6, 5)
    big = np.zeros((1, 9, 9), np.float32)
    big[:, :6, :5] = S
    mask = np.zeros((1, 9, 9), bool)
    mask[:, :6, :5] = True
    got = np.asarray(local_alignment_exp(jnp.asarray(big), jnp.asarray(mask), beta, gap, ext))[0]
    want = bpla_exp_ref(S[0].astype(np.float64), beta, gap, ext)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_max_matches_bruteforce():
    gap, ext = -8.0, -0.75
    S = rand_scores(3, 10, 8)
    mask = np.ones((3, 10, 8), bool)
    got = np.asarray(local_alignment_max(jnp.asarray(S), jnp.asarray(mask), gap, ext))
    want = np.array([bpla_max_ref(S[b].astype(np.float64), gap, ext) for b in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_max_padding_invariance():
    gap, ext = -8.0, -0.75
    S = rand_scores(1, 5, 7)
    big = rng.uniform(5.0, 9.0, size=(1, 9, 9)).astype(np.float32)  # junk outside
    big[:, :5, :7] = S
    mask = np.zeros((1, 9, 9), bool)
    mask[:, :5, :7] = True
    got = np.asarray(local_alignment_max(jnp.asarray(big), jnp.asarray(mask), gap, ext))[0]
    want = bpla_max_ref(S[0].astype(np.float64), gap, ext)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gradients_match_finite_differences():
    b, n, m = 2, 6, 5
    w_pair = rng.uniform(0.0, 1.0, size=(b, n, m)).astype(np.float32)
    w_unpair = rng.uniform(-2.0, 2.0, size=(b, n, m)).astype(np.float32)
    mask = np.ones((b, n, m), bool)
    params = np.array([4.5, 0.11, -8.0, -0.75], np.float32)

    vals, grads = bpla_kernel_batch(
        jnp.asarray(w_pair), jnp.asarray(w_unpair), jnp.asarray(mask),
        jnp.asarray(params), with_grads=True,
    )
    vals, grads = np.asarray(vals), np.asarray(grads)

    def value_np(p, bi):
        S = p[0] * w_pair[bi].astype(np.float64) + w_unpair[bi]
        return bpla_forward_ref(S, p[1], p[2], p[3])[0]

    eps = 1e-4
    for bi in range(b):
        np.testing.assert_allclose(vals[bi], value_np(params.astype(np.float64), bi), rtol=1e-4)
        for k in range(4):
            pp = params.astype(np.float64).copy()
            pm = pp.copy()
            pp[k] += eps
            pm[k] -= eps
            fd = (value_np(pp, bi) - value_np(pm, bi)) / (2 * eps)
            np.testing.assert_allclose(grads[bi, k], fd, rtol=2e-2, atol=1e-5)


def test_bpla_profiles():
    bpp = np.zeros((4, 4))
    bpp[0, 3] = 0.9
    bpp[1, 2] = 0.4
    pl, pr, pu = bpla_profiles(bpp)
    np.testing.assert_allclose(pl, np.sqrt([0.9, 0.4, 0.0, 0.0]), rtol=1e-6)
    np.testing.assert_allclose(pr, np.sqrt([0.0, 0.0, 0.4, 0.9]), rtol=1e-6)
    np.testing.assert_allclose(pu**2, [0.1, 0.6, 0.6, 0.1], atol=1e-6)


def test_la_score_empty_column_is_zero():
    px = np.zeros((1, 3, 4), np.float32)
    px[0, 0, 0] = 1.0  # only position 0 non-empty
    py = np.ones((1, 2, 4), np.float32) * 0.25
    S = np.asarray(la_score_matrix(jnp.asarray(px), jnp.asarray(py), jnp.asarray(DEFAULT_BPLA_SCORE_TABLE)))
    assert S[0, 1, 0] == 0.0 and S[0, 2, 1] == 0.0
    assert S[0, 0, 0] != 0.0


def test_kernel_symmetry_full_pipeline():
    n, m = 11, 9
    bpp_x = np.triu(rng.uniform(0, 0.2, (n, n)), 1)
    bpp_y = np.triu(rng.uniform(0, 0.2, (m, m)), 1)
    L = 12

    def pack(seq_prof, bpp, ln):
        pl, pr, pu = bpla_profiles(bpp)
        d = {
            "profile": np.zeros((1, L, 4), np.float32),
            "p_left": np.zeros((1, L), np.float32),
            "p_right": np.zeros((1, L), np.float32),
            "p_unpair": np.zeros((1, L), np.float32),
            "length": np.array([ln]),
        }
        d["profile"][0, :ln] = seq_prof
        d["p_left"][0, :ln] = pl
        d["p_right"][0, :ln] = pr
        d["p_unpair"][0, :ln] = pu
        return {k: jnp.asarray(v) for k, v in d.items()}

    prof_x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    prof_y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, m)]
    x = pack(prof_x, bpp_x, n)
    y = pack(prof_y, bpp_y, m)
    k = BPLAKernel()
    kxy = float(np.asarray(k(x, y))[0])
    kyx = float(np.asarray(k(y, x))[0])
    np.testing.assert_allclose(kxy, kyx, rtol=1e-5)
    assert kxy > 0


def test_log_space_matches_exp_space():
    beta, gap, ext = 0.11, -8.0, -0.75
    S = rand_scores(3, 10, 8, lo=-2.0, hi=2.0)
    mask = np.ones((3, 10, 8), bool)
    v = np.asarray(local_alignment_exp(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    from stem_kernel_tpu.models.bpla import local_alignment_log

    lv = np.asarray(local_alignment_log(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    np.testing.assert_allclose(np.exp(lv), v, rtol=1e-4)


def test_log_space_survives_long_sequences():
    from stem_kernel_tpu.models.bpla import local_alignment_log

    beta, gap, ext = 0.11, -8.0, -0.75
    # strongly matching long pair: exp-space overflows f32, log-space is finite
    S = np.full((1, 160, 160), 15.0, np.float32)
    mask = np.ones((1, 160, 160), bool)
    v = np.asarray(local_alignment_exp(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    assert not np.isfinite(v).all()  # demonstrates the overflow
    lv = np.asarray(local_alignment_log(jnp.asarray(S), jnp.asarray(mask), beta, gap, ext))
    assert np.isfinite(lv).all() and lv[0] > 80.0


def test_log_space_padding_invariance():
    from stem_kernel_tpu.models.bpla import local_alignment_log

    beta, gap, ext = 0.11, -8.0, -0.75
    S = rand_scores(1, 6, 5)
    big = np.zeros((1, 9, 9), np.float32)
    big[:, :6, :5] = S
    mask = np.zeros((1, 9, 9), bool)
    mask[:, :6, :5] = True
    got = np.asarray(local_alignment_log(jnp.asarray(big), jnp.asarray(mask), beta, gap, ext))[0]
    want = np.log(bpla_exp_ref(S[0].astype(np.float64), beta, gap, ext))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def rand_factors(b, lx, ly, k=6, scale=0.6, seed=7):
    r = np.random.default_rng(seed)
    fx = r.normal(size=(b, lx, k)).astype(np.float32) * scale
    fy = r.normal(size=(b, ly, k)).astype(np.float32) * scale
    return jnp.asarray(fx), jnp.asarray(fy)


def factor_scores(fx, fy, alpha):
    """The materialized score tensor the factors stand for."""
    wp = jnp.einsum("bik,bjk->bij", fx[..., :2], fy[..., :2])
    wu = jnp.einsum("bik,bjk->bij", fx[..., 2:], fy[..., 2:])
    return alpha * wp + wu


def triton_vs_scan(fx, fy, lx, ly, log, alpha=4.5, beta=0.11, gap=-8.0,
                   ext=-0.75):
    """(Triton kernel under the interpreter, plain scan) on the same pairs."""
    from stem_kernel_tpu.models.bpla import local_alignment_log
    from stem_kernel_tpu.ops.la_triton import la_factored_triton

    lx, ly = jnp.asarray(lx, jnp.int32), jnp.asarray(ly, jnp.int32)
    got = la_factored_triton(fx, fy, lx, ly, alpha, beta, gap, ext, log=log,
                             interpret=True)
    mask = pair_mask(lx, fx.shape[1], ly, fy.shape[1])
    la = local_alignment_log if log else local_alignment_exp
    want = la(factor_scores(fx, fy, alpha), mask, beta, gap, ext)
    return np.asarray(got), np.asarray(want)


def test_pallas_la_interpret_matches_scan():
    fx, fy = rand_factors(5, 9, 7)
    got, want = triton_vs_scan(fx, fy, [9, 6, 3, 9, 1], [7, 7, 2, 5, 1],
                               log=False)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pallas_la_log_interpret_matches_scan():
    fx, fy = rand_factors(5, 9, 7, scale=0.9)
    got, want = triton_vs_scan(fx, fy, [9, 6, 3, 9, 1], [7, 7, 2, 5, 1],
                               log=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pallas_la_log_long_sequences_finite():
    # exp space overflows f32 at this length; the log-space kernel must stay
    # finite: a rank-3 factorization of the constant score 15
    fx = jnp.zeros((2, 160, 3), jnp.float32).at[..., 2].set(15.0)
    fy = jnp.zeros((2, 160, 3), jnp.float32).at[..., 2].set(1.0)
    got, want = triton_vs_scan(fx, fy, [160, 120], [160, 160], log=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pallas_factored_matches_materialized():
    # the factored kernel equals the scans on the score tensor rebuilt from
    # the same factors (the low-rank identity is exact)
    fx, fy = rand_factors(5, 21, 17, scale=0.4)
    lx, ly = [21, 13, 3, 21, 1], [17, 17, 2, 9, 1]
    got, want = triton_vs_scan(fx, fy, lx, ly, log=False)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    got_l, want_l = triton_vs_scan(fx, fy, lx, ly, log=True)
    np.testing.assert_allclose(got_l, want_l, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize(
    "b, lx_max, ly_max, lx, ly",
    [
        # Lx != Ly, neither a multiple of the 32-column chunk
        (3, 37, 45, [37, 20, 5], [45, 33, 44]),
        # batch not a multiple of the 16-pair block, odd lengths
        (19, 11, 13, list(range(1, 12)) + [11] * 8,
         list(range(13, 2, -1)) + [7] * 8),
        # zero-length pairs: K = 1 (log K = 0) exactly
        (4, 8, 6, [0, 8, 0, 5], [6, 0, 0, 6]),
    ],
    ids=["lx_ne_ly", "ragged_batch", "zero_length"],
)
def test_triton_wrapper_padding_and_masking(b, lx_max, ly_max, lx, ly):
    fx, fy = rand_factors(b, lx_max, ly_max, scale=0.5, seed=b)
    got, want = triton_vs_scan(fx, fy, lx, ly, log=False)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    got_l, want_l = triton_vs_scan(fx, fy, lx, ly, log=True)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-5)
    empty = (np.asarray(lx) == 0) | (np.asarray(ly) == 0)
    np.testing.assert_array_equal(got[empty], 1.0)
    np.testing.assert_array_equal(got_l[empty], 0.0)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("log", [False, True], ids=["exp", "log"])
def test_dispatch_choice(monkeypatch, platform, log):
    """BPLAKernel sends a GPU call to the Triton kernel and a CPU call to
    the plain scan, in both exp and log space."""
    import jax

    import stem_kernel_tpu.models.bpla as bpla
    import stem_kernel_tpu.ops.la_triton as la_triton

    calls = []

    def record(name):
        def fn(*args, **kw):
            calls.append((name, kw.get("log")))
            return jnp.zeros(args[0].shape[0])
        return fn

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(la_triton, "la_factored_triton", record("triton"))
    monkeypatch.setattr(bpla, "local_alignment_exp", record("scan_exp"))
    monkeypatch.setattr(bpla, "local_alignment_log", record("scan_log"))
    r = np.random.default_rng(0)
    d = {"profile": jnp.asarray(r.dirichlet(np.ones(4), (2, 10)), jnp.float32),
         "p_left": jnp.full((2, 10), 0.3), "p_right": jnp.full((2, 10), 0.3),
         "p_unpair": jnp.full((2, 10), 0.9), "length": jnp.asarray([10, 7])}
    kern = BPLAKernel()
    (kern.log_value if log else kern)(d, d)
    if platform == "gpu":
        assert calls == [("triton", log)]
    else:
        assert calls == [("scan_log" if log else "scan_exp", None)]


@pytest.mark.parametrize("platform, max_ly, impl", [
    ("gpu", 512, "triton"),
    ("gpu", 513, "scan"),  # the kernel cannot hold the row: explicit rule
    ("cpu", 64, "scan"),
])
def test_la_impl_shape_rule(platform, max_ly, impl):
    from stem_kernel_tpu.models.bpla import la_impl

    assert la_impl(platform, max_ly) == impl


def test_bpla_factors_reproduce_score_parts():
    from stem_kernel_tpu.models.bpla import bpla_factors, bpla_score_parts

    rng = np.random.default_rng(3)
    B, Lx, Ly, N = 3, 11, 9, 4
    S = jnp.asarray(rng.normal(size=(N, N)).astype(np.float32))
    px = jnp.asarray(rng.uniform(size=(B, Lx, N)).astype(np.float32))
    py = jnp.asarray(rng.uniform(size=(B, Ly, N)).astype(np.float32))
    # zero out one column entirely (the LAScore den==0 fallback)
    px = px.at[0, 4].set(0.0)
    plx, prx, pux = (jnp.asarray(rng.uniform(size=(B, Lx)).astype(np.float32))
                     for _ in range(3))
    ply, pry, puy = (jnp.asarray(rng.uniform(size=(B, Ly)).astype(np.float32))
                     for _ in range(3))

    wp, wu = bpla_score_parts(px, plx, prx, pux, py, ply, pry, puy, S)
    fx = bpla_factors(px, plx, prx, pux, S, side="x")
    fy = bpla_factors(py, ply, pry, puy, S, side="y")
    wp2 = jnp.einsum("bik,bjk->bij", fx[..., :2], fy[..., :2])
    wu2 = jnp.einsum("bik,bjk->bij", fx[..., 2:], fy[..., 2:])
    np.testing.assert_allclose(np.asarray(wp2), np.asarray(wp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wu2), np.asarray(wu), rtol=1e-4, atol=1e-5)
