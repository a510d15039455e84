"""Full O(n^4) stem kernel: wavefront formulation vs direct recursion oracle."""

import numpy as np
import jax.numpy as jnp

from stem_kernel_tpu.io.alphabet import encode
from stem_kernel_tpu.models.full_stem import full_stem_kernel, pair_weights

from full_stem_oracle import full_stem_ref

rng = np.random.default_rng(17)

PAIRS = [
    ("gggaaaccc", "ggcaaagcc"),
    ("gcgcaaagcgc", "gggaaaccc"),
    ("acguacgu", "ugcaugca"),
]


def run_pair(a, b, gap=0.8, stack=1.0, subst=0.5, use_bpp=False):
    ca, cb = encode(a), encode(b)
    n = max(len(a), len(b)) + 1
    x = np.zeros((1, n), np.uint8)
    y = np.zeros((1, n), np.uint8)
    x[0, : len(ca)] = ca
    y[0, : len(cb)] = cb
    if use_bpp:
        from stem_kernel_tpu.fold.bpmatrix import fold_sequences

        bx_small = fold_sequences([a])[0]
        by_small = fold_sequences([b])[0]
        wx = pair_weights(ca, len(a), bpp=bx_small, bp_bound=0.01)
        wy = pair_weights(cb, len(b), bpp=by_small, bp_bound=0.01)
    else:
        wx = pair_weights(ca, len(a))
        wy = pair_weights(cb, len(b))
    bx = np.zeros((1, n, n))
    by = np.zeros((1, n, n))
    bx[0, : len(a), : len(a)] = wx
    by[0, : len(b), : len(b)] = wy
    got = float(
        np.asarray(
            full_stem_kernel(
                jnp.asarray(x), jnp.asarray(y),
                jnp.asarray([len(a)]), jnp.asarray([len(b)]),
                jnp.asarray(bx, jnp.float32), jnp.asarray(by, jnp.float32),
                gap, stack, subst,
            )
        )[0]
    )
    want = full_stem_ref(ca, cb, wx, wy, gap, stack, subst)
    return got, want


def test_matches_oracle_wobble_pairs():
    for a, b in PAIRS:
        got, want = run_pair(a, b)
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"{a} vs {b}")


def test_matches_oracle_bpp_weights():
    got, want = run_pair("gggaaaccc", "ggcaaagcc", use_bpp=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_symmetry():
    g1, _ = run_pair("gggaaaccc", "ggcaaagcc")
    g2, _ = run_pair("ggcaaagcc", "gggaaaccc")
    np.testing.assert_allclose(g1, g2, rtol=1e-4)


def test_batched_padding():
    a, b = "gggaaaccc", "ggcaaagcc"
    ca, cb = encode(a), encode(b)
    n = 14  # extra padding
    x = np.zeros((2, n), np.uint8)
    y = np.zeros((2, n), np.uint8)
    x[0, : len(ca)] = ca
    x[1, : len(cb)] = cb
    y[0, : len(cb)] = cb
    y[1, : len(ca)] = ca
    bx = np.zeros((2, n, n), np.float32)
    by = np.zeros((2, n, n), np.float32)
    bx[0, : len(a), : len(a)] = pair_weights(ca, len(a))
    bx[1, : len(b), : len(b)] = pair_weights(cb, len(b))
    by[0, : len(b), : len(b)] = pair_weights(cb, len(b))
    by[1, : len(a), : len(a)] = pair_weights(ca, len(a))
    vals = np.asarray(
        full_stem_kernel(
            jnp.asarray(x), jnp.asarray(y),
            jnp.asarray([len(a), len(b)]), jnp.asarray([len(b), len(a)]),
            jnp.asarray(bx), jnp.asarray(by), 0.8, 1.0, 0.5,
        )
    )
    want = full_stem_ref(ca, cb, pair_weights(ca, len(a)), pair_weights(cb, len(b)), 0.8, 1.0, 0.5)
    np.testing.assert_allclose(vals[0], want, rtol=1e-4)
    np.testing.assert_allclose(vals[1], want, rtol=1e-4)  # symmetric kernel


def test_band_restricts_and_wide_band_matches_full():
    a, b = "gggaaaccc", "ggcaaagcc"
    ca, cb = encode(a), encode(b)
    n = max(len(a), len(b)) + 1
    x = np.zeros((1, n), np.uint8); x[0, : len(ca)] = ca
    y = np.zeros((1, n), np.uint8); y[0, : len(cb)] = cb
    bx = np.zeros((1, n, n), np.float32); by = np.zeros((1, n, n), np.float32)
    bx[0, : len(a), : len(a)] = pair_weights(ca, len(a))
    by[0, : len(b), : len(b)] = pair_weights(cb, len(b))
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray([len(a)]), jnp.asarray([len(b)]),
            jnp.asarray(bx), jnp.asarray(by), 0.8, 1.0, 0.5)
    full = float(np.asarray(full_stem_kernel(*args))[0])
    wide = float(np.asarray(full_stem_kernel(*args, band=len(b)))[0])
    np.testing.assert_allclose(wide, full, rtol=1e-5)
    narrow = float(np.asarray(full_stem_kernel(*args, band=1))[0])
    assert narrow <= full + 1e-6


def test_posterior_windows_shapes_and_semantics():
    from stem_kernel_tpu.models.phmm import posterior_windows
    from stem_kernel_tpu.io.alphabet import encode

    x = encode("ggcgaaacgcc")
    y = encode("ggcgauaacgcc")
    n, m = len(x), len(y)
    xc = np.zeros((2, n), np.int32); xc[:] = x
    yc = np.zeros((2, m), np.int32); yc[:] = y
    lx = np.full(2, n, np.int32); ly = np.full(2, m, np.int32)
    lo, hi = posterior_windows(jnp.asarray(xc), jnp.asarray(lx),
                               jnp.asarray(yc), jnp.asarray(ly), 0.9, 2)
    lo, hi = np.asarray(lo), np.asarray(hi)
    assert lo.shape == (2, n + 1) and hi.shape == (2, n + 1)
    assert (lo <= hi).all() and lo.min() >= 0 and hi.max() <= m
    # similar sequences: windows are informative (narrower than full range)
    assert (hi - lo).mean() < m
    # an impossible bound -> no anchors -> full windows
    lo2, hi2 = posterior_windows(jnp.asarray(xc), jnp.asarray(lx),
                                 jnp.asarray(yc), jnp.asarray(ly), 2.0, 0)
    assert (np.asarray(lo2) == 0).all() and (np.asarray(hi2) == m).all()


def test_full_stem_with_full_windows_matches_unbanded():
    from stem_kernel_tpu.models.full_stem import full_stem_kernel
    from stem_kernel_tpu.io.alphabet import encode

    rng = np.random.default_rng(0)
    x = encode("".join(rng.choice(list("acgu"), 12)))
    y = encode("".join(rng.choice(list("acgu"), 10)))
    n, m = len(x), len(y)
    from stem_kernel_tpu.models.full_stem import pair_weights
    wx = pair_weights(x, n)
    wy = pair_weights(y, m)
    args = (jnp.asarray(x[None]), jnp.asarray(y[None]),
            jnp.asarray([n]), jnp.asarray([m]),
            jnp.asarray(wx[None]), jnp.asarray(wy[None]),
            0.6, 1.3, 0.8)
    v_free = np.asarray(full_stem_kernel(*args))
    win_lo = jnp.zeros((1, n + 1), jnp.int32)
    win_hi = jnp.full((1, n + 1), m, jnp.int32)
    v_win = np.asarray(full_stem_kernel(*args, win_lo=win_lo, win_hi=win_hi))
    np.testing.assert_allclose(v_win, v_free, rtol=1e-6)
    # a restrictive window must not increase the kernel value
    v_tight = np.asarray(full_stem_kernel(
        *args,
        win_lo=jnp.full((1, n + 1), 2, jnp.int32),
        win_hi=jnp.full((1, n + 1), 6, jnp.int32),
    ))
    assert (v_tight <= v_free + 1e-6).all()


def _pack_pair(a, b):
    ca, cb = encode(a), encode(b)
    n = max(len(a), len(b)) + 1
    x = np.zeros((1, n), np.uint8)
    y = np.zeros((1, n), np.uint8)
    x[0, : len(ca)] = ca
    y[0, : len(cb)] = cb
    bx = np.zeros((1, n, n))
    by = np.zeros((1, n, n))
    bx[0, : len(a), : len(a)] = pair_weights(ca, len(a))
    by[0, : len(b), : len(b)] = pair_weights(cb, len(b))
    return (jnp.asarray(x), jnp.asarray(y),
            jnp.asarray([len(a)]), jnp.asarray([len(b)]),
            jnp.asarray(bx, jnp.float32), jnp.asarray(by, jnp.float32),
            0.8, 1.0, 0.5)


def test_banded_matches_dense_banded_equal_lengths():
    """Windowed-memory kernel == dense banded kernel to fp accuracy when
    lx == ly (the window algebra is exact inside the band; clamp/decay
    edge fills reproduce the out-of-window closed forms)."""
    from stem_kernel_tpu.models.full_stem import full_stem_kernel_banded

    seqs = ["gggaaacccaugcaaggcauuca", "ggcaaagccgcaaagcggauacc"]
    args = _pack_pair(*seqs)
    for band in (4, 8):
        dense = float(np.asarray(full_stem_kernel(*args, band=band))[0])
        windowed = float(np.asarray(full_stem_kernel_banded(*args, band=band))[0])
        np.testing.assert_allclose(windowed, dense, rtol=2e-5)


def test_banded_wide_band_matches_unbanded():
    from stem_kernel_tpu.models.full_stem import full_stem_kernel_banded

    args = _pack_pair("gcgcaaagcgc", "gcgcaaagcgc")
    full = float(np.asarray(full_stem_kernel(*args))[0])
    wide = float(np.asarray(full_stem_kernel_banded(*args, band=14))[0])
    np.testing.assert_allclose(wide, full, rtol=2e-5)


def test_banded_unequal_lengths_match_scaled_dense_band():
    """Staircase-anchored windows handle ANY length combination (round-3's
    banded kernel returned 0 beyond |lx-ly| > band): values track the dense
    kernel's scaled-diagonal band (the reference's partial_dp anchors,
    stem_kernel.cpp:70-76), and the internal lx >= ly swap makes the result
    order-independent."""
    from stem_kernel_tpu.models.full_stem import full_stem_kernel, full_stem_kernel_banded

    a, b = "gggaaacccaugcaagg", "gggaaaccc"  # |lx-ly| = 8 > band
    args_fwd = _pack_pair(a, b)
    args_rev = _pack_pair(b, a)
    dense = float(np.asarray(full_stem_kernel(*args_fwd, band=4))[0])
    v_fwd = float(np.asarray(full_stem_kernel_banded(*args_fwd, band=4))[0])
    v_rev = float(np.asarray(full_stem_kernel_banded(*args_rev, band=4))[0])
    assert v_fwd > 0.0
    assert v_fwd == v_rev  # order-normalized (longer sequence first)
    np.testing.assert_allclose(v_fwd, dense, rtol=1e-4)


def test_banded_log_matches_f64_magnitude():
    """The scaled log engine stays finite and accurate where raw f32 would
    overflow (values grow ~10^(0.15 n); the reference uses C++ doubles)."""
    from stem_kernel_tpu.models.full_stem import full_stem_kernel_banded_log

    rng2 = np.random.default_rng(5)
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    N = 120
    stem = rng2.integers(0, 4, N // 3)
    rc = np.array([comp[int(c)] for c in stem[::-1]], np.uint8)
    mid = rng2.integers(0, 4, N - 2 * len(stem))
    c = np.concatenate([stem, mid, rc]).astype(np.uint8)
    bp = pair_weights(c, N)
    args = (jnp.asarray(c[None]), jnp.asarray(c[None]),
            jnp.asarray([N]), jnp.asarray([N]))
    lg32 = float(np.asarray(full_stem_kernel_banded_log(
        *args, jnp.asarray(bp[None], jnp.float32), jnp.asarray(bp[None], jnp.float32),
        0.8, 1.0, 0.5, band=8))[0])
    lg64 = float(np.asarray(full_stem_kernel_banded_log(
        *args, jnp.asarray(bp[None], jnp.float64), jnp.asarray(bp[None], jnp.float64),
        0.8, 1.0, 0.5, band=8))[0])
    assert lg32 > 20.0  # raw value ~e^40+: far beyond f32 without scaling
    np.testing.assert_allclose(lg32, lg64, atol=5e-5)


def test_phmm_anchor_staircase_properties():
    """MAP-alignment anchors conform to the banded kernel's staircase:
    monotone, deltas in {0,1}, a(0)=0, a(lx)=ly — for similar AND
    offset-indel pairs."""
    from stem_kernel_tpu.models.full_stem import phmm_anchor

    a1 = "gggcgcaagcuugaaagcgccc"
    b1 = "gggcgcaagcuugaaagcgccc"
    a2 = "gggcgcaagcuugaaagcgccc"
    b2 = "gggcgaagcuugaaagcccc"  # internal deletions
    n = max(len(a1), len(b2)) + 1
    x = np.zeros((2, n), np.uint8)
    y = np.zeros((2, n), np.uint8)
    for i, (sa, sb) in enumerate([(a1, b1), (a2, b2)]):
        x[i, : len(sa)] = encode(sa)
        y[i, : len(sb)] = encode(sb)
    lx = jnp.asarray([len(a1), len(a2)])
    ly = jnp.asarray([len(b1), len(b2)])
    a, dk = phmm_anchor(jnp.asarray(x), lx, jnp.asarray(y), ly, 0.5)
    a = np.asarray(a)
    dk = np.asarray(dk)
    assert (a[:, 0] == 0).all()
    for i in range(2):
        assert a[i, int(lx[i])] == int(ly[i])
    d = a[:, 1:] - a[:, :-1]
    assert ((d == 0) | (d == 1)).all()
    # the similar pair's anchor is near the identity staircase
    assert np.abs(a[0, : len(a1) + 1] - np.arange(len(a1) + 1)).max() <= 1


def test_banded_phmm_anchor_close_to_diagonal_for_similar_pairs():
    """For well-aligned equal-length pairs the MAP anchor coincides with the
    scaled diagonal, so the anchored banded value tracks both the plain
    banded value and the dense banded kernel."""
    from stem_kernel_tpu.models.full_stem import full_stem_kernel_banded_log

    args = _pack_pair("gggaaacccaugcaaggcauuca", "gggaaacccaugcaagguauuca")
    plain = np.asarray(full_stem_kernel_banded_log(*args, band=5))
    anch = np.asarray(full_stem_kernel_banded_log(*args, band=5, ali_bound=0.5))
    np.testing.assert_allclose(anch, plain, atol=1e-4)
    dense = np.asarray(full_stem_kernel(*args, band=5))
    np.testing.assert_allclose(np.exp(anch.astype(np.float64)), dense,
                               rtol=2e-4)

    # indel-offset pair: the anchored kernel runs finite and differs from
    # the scaled-diagonal anchor (windows follow the alignment)
    args2 = _pack_pair("gggaaacccaugcaaggcauuca", "gggaaacccgcaaggcauu")
    v_diag = float(np.asarray(full_stem_kernel_banded_log(*args2, band=3))[0])
    v_anch = float(np.asarray(full_stem_kernel_banded_log(
        *args2, band=3, ali_bound=0.3))[0])
    assert np.isfinite(v_anch) and np.isfinite(v_diag)


def test_banded_pad_mismatch_sides():
    """Predict-mode streams featurize test chunks at their OWN pad widths;
    the banded kernel must pad internally instead of asserting (round-4
    review finding)."""
    from stem_kernel_tpu.models.full_stem import full_stem_kernel_banded_log

    a, b = "gggaaacccaugcaaggcauuca", "gggaaaccc"
    ca, cb = encode(a), encode(b)
    # x padded wide, y padded narrow
    nx, ny = len(a) + 5, len(b) + 2
    x = np.zeros((1, nx), np.uint8); x[0, : len(ca)] = ca
    y = np.zeros((1, ny), np.uint8); y[0, : len(cb)] = cb
    bx = np.zeros((1, nx, nx), np.float32)
    by = np.zeros((1, ny, ny), np.float32)
    bx[0, : len(a), : len(a)] = pair_weights(ca, len(a))
    by[0, : len(b), : len(b)] = pair_weights(cb, len(b))
    args_mixed = (jnp.asarray(x), jnp.asarray(y),
                  jnp.asarray([len(a)]), jnp.asarray([len(b)]),
                  jnp.asarray(bx), jnp.asarray(by), 0.8, 1.0, 0.5)
    ref = np.asarray(full_stem_kernel_banded_log(*_pack_pair(a, b), band=4))
    got = np.asarray(full_stem_kernel_banded_log(*args_mixed, band=4))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # lx > ly: the windows' clamp-fill boundary approximation (documented in
    # full_stem_kernel_banded_log) bounds the gap to the dense band
    dense = np.asarray(full_stem_kernel(*_pack_pair(a, b), band=4))
    np.testing.assert_allclose(np.exp(got.astype(np.float64)), dense, rtol=1e-2)


def test_banded_fuzz_random_pairs():
    """Property fuzz over random sequences, lengths and bands: the banded
    scan engine is order-normalized (longer sequence first) everywhere and
    tracks the dense scaled-band kernel on lx >= ly pairs (where banded
    windows are exact)."""
    from stem_kernel_tpu.models.full_stem import (
        full_stem_kernel, full_stem_kernel_banded_log,
    )

    frng = np.random.default_rng(123)
    for trial in range(6):
        band = int(frng.integers(2, 7))
        la = int(frng.integers(8, 28))
        lb = int(frng.integers(8, 28))
        sa = "".join(frng.choice(list("acgu"), la))
        sb = "".join(frng.choice(list("acgu"), lb))
        args = _pack_pair(sa, sb)
        ref = np.asarray(full_stem_kernel_banded_log(*args, band=band))
        rev = np.asarray(full_stem_kernel_banded_log(*_pack_pair(sb, sa),
                                                     band=band))
        np.testing.assert_allclose(
            rev, ref, atol=5e-5,
            err_msg=f"trial {trial}: {sa} vs {sb} band={band}")
        if la >= lb:
            dense = np.asarray(full_stem_kernel(*args, band=band))
            # exact for equal lengths; clamp-fill boundary approximations
            # (documented in full_stem_kernel_banded_log) for la > lb
            rtol = 2e-4 if la == lb else 1e-2
            np.testing.assert_allclose(
                np.exp(ref.astype(np.float64)), dense, rtol=rtol,
                err_msg=f"trial {trial} dense: {sa} vs {sb} band={band}")
