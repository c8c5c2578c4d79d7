"""Port conformance: Pareto fronts and the hypervolume indicator.

Masks and the exact 2-objective hypervolume against the reference package's;
the quasi-Monte-Carlo hypervolume (3+ objectives) with the reference's unit
samples handed to the port; and the front and hypervolume properties of
tests/test_pareto.py as parametrized cases on seeded points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pareto as jpareto
import repro_torch.core.pareto as tpareto

CPU = "cpu"
SEEDS = range(8)


def _points(seed: int, n: int, m: int) -> np.ndarray:
    """Seeded cost points with an exact duplicate and a dominated row."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, size=(n, m)).astype(np.float32)
    if n >= 4:
        pts[n // 2] = pts[0]  # exact duplicate
        pts[-1] = pts[1] + 0.5  # strictly dominated by row 1
    return pts


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


# --------------------------------------------------------------------------- #
# against the reference package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,m", [(2, 2), (9, 2), (17, 3), (40, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_masks_match_reference(seed, n, m):
    pts = _points(seed, n, m)
    feas = np.random.default_rng(seed + 100).random(n) < 0.7
    for f in (None, feas):
        want = np.asarray(jpareto.non_dominated_mask(jnp.asarray(pts), None if f is None else jnp.asarray(f)))
        got = tpareto.non_dominated_mask(pts, f, device=CPU)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tpareto.pareto_front(pts, f, device=CPU), jpareto.pareto_front(pts, f))
    dom = tpareto.dominates(_t(pts)[:, None], _t(pts)[None, :]).numpy()
    np.testing.assert_array_equal(dom, np.asarray(jpareto.dominates(jnp.asarray(pts)[:, None], jnp.asarray(pts)[None])))


@pytest.mark.parametrize("n", [1, 2, 7, 30])
@pytest.mark.parametrize("seed", SEEDS)
def test_exact_2d_hypervolume_matches_reference(seed, n):
    pts = _points(seed, n, 2)
    pts[0, 0] = 5.0  # one point beyond ref on an axis (clipped)
    ref = pts.max(0) - 0.25
    want = float(jpareto.hypervolume(jnp.asarray(pts), jnp.asarray(ref)))
    got = float(tpareto.hypervolume(pts, ref, device=CPU))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [3, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_mc_hypervolume_with_reference_samples(seed, m):
    pts = _points(seed, 12, m)
    lo, ref = pts.min(0) - 0.1, pts.max(0) + 0.5
    key = jax.random.PRNGKey(seed)
    want = float(jpareto.hypervolume(jnp.asarray(pts), jnp.asarray(ref), lo=jnp.asarray(lo), key=key, n_samples=4096))
    u = np.asarray(jax.random.uniform(key, (4096, m)))  # the reference's unit draws, before the box map
    got = float(tpareto.hypervolume(pts, ref, lo=lo, samples=u, device=CPU))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # lo defaulted from the points, as the reference defaults it
    want = float(jpareto.hypervolume(jnp.asarray(pts), jnp.asarray(ref), key=key, n_samples=4096))
    np.testing.assert_allclose(float(tpareto.hypervolume(pts, ref, samples=u, device=CPU)), want, rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_hv_ref_point_matches_reference(seed):
    pts = _points(seed, 10, 3)
    pts[:, 2] = 1.5  # a degenerate axis
    np.testing.assert_allclose(tpareto.hv_ref_point(pts, device=CPU).numpy(), np.asarray(jpareto.hv_ref_point(pts)),
                               rtol=1e-6)


def test_samples_are_drawn_from_the_key_when_not_given():
    pts = _points(0, 12, 3)
    ref = pts.max(0) + 0.5
    a = float(tpareto.hypervolume(pts, ref, key=5, device=CPU))
    assert a == float(tpareto.hypervolume(pts, ref, samples=tpareto.unit_samples(16384, 3, 5), device=CPU))
    assert a != float(tpareto.hypervolume(pts, ref, key=6, device=CPU))
    with pytest.raises(ValueError, match="samples"):
        tpareto.hypervolume(pts, ref, samples=np.zeros((8, 2), np.float32), device=CPU)


# --------------------------------------------------------------------------- #
# tests/test_pareto.py's examples and properties
# --------------------------------------------------------------------------- #


class TestExamples:
    def test_domination(self):
        a, b = _t([1.0, 1.0]), _t([2.0, 1.0])
        assert bool(tpareto.dominates(a, b)) and not bool(tpareto.dominates(b, a))
        assert not bool(tpareto.dominates(a, a))

    def test_front_mask_known(self):
        pts = [[1.0, 3.0], [2.0, 1.0], [1.5, 2.5], [3.0, 3.0]]
        assert tpareto.non_dominated_mask(pts, device=CPU).tolist() == [True, True, True, False]
        np.testing.assert_array_equal(tpareto.pareto_front(pts, device=CPU), [0, 1, 2])

    def test_hypervolume_2d_staircase(self):
        assert float(tpareto.hypervolume([[1.0, 3.0], [2.0, 1.0]], [4.0, 4.0], device=CPU)) == pytest.approx(7.0)

    def test_hypervolume_2d_clip_beyond_ref(self):
        assert float(tpareto.hypervolume([[1.0, 3.0], [5.0, 0.0]], [4.0, 4.0], device=CPU)) == pytest.approx(3.0)

    def test_hypervolume_3d_single_point_box(self):
        got = tpareto.hypervolume([[0.0, 0.0, 0.0]], [1.0, 2.0, 3.0], lo=np.zeros(3), device=CPU)
        assert float(got) == pytest.approx(6.0, rel=0.05)

    def test_infeasible_neither_fronts_nor_shadows(self):
        mask = tpareto.non_dominated_mask([[0.0, 0.0], [1.0, 1.0]], [False, True], device=CPU)
        assert mask.tolist() == [False, True]

    def test_hv_ref_point_strictly_beyond(self):
        pts = _points(0, 12, 3)
        assert np.all(tpareto.hv_ref_point(pts, device=CPU).numpy() > pts.max(axis=0))

    def test_mc_agrees_with_exact_on_separable_3d(self):
        got = float(tpareto.hypervolume([[0.5, 1.0, 0.0]], [2.0, 2.0, 2.0], lo=np.zeros(3), n_samples=32768,
                                        device=CPU))
        assert got == pytest.approx(1.5 * 1.0 * 2.0, rel=0.05)


@pytest.mark.parametrize("n,m", [(2, 2), (5, 3), (16, 2), (40, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_front_properties(seed, n, m):
    """Mutually non-dominated; every dropped point dominated by a front
    member; exact duplicates share their fate."""
    pts = _points(seed, n, m)
    mask = tpareto.non_dominated_mask(pts, device=CPU).numpy()
    front, dropped = _t(pts[mask]), _t(pts[~mask])
    assert mask.any()
    assert not tpareto.dominates(front[:, None], front[None, :]).any()
    for p in dropped:
        assert tpareto.dominates(front, p[None]).any(), f"dropped point {p} not dominated by a front member"
    if n >= 4:
        assert mask[0] == mask[n // 2]


@pytest.mark.parametrize("n", [2, 8, 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_exact_2d_hypervolume_properties(seed, n):
    """Monotone under adding a point; invariant under adding a dominated one."""
    pts = _points(seed, n, 2)
    extra = np.random.default_rng(seed + 1).uniform(-3.0, 3.0, size=(1, 2)).astype(np.float32)
    ref = np.maximum(pts.max(0), extra.max(0)) + 0.5
    hv0 = float(tpareto.hypervolume(pts, ref, device=CPU))
    assert float(tpareto.hypervolume(np.concatenate([pts, extra]), ref, device=CPU)) >= hv0 - 1e-5
    dominated = (pts[0] + 0.25)[None]
    assert float(tpareto.hypervolume(np.concatenate([pts, dominated]), ref, device=CPU)) == pytest.approx(
        hv0, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("n,m", [(2, 3), (9, 3), (16, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_mc_hypervolume_properties(seed, n, m):
    """With shared samples and box, exactly monotone under adding a point;
    never above the box's volume."""
    pts = _points(seed, n, m)
    extra = np.random.default_rng(seed + 2).uniform(-3.0, 3.0, size=(1, m)).astype(np.float32)
    allp = np.concatenate([pts, extra])
    lo, ref = allp.min(0) - 0.1, allp.max(0) + 0.5
    u = tpareto.unit_samples(2048, m, seed)
    hv0 = float(tpareto.hypervolume(pts, ref, lo=lo, samples=u, device=CPU))
    assert float(tpareto.hypervolume(allp, ref, lo=lo, samples=u, device=CPU)) >= hv0
    assert 0.0 <= hv0 <= float(np.prod(ref - lo)) + 1e-5
