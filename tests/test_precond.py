"""SCHUR_JACOBI preconditioner: exact-S-diagonal blocks vs brute-force dense S."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.solvers import schur
from tpu3drecon.solvers.bundle_adjust import BAConfig, _blocks_for, ba_solve


def _small_problem():
    scene = make_scene(n_cameras=5, n_points=80, seed=21)
    noisy = perturb_scene(scene, seed=22, point2d_noise=0.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return problem


def _dense_s(nb, cam_idx, pt_idx, C, P):
    """Brute-force dense S = U - W V^-1 W^T from the per-obs W blocks."""
    w = np.asarray(nb.w)
    vinv = np.asarray(nb.v_inv)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    # Assemble the (8C, 3P) coupling and eliminate.
    W = np.zeros((8 * C, 3 * P))
    for k in range(len(cam_idx)):
        c, p = cam_idx[k], pt_idx[k]
        W[8 * c : 8 * c + 8, 3 * p : 3 * p + 3] += w[k]
    Vinv = np.zeros((3 * P, 3 * P))
    for p in range(P):
        Vinv[3 * p : 3 * p + 3, 3 * p : 3 * p + 3] = vinv[p]
    U = np.zeros((8 * C, 8 * C))
    for c in range(C):
        U[8 * c : 8 * c + 8, 8 * c : 8 * c + 8] = np.asarray(nb.u)[c]
    return U - W @ Vinv @ W.T


def test_schur_jacobi_blocks_match_dense_s_diagonal():
    problem = _small_problem()
    config = BAConfig()
    cams = problem.cameras
    r, jc, jp = _blocks_for(
        cams.rmats, cams.tvecs, cams.fx_fy, cams.cx_cy_skew, cams.dist,
        problem.points3d, problem, config,
    )
    C, P = problem.n_cameras, problem.n_points
    lam = jnp.asarray(1e-3, jnp.float64)
    nb = schur.build_normal_blocks(
        r, jc, jp, problem.cam_idx, problem.pt_idx, C, P, lam,
        precond="schur_jacobi",
    )
    S = _dense_s(nb, problem.cam_idx, problem.pt_idx, C, P)
    # u_chol factors the preconditioner: reconstruct and compare to S's
    # diagonal blocks.
    for c in range(C):
        block = np.asarray(nb.u_chol[c]) @ np.asarray(nb.u_chol[c]).T
        np.testing.assert_allclose(
            block, S[8 * c : 8 * c + 8, 8 * c : 8 * c + 8], rtol=1e-9, atol=1e-9
        )


def test_schur_jacobi_solves():
    """schur_jacobi under a tight CG budget still converges (the relative
    merit vs jacobi_u is scene-dependent at small scale — decisively better
    on the 100-cam bench problem, see RESULTS.md — so only convergence is
    asserted here)."""
    problem = _small_problem()
    cfg = BAConfig(
        maxiter=15, gtol=0.0, ftol=0.0, cg_maxiter=4, cg_rtol=1e-10,
        precond="schur_jacobi",
    )
    _, _, st = ba_solve(problem, cfg)
    assert float(st.loss) < 1e-7
    assert int(st.accepted) >= 10


def test_precond_choice_same_optimum():
    """Both preconditioners must converge to the same optimum with a loose
    CG budget (the preconditioner changes the path, not the destination)."""
    problem = _small_problem()
    base = dict(maxiter=40, gtol=1e-14, cg_maxiter=60, cg_rtol=1e-10)
    _, pts_u, st_u = ba_solve(problem, BAConfig(precond="jacobi_u", **base))
    _, pts_s, st_s = ba_solve(problem, BAConfig(precond="schur_jacobi", **base))
    np.testing.assert_allclose(np.asarray(pts_u), np.asarray(pts_s), atol=1e-6)


class TestBreakdownGuards:
    """Schur-Jacobi indefiniteness + PCG NaN breakdown (round-4 BAL finding).

    At small LM damping a Schur-diagonal block can go indefinite: its
    cholesky is NaN, which poisons PCG from z0, and pcg's residual test
    (``dot(r,r) > tol2``) is false for NaN so CG exits after 1 iteration
    with a junk step — measured at BAL scale as cg_iters collapsing to 1
    and 2 rejected LM iterations per lambda drop (RESULTS.md)."""

    def test_guarded_cholesky_falls_back_per_block(self):
        from tpu3drecon.solvers.pcg import guarded_block_cholesky

        rng = np.random.default_rng(5)
        a = rng.normal(size=(3, 8, 8))
        u_d = jnp.asarray(a @ np.transpose(a, (0, 2, 1)) + 8 * np.eye(8))
        precond = np.asarray(u_d).copy()
        precond[1] -= 50.0 * np.eye(8)  # indefinite block
        chol = guarded_block_cholesky(jnp.asarray(precond), u_d)
        assert not np.isnan(np.asarray(chol)).any()
        # Healthy blocks keep the Schur factor bit-identically...
        expect = np.linalg.cholesky(precond[0])
        np.testing.assert_array_equal(np.asarray(chol[0]), expect)
        # ...the indefinite block uses the damped-U fallback.
        np.testing.assert_array_equal(
            np.asarray(chol[1]), np.linalg.cholesky(np.asarray(u_d[1]))
        )

    def test_pcg_nan_precond_returns_finite_zero_step(self):
        from tpu3drecon.solvers.pcg import pcg

        a = np.diag(np.arange(1.0, 9.0))
        out = pcg(
            lambda p: jnp.asarray(a) @ p,
            lambda r: r * jnp.nan,  # NaN preconditioner (broken cholesky)
            jnp.ones(8),
            maxiter=8,
            rtol=0.0,
        )
        x = np.asarray(out.x)
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, np.zeros(8))

    def test_pcg_mid_breakdown_keeps_last_finite_iterate(self):
        from tpu3drecon.solvers.pcg import pcg

        a = jnp.asarray(np.diag(np.arange(1.0, 9.0)))
        b = jnp.ones(8)
        # Clean residual-norm trajectory picks a threshold that fires the
        # poisoned preconditioner exactly after the 3rd iterate is formed.
        clean3 = pcg(lambda p: a @ p, lambda r: r, b, 3, 0.0)
        clean2 = pcg(lambda p: a @ p, lambda r: r, b, 2, 0.0)
        rr3 = float(jnp.sum(clean3.r ** 2))
        rr2 = float(jnp.sum(clean2.r ** 2))
        assert rr3 < rr2
        thresh = 0.5 * (rr2 + rr3)

        def precond_poison(r):
            return jnp.where(jnp.sum(r ** 2) < thresh, jnp.nan, 1.0) * r

        out = pcg(lambda p: a @ p, precond_poison, b, 8, 0.0)
        # Iteration 3 forms a finite x (the NaN enters via z AFTER the
        # iterate update); iteration 4 goes NaN and the loop exits — the
        # guard must return the last finite iterate, not the junk x.
        assert np.isfinite(np.asarray(out.x)).all()
        np.testing.assert_array_equal(np.asarray(out.x), np.asarray(clean3.x))
        assert int(out.iters) == 4

    def test_bundle_adjust_survives_nan_cg_regime(self):
        """End-to-end: schur_jacobi solve equals plain-jacobi optimum even
        when driven to tiny damping (init_lambda small) where the Schur
        blocks risk indefiniteness."""
        problem = _small_problem()
        config = BAConfig(
            maxiter=25, gtol=1e-14, cg_maxiter=60, cg_rtol=1e-12,
            init_lambda=1e-8, precond="schur_jacobi",
        )
        _, _, st = ba_solve(problem, config)
        assert np.isfinite(float(st.loss))
        assert float(st.loss) < 1e-8
