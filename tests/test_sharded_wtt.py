"""Sharded windowed track-table BA vs the single-device wtt engine."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu3drecon.dataset.synthetic import (
    make_sequential_scene,
    perturb_scene,
    scene_to_ba_problem,
)
from tpu3drecon.parallel.mesh import make_mesh
from tpu3drecon.parallel.sharded_wtt import (
    ba_solve_wtt_sharded,
    shard_wtt_problem,
)
from tpu3drecon.problems.wtt import wtt_from_flat
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig, reprojection_rmse


@pytest.fixture(scope="module")
def problem_pair():
    scene = make_sequential_scene(
        n_cameras=24, points_per_camera=25, track_span=3, seed=15,
        dist=(-0.05, 0.008),
    )
    noisy = perturb_scene(scene, seed=16, point2d_noise=0.0)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    wtt = wtt_from_flat(flat, point_chunk=32, chunk_multiple=8)
    return flat, wtt


CONFIG = BAConfig(maxiter=12, gtol=1e-14, cg_maxiter=40, cg_rtol=1e-10)
# One-step trajectory equality (see tests/test_sharded_tt.py for why).
TRAJ_CONFIG = CONFIG._replace(maxiter=1)


class TestShardedWTT:
    @pytest.mark.parametrize("n_devices", [2, 8])
    def test_matches_single_device(self, problem_pair, n_devices):
        flat, wtt = problem_pair
        mesh = make_mesh(n_devices)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(wtt, TRAJ_CONFIG, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, TRAJ_CONFIG)
        assert int(st_s.accepted) == int(st_1.accepted)
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(cams_s.tvecs), np.asarray(cams_1.tvecs), rtol=0, atol=1e-6
        )
        # Full run: the sharded solve reaches the noiseless optimum basin
        # (line-trajectory scenes are gauge-weak and converge linearly;
        # single-device reaches rmse 2.1e-3 / loss 4.7e-9 at these same 25
        # iters — see test_ba_wtt.py).
        cams_f, pts_f, st_f = ba_solve_wtt_sharded(
            wtt, CONFIG._replace(maxiter=25, cg_rtol=1e-8), mesh=mesh
        )
        rmse = float(reprojection_rmse(flat, cams_f, pts_f))
        assert rmse < 5e-3
        assert float(st_f.loss) < 1e-8

    def test_split_deferred_sharded(self, problem_pair):
        """split_windows micro-chunked window classes + DEFERRED
        (wcam-only) packing, expanded and then sharded: every bucket class
        (a separate window width) must divide across the mesh and match
        the single-device solve of the same problem (psum ordering only)
        and, on loss, the dense unsplit solve.  Needs its own scene: the
        module fixture's 24 cameras fit one 128-row window (c_pad = 128),
        so nothing would split there."""
        from tpu3drecon.problems.wtt import expand_onehots

        scene = make_sequential_scene(
            n_cameras=160, points_per_camera=10, track_span=5, seed=25
        )
        noisy = perturb_scene(scene, seed=26, point2d_noise=0.0)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        deferred = wtt_from_flat(
            flat, point_chunk=32, chunk_multiple=8, split_windows=True,
            defer_onehot=True,
        )
        assert all(b.onehot is None for b in deferred.buckets)
        split = expand_onehots(deferred, onehot_dtype=jnp.float64)
        base = wtt_from_flat(flat, point_chunk=32, chunk_multiple=8)
        assert len(split.buckets) > len(base.buckets)  # classes really split
        mesh = make_mesh(2)
        cfg = TRAJ_CONFIG._replace(maxiter=2)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(split, cfg, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve_wtt(split, cfg)
        assert int(st_s.accepted) == int(st_1.accepted)
        # This 160-camera line scene is gauge-weak: psum ordering moves a
        # few points and cameras by up to ~5e-6 after two steps (measured
        # on the f64 CPU mesh), where the 24-camera fixture holds 1e-6.
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(cams_s.tvecs), np.asarray(cams_1.tvecs), rtol=0,
            atol=1e-5,
        )
        _, _, st_x = ba_solve_wtt(base, cfg)
        np.testing.assert_allclose(
            float(st_s.loss), float(st_x.loss), rtol=1e-6, atol=1e-18
        )

    def test_joint_distortion_sharded(self, problem_pair):
        flat, wtt = problem_pair
        mesh = make_mesh(4)
        config = TRAJ_CONFIG._replace(optimize_dist=True)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(wtt, config, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, config)
        assert int(st_s.accepted) == int(st_1.accepted)
        np.testing.assert_allclose(
            np.asarray(cams_s.dist), np.asarray(cams_1.dist), rtol=0, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-6
        )

    def test_joint_pp_sharded(self, problem_pair):
        """Principal-point refinement (VERDICT r3 #5) through the sharded
        engine: optimize_pp flows via the shared _ba_solve_wtt_core, so the
        sharded trajectory must match single-device."""
        flat, wtt = problem_pair
        mesh = make_mesh(4)
        config = TRAJ_CONFIG._replace(optimize_pp=True)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(wtt, config, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, config)
        assert int(st_s.accepted) == int(st_1.accepted)
        # cx/cy are pixel-scale (~640): rtol bounds at ~1e-6 px (see
        # test_ba_wtt.py::test_joint_pp_matches_tt for the ulp argument).
        np.testing.assert_allclose(
            np.asarray(cams_s.cx_cy_skew), np.asarray(cams_1.cx_cy_skew),
            rtol=1e-9, atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-6
        )

    def test_single_device_mesh_bit_exact(self, problem_pair):
        # 1-device mesh: psum is identity; SPMD path must be bit-exact.
        _, wtt = problem_pair
        config = CONFIG._replace(maxiter=3, optimize_dist=True)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(wtt, config, mesh=make_mesh(1))
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, config)
        assert np.array_equal(np.asarray(pts_s), np.asarray(pts_1))
        assert np.array_equal(np.asarray(cams_s.tvecs), np.asarray(cams_1.tvecs))
        assert np.array_equal(np.asarray(cams_s.dist), np.asarray(cams_1.dist))
        assert float(st_s.loss) == float(st_1.loss)

    def test_divisibility_guard(self, problem_pair):
        _, wtt = problem_pair
        with pytest.raises(ValueError, match="not divisible"):
            shard_wtt_problem(wtt, make_mesh(3), "shard")

    def test_onehot_shards_shrink(self, problem_pair):
        # The dominant O(W*slots) array must divide across the mesh: each
        # device's shard covers 1/D of the chunk axis.
        _, wtt = problem_pair
        mesh = make_mesh(8)
        buckets, pts, cams, avg_w = shard_wtt_problem(wtt, mesh, mesh.axis_names[0])
        for b_placed, b in zip(buckets, wtt.buckets):
            shard_shape = b_placed.onehot.sharding.shard_shape(
                b_placed.onehot.shape
            )
            assert shard_shape[0] * 8 == b.onehot.shape[0]
            assert b_placed.window == b.window


class TestShardedWTTBALRatio:
    """Suite-level scale evidence (round-2 verdict #7): a BAL-ratio scene
    (128 cams, camera-local tracks, groups > mesh size) through the sharded
    wtt engine with 3 LM iterations, equality-checked against the
    single-device engine at f64.  The FULL-scale (1712-cam) sharded run is
    the cpu8_wtt mode of experiments/balscale_dryrun.py (RESULTS.md)."""

    def test_bal_ratio_matches_single_device(self):
        scene = make_sequential_scene(
            n_cameras=128, points_per_camera=128, track_span=4, seed=7,
        )
        noisy = perturb_scene(scene, seed=8, point2d_noise=0.3)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        wtt = wtt_from_flat(flat, point_chunk=128, chunk_multiple=8)
        assert sum(b.uv.shape[0] for b in wtt.buckets) > 8  # groups > mesh
        cfg = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8,
                       cg_rtol=1e-10)
        cams_s, pts_s, st_s = ba_solve_wtt(wtt, cfg)
        cams_m, pts_m, st_m = ba_solve_wtt_sharded(wtt, cfg, mesh=make_mesh(8))
        assert int(st_m.accepted) == int(st_s.accepted) >= 1
        np.testing.assert_allclose(float(st_m.loss), float(st_s.loss),
                                   rtol=1e-8)
        np.testing.assert_allclose(np.array(cams_m.tvecs),
                                   np.array(cams_s.tvecs), atol=1e-7)
        np.testing.assert_allclose(np.array(pts_m), np.array(pts_s),
                                   atol=1e-7)


class TestShardedHubSplit:
    def test_hub_split_matches_single_device(self):
        # Hub/global camera tiles under shard_map: the global tiles are
        # identical on every device-local chunk shard; equality with the
        # single-device hub solve pins the whole hybrid layout.
        from tpu3drecon.dataset.synthetic import make_hub_scene

        # 512 cameras: the smallest c_pad where the split beats plain RCM
        # (global tiles amortize only once c_pad >> local window + 128).
        scene = make_hub_scene(
            n_cameras=512, points_per_camera=6, track_span=3,
            hub_fraction=0.05, hub_obs=400, seed=33,
        )
        noisy = perturb_scene(scene, seed=34, point2d_noise=0.2)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        wtt = wtt_from_flat(
            flat, point_chunk=32, chunk_multiple=4, reorder_cameras="hub"
        )
        assert any(b.global_tiles > 0 for b in wtt.buckets)
        mesh = make_mesh(4)
        config = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=20,
                          cg_rtol=1e-10)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(wtt, config, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, config)
        assert int(st_s.accepted) == int(st_1.accepted)
        np.testing.assert_allclose(
            float(st_s.loss), float(st_1.loss), rtol=1e-9, atol=0
        )
        np.testing.assert_allclose(
            np.asarray(cams_s.tvecs), np.asarray(cams_1.tvecs), rtol=0,
            atol=1e-7,
        )
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-7
        )
