"""Camera reordering (problems/reorder.py) + wtt locality robustness.

Round-2 verdict item: a shuffled/unstructured camera labeling must not
silently degenerate the windowed track table — RCM relabeling at pack time
recovers the windows, and with reordering disabled the size guard must
fail LOUDLY rather than build camera-wide windows.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu3drecon.dataset.synthetic import (
    make_sequential_scene,
    scene_to_ba_problem,
)
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.problems.reorder import (
    permute_cameras_flat,
    plan_camera_order,
    rcm_camera_order,
    track_span_cost,
)
from tpu3drecon.problems.wtt import CAM_TILE, unpermute_cameras, wtt_from_flat
from tpu3drecon.problems.tt import tt_from_flat
from tpu3drecon.solvers.ba_tt import ba_solve_tt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig, reprojection_rmse


@pytest.fixture(scope="module")
def seq_flat():
    scene = make_sequential_scene(
        n_cameras=400, points_per_camera=8, track_span=4, seed=9
    )
    flat, _ = scene_to_ba_problem(scene, observed=scene, dtype=jnp.float64)
    return flat


@pytest.fixture(scope="module")
def shuffled_flat(seq_flat):
    rng = np.random.default_rng(31)
    perm = rng.permutation(seq_flat.n_cameras)
    return permute_cameras_flat(seq_flat, perm), perm


def _dominant(wtt):
    return max(wtt.buckets, key=lambda b: b.mask.size)


class TestPlanning:
    def test_sequential_needs_no_reorder(self, seq_flat):
        perm, stats = plan_camera_order(
            np.array(seq_flat.cam_idx), np.array(seq_flat.pt_idx),
            np.array(seq_flat.mask), seq_flat.n_cameras, seq_flat.n_points,
        )
        # RCM cannot beat an already-minimal chain ordering by >5%.
        assert perm is None
        assert stats["span_after"] >= stats["span_before"] * 0.8

    def test_shuffle_detected_and_recovered(self, seq_flat, shuffled_flat):
        shuf, _ = shuffled_flat
        ci, pi = np.array(shuf.cam_idx), np.array(shuf.pt_idx)
        mk = np.array(shuf.mask)
        perm, stats = plan_camera_order(
            ci, pi, mk, shuf.n_cameras, shuf.n_points
        )
        assert perm is not None
        # Shuffled spans are ~C/3 on average; RCM must get back to ~track_span.
        assert stats["span_after"] < stats["span_before"] / 10
        base_cost = track_span_cost(ci[mk > 0], pi[mk > 0], shuf.n_points)
        assert stats["span_before"] == pytest.approx(base_cost)

    def test_rcm_perm_is_permutation(self, shuffled_flat):
        shuf, _ = shuffled_flat
        mk = np.array(shuf.mask) > 0
        perm = rcm_camera_order(
            np.array(shuf.cam_idx)[mk], np.array(shuf.pt_idx)[mk],
            shuf.n_cameras, shuf.n_points,
        )
        assert sorted(perm) == list(range(shuf.n_cameras))


class TestWTTReorder:
    def test_windows_recovered(self, seq_flat, shuffled_flat):
        shuf, _ = shuffled_flat
        w_seq = wtt_from_flat(seq_flat, point_chunk=128)
        w_shuf = wtt_from_flat(shuf, point_chunk=128)  # auto reorder
        assert w_shuf.cam_rows is not None
        # The dominant bucket's window must be as narrow as the sequential
        # packing's (RCM recovers the chain up to reflection/breaks).
        assert _dominant(w_shuf).window <= 2 * _dominant(w_seq).window
        assert _dominant(w_shuf).window <= 2 * CAM_TILE
        assert _dominant(w_shuf).window < w_shuf.c_pad

    def test_loud_guard_without_reorder(self, shuffled_flat):
        # Degenerate windows + a budget must raise, not silently crawl.
        shuf, _ = shuffled_flat
        probe = wtt_from_flat(shuf, point_chunk=128, reorder_cameras="never")
        degenerate_bytes = sum(
            b.onehot.size * b.onehot.dtype.itemsize for b in probe.buckets
        )
        healthy = wtt_from_flat(shuf, point_chunk=128)
        healthy_bytes = sum(
            b.onehot.size * b.onehot.dtype.itemsize for b in healthy.buckets
        )
        assert degenerate_bytes > 1.5 * healthy_bytes
        with pytest.raises(ValueError, match="camera locality"):
            wtt_from_flat(
                shuf, point_chunk=128, reorder_cameras="never",
                max_onehot_bytes=degenerate_bytes - 1,
            )

    def test_solve_matches_tt_on_shuffled(self, shuffled_flat):
        shuf, _ = shuffled_flat
        config = BAConfig(
            maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10
        )
        tt = tt_from_flat(shuf, point_block=64)
        cams_t, pts_t, st_t = ba_solve_tt(tt, config)
        wtt = wtt_from_flat(shuf, point_chunk=64)
        assert wtt.cam_rows is not None
        cams_w, pts_w, st_w = ba_solve_wtt(wtt, config)
        # Identical trust-region trajectory and un-permuted camera output.
        assert int(st_w.accepted) == int(st_t.accepted)
        np.testing.assert_allclose(
            float(st_w.loss), float(st_t.loss), rtol=1e-6, atol=1e-18
        )
        np.testing.assert_allclose(
            np.array(cams_w.tvecs), np.array(cams_t.tvecs), atol=1e-6
        )
        np.testing.assert_allclose(np.array(pts_w), np.array(pts_t), atol=1e-6)
        rmse = float(reprojection_rmse(shuf, cams_w, pts_w))
        assert rmse < 2e-3

    def test_unpermute_cameras_roundtrip(self):
        rng = np.random.default_rng(7)
        n = 12
        cams = CameraParams(
            rmats=jnp.asarray(rng.normal(size=(n, 3, 3))),
            tvecs=jnp.asarray(rng.normal(size=(n, 3))),
            fx_fy=jnp.asarray(rng.normal(size=(n, 2))),
            cx_cy_skew=jnp.asarray(rng.normal(size=(n, 3))),
            dist=jnp.asarray(rng.normal(size=(n, 2))),
        )
        perm = rng.permutation(n)
        permuted = CameraParams(
            rmats=cams.rmats[perm], tvecs=cams.tvecs[perm],
            fx_fy=cams.fx_fy[perm], cx_cy_skew=cams.cx_cy_skew[perm],
            dist=cams.dist[perm],
        )
        back = unpermute_cameras(permuted, jnp.asarray(perm))
        np.testing.assert_array_equal(np.array(back.rmats), np.array(cams.rmats))
        np.testing.assert_array_equal(np.array(back.dist), np.array(cams.dist))
        assert unpermute_cameras(permuted, None) is permuted


@pytest.fixture(scope="module")
def hub_flat():
    """Core-periphery scene: 640 cams, 32 interleaved hub cameras that each
    observe points across the whole trajectory (round-4 verdict item: the
    dislocal structure RCM alone cannot fix)."""
    from tpu3drecon.dataset.synthetic import make_hub_scene, perturb_scene

    scene = make_hub_scene(
        n_cameras=640, points_per_camera=10, track_span=4,
        hub_fraction=0.05, hub_obs=1000, seed=21,
    )
    noisy = perturb_scene(scene, seed=22, point2d_noise=0.3)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return flat


class TestHubSplit:
    def test_planner_separates_hubs(self, hub_flat):
        from tpu3drecon.problems.reorder import plan_hub_camera_order

        perm, n_local, stats = plan_hub_camera_order(
            np.array(hub_flat.cam_idx), np.array(hub_flat.pt_idx),
            np.array(hub_flat.mask), hub_flat.n_cameras, hub_flat.n_points,
        )
        frac0 = next(c for c in stats["candidates"] if c["frac"] == 0.0)
        # Plain RCM stays degenerate (hub rows touch every community)...
        assert frac0["w_local"] >= 512
        # ...while the split captures the hubs and collapses the windows.
        assert stats["n_global"] >= 32
        assert stats["score"] <= 0.7 * frac0["score"]
        assert n_local == hub_flat.n_cameras - stats["n_global"]
        assert sorted(perm.tolist()) == list(range(hub_flat.n_cameras))

    def test_auto_packs_hub_split_under_budget(self, hub_flat):
        # Without the split the windows degenerate toward c_pad; with the
        # round-3 code this budget raised ValueError and the CLI fell back
        # to the 5x-slower grid engine.  Auto mode must now pack the
        # hub/global layout inside the budget instead.
        degenerate = wtt_from_flat(
            hub_flat, point_chunk=128, reorder_cameras="never"
        )
        degenerate_bytes = sum(
            b.onehot.size * b.onehot.dtype.itemsize for b in degenerate.buckets
        )
        packed = wtt_from_flat(
            hub_flat, point_chunk=128,
            max_onehot_bytes=int(0.8 * degenerate_bytes),
        )
        assert any(b.global_tiles > 0 for b in packed.buckets)
        packed_bytes = sum(
            b.onehot.size * b.onehot.dtype.itemsize for b in packed.buckets
        )
        assert packed_bytes <= 0.8 * degenerate_bytes
        # Dominant (long-track) buckets keep narrow local windows.
        dom = _dominant(packed)
        assert dom.window - CAM_TILE * dom.global_tiles <= 512

    def test_solve_matches_tt(self, hub_flat):
        config = BAConfig(
            maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10
        )
        tt = tt_from_flat(hub_flat, point_block=64)
        cams_t, pts_t, st_t = ba_solve_tt(tt, config)
        wtt = wtt_from_flat(hub_flat, point_chunk=64, reorder_cameras="hub")
        assert any(b.global_tiles > 0 for b in wtt.buckets)
        cams_w, pts_w, st_w = ba_solve_wtt(wtt, config)
        assert int(st_w.accepted) == int(st_t.accepted)
        np.testing.assert_allclose(
            float(st_w.loss), float(st_t.loss), rtol=1e-6, atol=1e-18
        )
        np.testing.assert_allclose(
            np.array(cams_w.tvecs), np.array(cams_t.tvecs), atol=1e-6
        )
        np.testing.assert_allclose(np.array(pts_w), np.array(pts_t), atol=1e-6)

    def test_split_windows_matches_on_hub(self, hub_flat):
        """split_windows under a hub split: points are re-sorted by
        (has_global, min_local_cam) so hub-free chunks drop the shared
        global tiles entirely, and window classes narrow per chunk —
        values must match the unsplit hub packing."""
        base = wtt_from_flat(hub_flat, point_chunk=64, reorder_cameras="hub")
        split = wtt_from_flat(
            hub_flat, point_chunk=64, reorder_cameras="hub",
            split_windows=True,
        )
        assert any(b.global_tiles > 0 for b in base.buckets)

        def macs(p):
            return sum(
                b.window * b.uv.shape[0] * b.uv.shape[2] * b.uv.shape[3]
                for b in p.buckets
            )

        assert macs(split) < macs(base)
        config = BAConfig(
            maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-10
        )
        _, _, st_b = ba_solve_wtt(base, config)
        _, _, st_s = ba_solve_wtt(split, config)
        assert int(st_s.accepted) == int(st_b.accepted)
        np.testing.assert_allclose(
            float(st_s.loss), float(st_b.loss), rtol=1e-9, atol=1e-18
        )

    def test_split_class_cap_on_hub(self, hub_flat):
        """A small int cap coalesces hub window classes — global and
        local-only classes merge under covering keys (max window, OR of
        the needs-global flag; non-global chunks ride a global class
        with all-zero selection rows) — with the same solution as the
        uncapped split."""
        uncapped = wtt_from_flat(
            hub_flat, point_chunk=64, reorder_cameras="hub",
            split_windows=999,
        )
        capped = wtt_from_flat(
            hub_flat, point_chunk=64, reorder_cameras="hub",
            split_windows=2,
        )
        assert len(capped.buckets) < len(uncapped.buckets)
        config = BAConfig(
            maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-10
        )
        _, _, st_u = ba_solve_wtt(uncapped, config)
        _, _, st_c = ba_solve_wtt(capped, config)
        assert int(st_c.accepted) == int(st_u.accepted)
        np.testing.assert_allclose(
            float(st_c.loss), float(st_u.loss), rtol=1e-9, atol=1e-18
        )

    def test_capped_hub_fully_indexed_deferred(self, hub_flat):
        """CAPPED split + DEFERRED (wcam-only) packing on a hub scene,
        expanded on the device: the cap merges local-only chunks into
        global bins, whose global-tile wcam rows must expand to exact
        zero selection rows — pinned against the unsplit dense-one-hot
        solve (f64)."""
        from tpu3drecon.problems.wtt import expand_onehots

        base = wtt_from_flat(hub_flat, point_chunk=64, reorder_cameras="hub")
        capped = wtt_from_flat(
            hub_flat, point_chunk=64, reorder_cameras="hub",
            split_windows=2, defer_onehot=True,
        )
        assert any(b.global_tiles > 0 for b in capped.buckets)
        assert all(b.onehot is None for b in capped.buckets)
        config = BAConfig(
            maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-10
        )
        _, _, st_x = ba_solve_wtt(base, config)
        _, _, st_k = ba_solve_wtt(
            expand_onehots(capped, onehot_dtype=jnp.float64), config
        )
        assert int(st_k.accepted) == int(st_x.accepted)
        np.testing.assert_allclose(
            float(st_k.loss), float(st_x.loss), rtol=1e-8, atol=1e-18
        )

    def test_global_tile_hulls(self):
        """Per-class global-tile HULLS (round-5 verdict item 3): when the
        global region spans several 128-camera tiles, split classes carry
        only the tile range their chunks actually touch (bucket-level
        global_tile0/global_tiles vary), instead of every global class
        paying the whole region.  Needs a scene big enough for a >=2-tile
        global region (hub planner caps the split at n/8 cameras, so
        >=1536 cams) with sparse per-point hub touches (~0.4 hubs/point:
        most hub-touching chunks hug one tile).  Values must match the
        unsplit hub solve exactly up to f64 summation order."""
        from tpu3drecon.dataset.synthetic import make_hub_scene, perturb_scene

        scene = make_hub_scene(
            n_cameras=1536, points_per_camera=40, track_span=3,
            hub_fraction=0.125, hub_obs=100, seed=41,
        )
        noisy = perturb_scene(scene, seed=42, point2d_noise=0.2)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        base = wtt_from_flat(flat, point_chunk=64, reorder_cameras="hub")
        split = wtt_from_flat(
            flat, point_chunk=64, reorder_cameras="hub", split_windows=True
        )
        base_hulls = {
            (b.global_tile0, b.global_tiles)
            for b in base.buckets if b.global_tiles
        }
        split_hulls = {
            (b.global_tile0, b.global_tiles)
            for b in split.buckets if b.global_tiles
        }
        assert len(base_hulls) == 1
        (full,) = base_hulls
        assert full[1] >= 2  # the global region really spans >= 2 tiles
        assert len(split_hulls) >= 2  # per-class hulls actually differ
        assert any(t < full[1] for _, t in split_hulls)  # some narrowed

        def macs(p):
            return sum(
                b.window * b.uv.shape[0] * b.uv.shape[2] * b.uv.shape[3]
                for b in p.buckets
            )

        assert macs(split) < 0.7 * macs(base)
        config = BAConfig(
            maxiter=2, gtol=0.0, ftol=0.0, cg_maxiter=4, cg_rtol=1e-10
        )
        _, _, st_b = ba_solve_wtt(base, config)
        _, _, st_s = ba_solve_wtt(split, config)
        assert int(st_s.accepted) == int(st_b.accepted)
        np.testing.assert_allclose(
            float(st_s.loss), float(st_b.loss), rtol=1e-9, atol=1e-18
        )

    def test_band_precond_rejected_with_hub_tiles(self, hub_flat):
        wtt = wtt_from_flat(hub_flat, point_chunk=128, reorder_cameras="hub")
        config = BAConfig(maxiter=2, cg_maxiter=4, precond="ssor")
        with pytest.raises(ValueError, match="hub/global"):
            ba_solve_wtt(wtt, config)

    def test_hub_scene_deterministic(self):
        from tpu3drecon.dataset.synthetic import make_hub_scene

        a = make_hub_scene(n_cameras=64, points_per_camera=6, seed=3)
        b = make_hub_scene(n_cameras=64, points_per_camera=6, seed=3)
        np.testing.assert_array_equal(a.cam_idx, b.cam_idx)
        np.testing.assert_array_equal(a.uv, b.uv)
        np.testing.assert_array_equal(a.rmats, b.rmats)
