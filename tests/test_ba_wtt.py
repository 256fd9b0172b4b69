"""Windowed track-table engine: packing, window locality, solve equality."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu3drecon.dataset.synthetic import (
    make_scene,
    make_sequential_scene,
    perturb_scene,
    scene_to_ba_problem,
)
from tpu3drecon.problems.tt import tt_from_flat
from tpu3drecon.problems.wtt import CAM_TILE, wtt_from_flat
from tpu3drecon.solvers.ba_tt import ba_solve_tt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig, reprojection_rmse


@pytest.fixture(scope="module", params=[(0.0, 0.0), (-0.05, 0.008)], ids=["pinhole", "radial"])
def seq_problem(request):
    scene = make_sequential_scene(
        n_cameras=24, points_per_camera=25, track_span=3, seed=5,
        dist=request.param,
    )
    noisy = perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return flat


@pytest.fixture(scope="module")
def wtt_problem(seq_problem):
    return wtt_from_flat(seq_problem, point_chunk=64)


class TestWTTPacking:
    def test_counts_preserved(self, seq_problem, wtt_problem):
        n_real = int(np.array(seq_problem.mask).sum())
        total = sum(int(np.array(b.mask).sum()) for b in wtt_problem.buckets)
        assert total == n_real
        onehot_total = sum(
            int(np.array(b.onehot, dtype=np.float64).sum()) for b in wtt_problem.buckets
        )
        assert onehot_total == n_real

    def test_uv_cam_slots_match_flat(self, seq_problem, wtt_problem):
        # Every (camera, uv) observation of the flat problem appears exactly
        # once across the windowed buckets, with the window-relative one-hot
        # row + cam_base reconstructing the global camera id.
        fmask = np.array(seq_problem.mask) > 0
        flat_pairs = sorted(
            (int(c), round(float(u), 9), round(float(v), 9))
            for c, (u, v) in zip(
                np.array(seq_problem.cam_idx)[fmask],
                np.array(seq_problem.uv)[fmask],
            )
        )
        wtt_pairs = []
        for b in wtt_problem.buckets:
            uv = np.array(b.uv)  # (G, 2, Tb, Pc)
            onehot = np.array(b.onehot, dtype=np.float64)  # (G, W, Tb*Pc)
            base = np.array(b.cam_base)
            g_, _, tb, pc = uv.shape
            for gi in range(g_):
                sel = onehot[gi].sum(axis=0)  # real slots have exactly one 1
                rows = onehot[gi].argmax(axis=0)
                for n in np.nonzero(sel)[0]:
                    t, p = divmod(int(n), pc)
                    cam = int(rows[n]) + int(base[gi])
                    wtt_pairs.append(
                        (
                            cam,
                            round(float(uv[gi, 0, t, p]), 9),
                            round(float(uv[gi, 1, t, p]), 9),
                        )
                    )
        assert sorted(wtt_pairs) == flat_pairs

    def test_window_locality_beats_dense(self):
        # On a long sequential trajectory the DOMINANT bucket's window must
        # stay far below the padded camera axis — that is the whole point of
        # the layout.  (Tiny boundary buckets may be camera-wide; windows
        # are per bucket precisely so they don't poison the big one.)
        scene = make_sequential_scene(
            n_cameras=400, points_per_camera=8, track_span=4, seed=9
        )
        flat, _ = scene_to_ba_problem(scene, observed=scene)
        wtt = wtt_from_flat(flat, point_chunk=128)
        assert wtt.c_pad >= 512

        def slots(b):
            g, _, tb, pc = b.uv.shape
            return g * tb * pc

        dominant = max(wtt.buckets, key=slots)
        assert dominant.window <= 2 * CAM_TILE  # span<=4 cams + alignment
        # Windowed one-hot memory stays below the dense equivalent; the
        # ratio approaches c_pad / (2*CAM_TILE) as the trajectory grows
        # (~2x at these 400 cameras, ~7x at Ladybug-1723).
        windowed = sum(b.window * slots(b) for b in wtt.buckets)
        dense = sum(wtt.c_pad * slots(b) for b in wtt.buckets)
        assert windowed < dense

    def test_cam_base_aligned_and_in_range(self, wtt_problem):
        for b in wtt_problem.buckets:
            base = np.array(b.cam_base)
            assert b.window % CAM_TILE == 0
            assert b.window <= wtt_problem.c_pad
            assert (base % CAM_TILE == 0).all()
            assert (base >= 0).all()
            assert (base + b.window <= wtt_problem.c_pad).all()

    def test_size_guard(self, seq_problem):
        with pytest.raises(ValueError, match="one-hot"):
            wtt_from_flat(seq_problem, point_chunk=64, max_onehot_bytes=16)

    def test_choose_cap(self):
        from tpu3drecon.problems.wtt import _choose_cap

        # Uniform long runs merge fully (one group per run, zero waste).
        assert _choose_cap([100, 100, 100]) == 100
        # All-distinct bases: cap stays 1 (any larger cap is 100% waste).
        assert _choose_cap([1] * 50) == 1
        # Mixed: a cap of 100 would pad the two 1-runs by 99 each (>12.5%);
        # the best admissible cap keeps waste bounded.
        cap = _choose_cap([100, 1, 1])
        total = sum(((r + cap - 1) // cap) * cap for r in [100, 1, 1])
        assert total <= 102 * 1.125
        # min_groups forces enough groups for a mesh when admissible.
        cap8 = _choose_cap([64], min_groups=8)
        assert 64 // cap8 >= 8
        assert _choose_cap([]) == 1

    def test_grouping_merges_sequential_chunks(self):
        # A long sequential scene must pack into FEW groups (batched matmuls want
        # few large batches), with counts preserved.
        scene = make_sequential_scene(
            n_cameras=192, points_per_camera=16, track_span=4, seed=21
        )
        flat, _ = scene_to_ba_problem(scene, observed=scene)
        wtt = wtt_from_flat(flat, point_chunk=64)
        dominant = max(wtt.buckets, key=lambda b: b.mask.size)
        tb = dominant.mask.shape[1]
        n_micro = dominant.mask.size // (tb * 64)
        assert dominant.uv.shape[0] * 4 <= n_micro  # actually merged
        n_real = int(np.array(flat.mask).sum())
        total = sum(int(np.array(b.mask).sum()) for b in wtt.buckets)
        assert total == n_real


class TestWTTSolve:
    def test_matches_tt_engine(self, seq_problem, wtt_problem):
        config = BAConfig(
            maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10,
        )
        tt = tt_from_flat(seq_problem, point_block=64)
        cams_t, pts_t, st_t = ba_solve_tt(tt, config)
        cams_w, pts_w, st_w = ba_solve_wtt(wtt_problem, config)
        assert int(st_w.accepted) == int(st_t.accepted)
        np.testing.assert_allclose(
            float(st_w.loss), float(st_t.loss), rtol=1e-6, atol=1e-18
        )
        np.testing.assert_allclose(
            np.array(cams_w.tvecs), np.array(cams_t.tvecs), atol=1e-6
        )
        np.testing.assert_allclose(
            np.array(cams_w.fx_fy), np.array(cams_t.fx_fy), rtol=1e-6
        )
        np.testing.assert_allclose(np.array(pts_w), np.array(pts_t), atol=1e-6)

    def test_converges_to_gt_rmse(self, seq_problem, wtt_problem):
        # The line-trajectory scene is gauge-weak (cameras nearly collinear,
        # tracks of <=3), so LM converges linearly here: loss reaches ~1e-10
        # in 25 iters (vs ~1e-26 on the all-see-all scene) and keeps
        # dropping steadily thereafter.  Assert the solve is clearly at the
        # noiseless optimum basin rather than machine-epsilon RMSE.
        config = BAConfig(maxiter=25, cg_maxiter=50, cg_rtol=1e-8)
        cams, pts, state = ba_solve_wtt(wtt_problem, config)
        rmse = float(reprojection_rmse(seq_problem, cams, pts))
        assert rmse < 2e-3
        assert float(state.loss) < 1e-9

    def test_joint_distortion_matches_tt(self, seq_problem, wtt_problem):
        config = BAConfig(
            maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10,
            optimize_dist=True,
        )
        tt = tt_from_flat(seq_problem, point_block=64)
        cams_t, pts_t, st_t = ba_solve_tt(tt, config)
        cams_w, pts_w, st_w = ba_solve_wtt(wtt_problem, config)
        assert int(st_w.accepted) == int(st_t.accepted)
        np.testing.assert_allclose(
            np.array(cams_w.dist), np.array(cams_t.dist), rtol=0, atol=1e-8
        )
        np.testing.assert_allclose(np.array(pts_w), np.array(pts_t), atol=1e-6)

    def test_joint_pp_matches_tt(self, seq_problem, wtt_problem):
        config = BAConfig(
            maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10,
            optimize_pp=True,
        )
        tt = tt_from_flat(seq_problem, point_block=64)
        cams_t, pts_t, st_t = ba_solve_tt(tt, config)
        cams_w, pts_w, st_w = ba_solve_wtt(wtt_problem, config)
        assert int(st_w.accepted) == int(st_t.accepted)
        # cx/cy are pixel-scale (~640), so pure atol=1e-8 is below one f64
        # summation-reorder ulp of the engines' different reduce layouts;
        # rtol=1e-9 keeps the bound at ~1e-6 px without masking real drift.
        np.testing.assert_allclose(
            np.array(cams_w.cx_cy_skew), np.array(cams_t.cx_cy_skew),
            rtol=1e-9, atol=1e-8,
        )
        np.testing.assert_allclose(np.array(pts_w), np.array(pts_t), atol=1e-6)

    def test_dislocal_data_still_correct(self):
        # All-see-all synthetic data has no camera locality: the window
        # degenerates toward c_pad and the engine must still be exact.
        scene = make_scene(n_cameras=8, n_points=256, seed=13)
        noisy = perturb_scene(scene, seed=14, point2d_noise=0.0)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        wtt = wtt_from_flat(flat, point_chunk=64)
        assert wtt.window == wtt.c_pad == CAM_TILE
        config = BAConfig(maxiter=15, cg_maxiter=40, cg_rtol=1e-9)
        cams, pts, state = ba_solve_wtt(wtt, config)
        rmse = float(reprojection_rmse(flat, cams, pts))
        assert rmse < 1e-7

    def test_jit_solver_cache(self, wtt_problem):
        from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver

        config = BAConfig(maxiter=3, cg_maxiter=10)
        s1 = make_wtt_ba_solver(config)
        s2 = make_wtt_ba_solver(config)
        assert s1 is s2
        cams, pts, state = s1(wtt_problem)
        assert bool(jnp.isfinite(state.loss))


class TestDeferredOnehot:
    def test_expand_matches_direct_pack(self, seq_problem):
        from tpu3drecon.problems.wtt import expand_onehots

        direct = wtt_from_flat(seq_problem, point_chunk=64)
        deferred = wtt_from_flat(seq_problem, point_chunk=64, defer_onehot=True)
        for b in deferred.buckets:
            assert b.onehot is None
            assert b.wcam.dtype == jnp.int16
        expanded = expand_onehots(deferred, onehot_dtype=jnp.float64)
        for bd, be in zip(direct.buckets, expanded.buckets):
            # wcam is retained after expansion (the compact form) and
            # must agree with the direct pack's copy.
            np.testing.assert_array_equal(
                np.asarray(be.wcam), np.asarray(bd.wcam)
            )
            np.testing.assert_array_equal(
                np.asarray(be.onehot, np.float64),
                np.asarray(bd.onehot, np.float64),
            )

    def test_compact_is_small(self, seq_problem):
        deferred = wtt_from_flat(seq_problem, point_chunk=64, defer_onehot=True)
        direct = wtt_from_flat(seq_problem, point_chunk=64)
        compact = sum(b.wcam.size * b.wcam.dtype.itemsize for b in deferred.buckets)
        dense = sum(b.onehot.size * b.onehot.dtype.itemsize for b in direct.buckets)
        assert compact * 8 <= dense  # >= 8x smaller host->device stream

    def test_onehot_dtype_ladder_bit_identical(self, seq_problem):
        """{0,1} is exact in bf16/int8/float8: every encoding must produce
        bit-equal dot inputs, hence bit-identical solves (the 1-byte
        encodings exist to compress the dominant matvec memory stream)."""
        from tpu3drecon.problems.wtt import expand_onehots
        from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver

        deferred = wtt_from_flat(seq_problem, point_chunk=64, defer_onehot=True)
        solver = make_wtt_ba_solver(
            BAConfig(maxiter=2, gtol=0.0, ftol=0.0, cg_maxiter=6, cg_rtol=0.0)
        )
        losses = {}
        for dt in (jnp.bfloat16, jnp.int8, jnp.float8_e4m3fn, jnp.int4):
            p = expand_onehots(deferred, onehot_dtype=dt)
            assert p.buckets[0].onehot.dtype == jnp.dtype(dt)
            losses[jnp.dtype(dt).name] = float(solver(p)[2].loss)
        assert len(set(losses.values())) == 1, losses

    def test_engine_rejects_deferred(self, seq_problem):
        deferred = wtt_from_flat(seq_problem, point_chunk=64, defer_onehot=True)
        with pytest.raises(ValueError, match="expand_onehots"):
            ba_solve_wtt(deferred, BAConfig(maxiter=1))

    def test_solve_equality_via_deferred(self, seq_problem, wtt_problem):
        from tpu3drecon.problems.wtt import expand_onehots

        config = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=12,
                          cg_rtol=1e-10)
        expanded = expand_onehots(
            wtt_from_flat(seq_problem, point_chunk=64, defer_onehot=True),
            onehot_dtype=jnp.float64,
        )
        cams_a, pts_a, st_a = ba_solve_wtt(wtt_problem, config)
        cams_b, pts_b, st_b = ba_solve_wtt(expanded, config)
        np.testing.assert_allclose(
            np.asarray(pts_a), np.asarray(pts_b), rtol=0, atol=1e-12
        )
        assert float(st_a.loss) == pytest.approx(float(st_b.loss), rel=1e-12)


class TestPlaneBudgetAutotune:
    def _fake_problem(self, onehot_gb):
        import types

        import numpy as np

        class B:
            pass

        b = B()
        n = int(onehot_gb * 1e9 / 2)  # bf16 entries
        b.onehot = types.SimpleNamespace(
            size=n, dtype=np.dtype(np.float16)
        )
        b.uv = types.SimpleNamespace(
            size=1024, dtype=np.dtype(np.float32), shape=(1, 2, 4, 128)
        )
        b.mask = types.SimpleNamespace(size=512, dtype=np.dtype(np.float32))
        p = types.SimpleNamespace(buckets=[b])
        return p

    @pytest.fixture
    def on_card(self, monkeypatch):
        """Pretend to run on an 80 GB card (60 GB allocator limit)."""
        from tpu3drecon.utils import device

        monkeypatch.setattr(
            device, "device_info",
            lambda devices=None: device.DeviceInfo("gpu", "NVIDIA H100", 1),
        )
        monkeypatch.setattr(device, "memory_bytes", lambda d=None: 60_000_000_000)

    def test_budget_clamps_to_hbm(self, on_card):
        from tpu3drecon.solvers import ba_wtt

        share = int(60_000_000_000 * ba_wtt._PLANE_SHARE)
        # Small residency: the clamp is inactive, the budget is the share.
        small = self._fake_problem(2.1)
        assert ba_wtt._contrib_plane_budget(small) == share
        # A 50 GB one-hot problem: budget shrinks to what fits.
        big = self._fake_problem(50.0)
        budget = ba_wtt._contrib_plane_budget(big)
        assert ba_wtt._MIN_PLANE_BYTES <= budget < share
        # Pathological residency: floor holds.
        huge = self._fake_problem(70.0)
        assert ba_wtt._contrib_plane_budget(huge) == ba_wtt._MIN_PLANE_BYTES

    @pytest.mark.parametrize("limit", [16_000_000_000, 60_000_000_000])
    def test_budget_follows_memory_limit(self, monkeypatch, on_card, limit):
        """The budget is derived from the card's reported limit, not from a
        constant sized for one card."""
        from tpu3drecon.solvers import ba_wtt
        from tpu3drecon.utils import device

        monkeypatch.setattr(device, "memory_bytes", lambda d=None: limit)
        assert ba_wtt._contrib_plane_budget() == int(limit * ba_wtt._PLANE_SHARE)

    def test_host_budget_splits_across_devices(self):
        """On the CPU backend the virtual devices share one host's RAM."""
        import jax

        from tpu3drecon.solvers import ba_wtt

        assert ba_wtt._contrib_plane_budget() == (
            ba_wtt._HOST_PLANE_BYTES // len(jax.devices())
        )

    def test_unknown_memory_is_an_error(self, monkeypatch, on_card):
        from tpu3drecon.solvers import ba_wtt
        from tpu3drecon.utils import device

        def unknown(d=None):
            raise RuntimeError("does not report its memory limit")

        monkeypatch.setattr(device, "memory_bytes", unknown)
        with pytest.raises(RuntimeError, match="memory limit"):
            ba_wtt._contrib_plane_budget(self._fake_problem(1.0))

    def test_env_override_wins(self, monkeypatch):
        from tpu3drecon.solvers import ba_wtt

        monkeypatch.setenv("TPU3DRECON_PLANE_BYTES", "123456")
        assert ba_wtt._contrib_plane_budget(self._fake_problem(10.0)) == 123456


class TestSplitWindows:
    """``split_windows=True`` refines each bucket's window to MICRO-CHUNK
    window classes (wtt_from_flat docstring): selection work is
    window_rows x slots, and the bucket-max window pays 256+ rows for
    chunks that individually span < 128 cameras — simulated 0.51x
    selection MACs at BAL scale.
    Values must be step-equivalent to the unsplit packing (same
    contributions, different f32 summation order)."""

    @pytest.fixture(scope="class")
    def long_flat(self):
        scene = make_sequential_scene(
            n_cameras=160, points_per_camera=12, track_span=5, seed=5
        )
        noisy = perturb_scene(scene, seed=6, point2d_noise=0.0)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        return flat

    @pytest.fixture(scope="class")
    def packs(self, long_flat):
        base = wtt_from_flat(long_flat, point_chunk=64)
        split = wtt_from_flat(long_flat, point_chunk=64, split_windows=True)
        return base, split

    def test_packing_narrows_windows(self, long_flat, packs):
        base, split = packs
        n_real = int(np.array(long_flat.mask).sum())
        total = sum(int(np.array(b.mask).sum()) for b in split.buckets)
        assert total == n_real

        def macs(p):
            return sum(
                b.window * b.uv.shape[0] * b.uv.shape[2] * b.uv.shape[3]
                for b in p.buckets
            )

        # The narrow majority classes must cut the selection-MAC volume.
        assert macs(split) < 0.75 * macs(base)
        assert min(b.window for b in split.buckets) < max(
            b.window for b in base.buckets
        )

    @pytest.mark.parametrize("precond", ["schur_jacobi", "ssor"])
    def test_solve_equality(self, packs, precond):
        base, split = packs
        config = BAConfig(
            maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-10,
            precond=precond,
        )
        cams_b, pts_b, st_b = ba_solve_wtt(base, config)
        cams_s, pts_s, st_s = ba_solve_wtt(split, config)
        assert int(st_s.accepted) == int(st_b.accepted)
        np.testing.assert_allclose(
            float(st_s.loss), float(st_b.loss), rtol=1e-9, atol=1e-18
        )
        np.testing.assert_allclose(
            np.array(cams_s.tvecs), np.array(cams_b.tvecs), atol=1e-8
        )
        np.testing.assert_allclose(
            np.array(pts_s), np.array(pts_b), atol=1e-8
        )

    def test_class_cap_coalescing(self, long_flat, packs):
        """An int ``split_windows`` caps the per-bucket class count via
        exact covering-bin merging (problems/wtt._coalesce_window_classes) —
        fewer WTTBuckets = fewer per-bucket ops to compile.  cap=1 is
        the strongest merge (every class folds into the widest) and must
        reproduce the unsplit solution exactly up to f64 noise."""
        base, split = packs
        capped = wtt_from_flat(long_flat, point_chunk=64, split_windows=1)
        assert len(capped.buckets) == len(base.buckets)
        assert len(split.buckets) > len(capped.buckets)
        config = BAConfig(
            maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-10
        )
        _, _, st_b = ba_solve_wtt(base, config)
        _, _, st_c = ba_solve_wtt(capped, config)
        assert int(st_c.accepted) == int(st_b.accepted)
        np.testing.assert_allclose(
            float(st_c.loss), float(st_b.loss), rtol=1e-9, atol=1e-18
        )

    def test_chunk_multiple_padding(self, long_flat):
        split = wtt_from_flat(
            long_flat, point_chunk=64, split_windows=True, chunk_multiple=4
        )
        for b in split.buckets:
            assert b.uv.shape[0] % 4 == 0
        _, _, st = ba_solve_wtt(
            split, BAConfig(maxiter=2, gtol=0.0, ftol=0.0, cg_maxiter=6)
        )
        assert bool(np.isfinite(float(st.loss)))


class TestCoalesceWindowClasses:
    """Direct unit pins for ``_coalesce_window_classes`` (round-5 advisor
    findings): the capped cover must be the true selection-MAC optimum
    (the old ``top in subset`` prune excluded feasible optima whenever
    the widest-local/narrow-global pair beat the widest-global bin), int
    caps must be validated, and oversized enumerations must fall back to
    a bounded greedy-add instead of hanging in itertools.combinations."""

    @staticmethod
    def _cost(bins, runs_by_class):
        from tpu3drecon.problems.wtt import CAM_TILE

        def rows(k):
            w, gr = k
            return w + ((gr[1] - gr[0] + 1) * CAM_TILE if gr else 0)

        def ok(b, k):
            if b[0] < k[0]:
                return False
            if k[1] is None:
                return True
            return b[1] is not None and b[1][0] <= k[1][0] and b[1][1] >= k[1][1]

        total = 0
        for k, runs in runs_by_class.items():
            w = sum(len(ids) for _, ids in runs)
            total += w * min(rows(b) for b in bins if ok(b, k))
        return total

    def test_prune_free_optimum(self):
        """The advisor's counterexample: a heavy widest-LOCAL class plus a
        light global class.  The optimal cap-2 cover pairs the widest
        local bin with a narrow global bin; the pruned enumerator was
        forced to take the widest-GLOBAL key and paid for it."""
        from tpu3drecon.problems.wtt import _coalesce_window_classes

        runs = {
            (1792, None): [(0, list(range(100)))],
            (128, (0, 0)): [(0, [100])],
            (256, None): [(0, [101, 102])],
        }
        merged = _coalesce_window_classes(runs, 2, n_gt=1, c_pad=1792)
        bins = set(merged)
        assert bins == {(1792, None), (256, (0, 0))}
        assert self._cost(bins, runs) == 100 * 1792 + 1 * 384 + 2 * 384
        # Old forced-top behavior: {(1792,None),(1792,(0,0))} = 184704.
        assert self._cost(bins, runs) < 184704
        # Every chunk id survives the merge exactly once.
        ids = sorted(i for rs in merged.values() for _, g in rs for i in g)
        assert ids == list(range(103))

    def test_int_cap_validation(self):
        from tpu3drecon.problems.wtt import _split_class_cap

        with pytest.raises(ValueError, match="must be > 0"):
            _split_class_cap(-1)
        with pytest.raises(ValueError, match="must be > 0"):
            _split_class_cap(0)
        assert _split_class_cap(True) >= 1
        assert _split_class_cap(7) == 7

    def test_negative_cap_through_packer(self):
        scene = make_sequential_scene(
            n_cameras=12, points_per_camera=8, track_span=2, seed=3
        )
        noisy = perturb_scene(scene, seed=4, point2d_noise=0.0)
        flat, _ = scene_to_ba_problem(noisy, observed=scene)
        with pytest.raises(ValueError, match="must be > 0"):
            wtt_from_flat(flat, point_chunk=32, split_windows=-2)

    def test_greedy_fallback_bounded(self):
        """40 widths at cap 10 -> C(40,10) ~ 8.5e8 subsets: the exact
        enumerator must NOT run (the old code hung here); the greedy-add
        fallback must cover every class, respect the cap, and stay
        deterministic."""
        import time as _time

        from tpu3drecon.problems.wtt import _coalesce_window_classes

        runs = {
            (128 * (i + 1), None): [(0, [i])] for i in range(40)
        }
        t0 = _time.time()
        merged = _coalesce_window_classes(runs, 10, n_gt=0, c_pad=128 * 45)
        took = _time.time() - t0
        assert took < 5.0
        assert len(merged) <= 10
        ids = sorted(i for rs in merged.values() for _, g in rs for i in g)
        assert ids == list(range(40))
        # Deterministic: a second call reproduces the same bin set.
        merged2 = _coalesce_window_classes(runs, 10, n_gt=0, c_pad=128 * 45)
        assert set(merged2) == set(merged)
        # Greedy must beat the single-bin degenerate cover.
        assert self._cost(set(merged), runs) < self._cost(
            {(128 * 40, None)}, runs
        )


class TestWTTPrincipalPointAtScale:
    """Round-4 verdict item 5: pp refinement through wtt at BAL-ratio
    camera counts, single-device and sharded (small-scale tt equality
    already pinned in TestWTTJoint::test_joint_pp_matches_tt)."""

    def test_pp_recovers_gt_bal_ratio(self):
        import dataclasses

        from tpu3drecon.dataset.synthetic import make_sequential_scene

        # BAL-ratio: camera count >> window (128 cams, span-3 tracks).
        scene = make_sequential_scene(
            n_cameras=128, points_per_camera=12, track_span=3, seed=41
        )
        flat, _ = scene_to_ba_problem(scene, observed=scene, dtype=jnp.float64)
        rng = np.random.default_rng(42)
        delta = np.zeros((128, 3))
        delta[:, :2] = rng.normal(scale=3.0, size=(128, 2))  # pixels
        gt_ccs = np.array(flat.cameras.cx_cy_skew)
        flat0 = dataclasses.replace(
            flat,
            cameras=dataclasses.replace(
                flat.cameras, cx_cy_skew=jnp.asarray(gt_ccs + delta)
            ),
        )
        wtt = wtt_from_flat(flat0, point_chunk=64, chunk_multiple=4)
        assert wtt.c_pad < 256 or wtt.buckets[0].window < wtt.c_pad
        config = BAConfig(
            maxiter=40, cg_maxiter=40, cg_rtol=1e-10, optimize_pp=True
        )
        cams, pts, state = ba_solve_wtt(wtt, config)
        # Line-trajectory scenes are gauge-weak and converge linearly
        # (see TestShardedWTT notes): at 40 iters the measured point is
        # rmse 5.7e-4 px with 89% of the pp perturbation recovered.
        rmse = float(reprojection_rmse(flat, cams, pts))
        assert rmse < 1e-3
        err0 = np.abs(delta[:, :2]).mean()
        err1 = np.abs(np.array(cams.cx_cy_skew)[:, :2] - gt_ccs[:, :2]).mean()
        assert err1 < 0.15 * err0

        # Sharded equality of the pp path on the 4-device mesh.
        from tpu3drecon.parallel.mesh import make_mesh
        from tpu3drecon.parallel.sharded_wtt import ba_solve_wtt_sharded

        short = config._replace(maxiter=3, gtol=0.0, ftol=0.0)
        cams_s, pts_s, st_s = ba_solve_wtt_sharded(
            wtt, short, mesh=make_mesh(4)
        )
        cams_1, pts_1, st_1 = ba_solve_wtt(wtt, short)
        assert int(st_s.accepted) == int(st_1.accepted)
        np.testing.assert_allclose(
            np.asarray(cams_s.cx_cy_skew), np.asarray(cams_1.cx_cy_skew),
            rtol=1e-9, atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(pts_s), np.asarray(pts_1), rtol=0, atol=1e-7
        )
