"""Every XLA engine in f32 against the plain reference: the flat engine in
f64, same problem, same iterations — the check chip_smoke.py makes on the
card at the medium config, here at a tiny size on the CPU."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import COST_CHECKS, RMSE_TARGET_PX  # noqa: E402
from tpu3drecon.benchmark import medium_config as mc  # noqa: E402
from tpu3drecon.dataset.synthetic import (  # noqa: E402
    make_scene,
    perturb_scene,
    scene_to_ba_problem,
)
from tpu3drecon.solvers.bundle_adjust import (  # noqa: E402
    make_ba_solver,
    reprojection_rmse,
)

CAMERA_MODELS = {"pinhole": (0.0, 0.0), "radial": (-0.08, 0.01)}


@pytest.fixture(scope="module", params=sorted(CAMERA_MODELS))
def problems(request):
    scene = make_scene(
        n_cameras=6, n_points=240, obs_per_camera=160, seed=23,
        dist=CAMERA_MODELS[request.param],
    )
    noisy = perturb_scene(scene, seed=24, point2d_noise=0.5)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        f64, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        f32, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
    ref = {
        k: float(make_ba_solver(mc.BENCH_CONFIG._replace(maxiter=k))(f64)[2].loss)
        for k in COST_CHECKS
    }
    cams, pts, _ = make_ba_solver(mc.BENCH_CONFIG)(f64)
    assert float(reprojection_rmse(f64, cams, pts)) <= RMSE_TARGET_PX
    return f32, ref


@pytest.mark.parametrize("engine", mc.ENGINES)
def test_engine_f32_matches_f64_flat(problems, engine):
    f32, ref = problems
    packed = mc.pack_for_engine(engine, f32)
    for k, tol in COST_CHECKS.items():
        cost = float(
            mc.engine_solver(engine, mc.BENCH_CONFIG._replace(maxiter=k))(packed)[2].loss
        )
        assert abs(cost - ref[k]) <= tol * abs(ref[k]), (k, cost, ref[k])
    cams, pts, state = mc.engine_solver(engine, mc.BENCH_CONFIG)(packed)
    assert float(reprojection_rmse(f32, cams, pts)) <= RMSE_TARGET_PX
    assert int(state.accepted) >= 1
