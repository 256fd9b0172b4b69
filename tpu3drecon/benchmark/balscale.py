"""The canonical BAL-class benchmark problem (shared by the experiments).

1712 cameras / ~1M points / 3.81M observations on a sequential capture —
BASELINE.md config #5 scale.  The host-side build costs minutes, so it
memoizes through utils/problem_cache.py; builder and cache key live HERE
(one definition) so the benchmark and experiments that share it can
never drift apart from the cache entry (an edited copy of the builder
with an unbumped key would silently serve mismatched problems to
interleaved A/B runs).

Bump _VERSION whenever the builder semantics change.
"""

from __future__ import annotations

from typing import Optional

_VERSION = "v1"


def bal_sequential_wtt(
    shuffled: bool = False,
    chunk_multiple: Optional[int] = None,
    verbose: bool = True,
    track_span: int = 4,
    points_per_camera: int = 584,
    split_windows: bool | int = False,
):
    """The cached BAL-scale wtt problem, deferred one-hots, numpy leaves.

    ``shuffled`` relabels cameras photo-tourism-style (the RCM pass inside
    wtt_from_flat must recover locality); ``chunk_multiple`` rounds group
    counts for mesh sharding.  Callers place with utils/placement.commit
    and materialize with problems.wtt.expand_onehots.
    """
    from tpu3drecon.utils.problem_cache import cached_problem

    def build():
        import jax

        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            import jax.numpy as jnp
            import numpy as np

            from tpu3drecon.dataset.synthetic import (
                make_sequential_scene,
                perturb_scene,
                scene_to_ba_problem,
            )
            from tpu3drecon.problems.wtt import wtt_from_flat

            scene = make_sequential_scene(
                n_cameras=1712, points_per_camera=points_per_camera,
                track_span=track_span, seed=7,
            )
            noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
            flat, _ = scene_to_ba_problem(
                noisy, observed=scene, dtype=jnp.float32
            )
            if shuffled:
                from tpu3drecon.problems.reorder import permute_cameras_flat

                rng = np.random.default_rng(99)
                relabel = rng.permutation(flat.n_cameras)  # perm[new] = old
                flat = permute_cameras_flat(flat, relabel)
            kwargs = {} if chunk_multiple is None else {
                "chunk_multiple": chunk_multiple
            }
            if split_windows:
                kwargs["split_windows"] = split_windows
            return wtt_from_flat(
                flat, point_chunk=512, defer_onehot=True, **kwargs
            )

    key = (
        f"balseq_1712x{points_per_camera}_span{track_span}_s7_n0.5_pc512"
        f"_deferred_{_VERSION}"
    )
    if shuffled:
        key += "_shuffled99"
    if chunk_multiple is not None:
        key += f"_cm{chunk_multiple}"
    if split_windows:
        from tpu3drecon.problems.wtt import _split_class_cap

        # splitw2: per-class global tile HULLS + the exact (prune-free)
        # capped coalescer (round 5) changed split packings — old
        # entries would silently serve the full-range layout.
        key += f"_splitw2_c{_split_class_cap(split_windows)}"
    return cached_problem(key, build, verbose=verbose)


def bal_hub_wtt(
    verbose: bool = True,
    hub_fraction: float = 0.05,
    hub_obs: int = 4000,
    points_per_camera: int = 584,
    track_span: int = 4,
    split_windows: bool | int = False,
):
    """BAL-scale HUB-STRUCTURED (photo-tourism co-visibility) wtt problem.

    1712 cameras with ``hub_fraction`` interleaved overview hubs that each
    observe ``hub_obs`` random points scene-wide — the core-periphery
    structure of the reference's Reichstag/Sacre-Coeur-class datasets
    (reference: src/benchmark_implementation/benchmark_datasets.py:30-66).
    Packed through wtt_from_flat's AUTO mode, which must discover the
    hub/global split itself (problems/reorder.plan_hub_camera_order).
    Deferred one-hots, numpy leaves; place with utils/placement.commit and
    materialize with problems.wtt.expand_onehots.
    """
    from tpu3drecon.utils.problem_cache import cached_problem

    def build():
        import jax

        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            import jax.numpy as jnp

            from tpu3drecon.dataset.synthetic import (
                make_hub_scene,
                perturb_scene,
                scene_to_ba_problem,
            )
            from tpu3drecon.problems.wtt import wtt_from_flat

            scene = make_hub_scene(
                n_cameras=1712, points_per_camera=points_per_camera,
                track_span=track_span, hub_fraction=hub_fraction,
                hub_obs=hub_obs, seed=7,
            )
            noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
            flat, _ = scene_to_ba_problem(
                noisy, observed=scene, dtype=jnp.float32
            )
            return wtt_from_flat(
                flat, point_chunk=512, defer_onehot=True,
                split_windows=split_windows,
            )

    key = (
        f"balhub_1712x{points_per_camera}_span{track_span}"
        f"_h{hub_fraction}x{hub_obs}_s7_n0.5_pc512_deferred_{_VERSION}"
    )
    if split_windows:
        from tpu3drecon.problems.wtt import _split_class_cap

        # splitw2: per-class global tile HULLS + the exact (prune-free)
        # capped coalescer (round 5) changed split packings — old
        # entries would silently serve the full-range layout.
        key += f"_splitw2_c{_split_class_cap(split_windows)}"
    return cached_problem(key, build, verbose=verbose)
