"""First-party Levenberg–Marquardt engine (dense normal equations).

Replaces the reference's external jaxopt ``LevenbergMarquardt`` dependency
(reference: src/reconstruction/bundle_adjustment/pose_optimization.py:62-71,
bundle_adjustment.py:83-91) with an in-repo trust-region LM:

  - ``lax.while_loop`` damping loop — the whole solve is ONE XLA executable,
    iterations never leave the chip;
  - residual + Jacobian evaluated only after *accepted* steps (rejected steps
    reuse the cached linearization; jaxopt re-evaluates every probe);
  - Nielsen trust-region damping (lambda *= max(1/3, 1-(2*rho-1)^3) on accept,
    lambda *= nu, nu *= 2 on reject);
  - pluggable ``retract`` so manifold parameterizations (SE(3) local deltas)
    reuse the same loop;
  - vmappable: all control flow is lax-level, so ``jax.vmap(lm_solve...)``
    batches independent problems in lockstep exactly like the reference's
    ``vmap(lm.run)`` (pose_optimization.py:71).

This dense path materializes J — intended for small parameter blocks (e.g.
8-dof pose refinement). Bundle adjustment uses the matrix-free Schur engine in
``tpu3drecon.solvers.bundle_adjust`` built on the same damping strategy.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class LMConfig(NamedTuple):
    """LM stopping/damping configuration.

    ``gtol`` matches the role of the reference's jaxopt ``tol`` (gradient-norm
    test; pose_optimization.py:63 uses 1e-7, bundle_adjustment.py:85 1e-6).
    """

    maxiter: int = 100
    gtol: float = 1e-8  # inf-norm of gradient
    ftol: float = 1e-12  # relative cost decrease on accepted steps
    xtol: float = 0.0  # relative step norm (0 disables)
    init_lambda: float = 1e-3
    min_lambda: float = 1e-32
    max_lambda: float = 1e32
    diag_damping: bool = True  # lambda * diag(JtJ) (Marquardt) vs lambda * I


class DynamicLMParams(NamedTuple):
    """LMConfig fields that are pure runtime scalars inside the compiled
    program; passed as jnp operands so one executable serves every
    hyperparameter setting (same design as solvers.bundle_adjust's
    DynamicBAParams)."""

    maxiter: jax.Array
    gtol: jax.Array
    ftol: jax.Array
    xtol: jax.Array
    init_lambda: jax.Array


_LM_DYN_SENTINEL = dict(
    maxiter=-1, gtol=-1.0, ftol=-1.0, xtol=-1.0, init_lambda=-1.0
)


def static_lm_config(config: "LMConfig") -> "LMConfig":
    """Jit-cache key (pure Python, no backend initialization)."""
    return config._replace(**_LM_DYN_SENTINEL)


_LM_DYN_OPERAND_CACHE: dict = {}


def dynamic_lm_operands(config: "LMConfig") -> "DynamicLMParams":
    """Concrete operand arrays (memoized); initializes the jax backend, so
    factories defer this to solver CALL time (platform-pinning trap)."""
    dyn = _LM_DYN_OPERAND_CACHE.get(config)
    if dyn is None:
        dyn = DynamicLMParams(
            maxiter=jnp.asarray(config.maxiter, jnp.int32),
            gtol=jnp.asarray(float(config.gtol)),
            ftol=jnp.asarray(float(config.ftol)),
            xtol=jnp.asarray(float(config.xtol)),
            init_lambda=jnp.asarray(float(config.init_lambda)),
        )
        _LM_DYN_OPERAND_CACHE[config] = dyn
    return dyn


def split_dynamic_lm_config(config: "LMConfig"):
    """(static_key, dynamic_operands) for LMConfig — creates arrays NOW; use
    static_lm_config + dynamic_lm_operands to defer backend init."""
    return static_lm_config(config), dynamic_lm_operands(config)


def merge_dynamic_lm_config(static: "LMConfig", dyn: DynamicLMParams) -> "LMConfig":
    return static._replace(**dyn._asdict())


class LMState(NamedTuple):
    params: jax.Array
    residual: jax.Array  # cached residual at params
    jac: jax.Array  # cached Jacobian at params
    loss: jax.Array  # 0.5 * ||residual||^2
    lam: jax.Array
    nu: jax.Array
    iter_num: jax.Array  # total loop iterations (accepted + rejected)
    accepted: jax.Array  # accepted step count
    grad_norm: jax.Array
    converged: jax.Array
    gain: jax.Array  # last gain ratio (diagnostics)


def _default_retract(params: jax.Array, step: jax.Array) -> jax.Array:
    return params + step


def _loss_of(residual: jax.Array) -> jax.Array:
    return 0.5 * jnp.vdot(residual, residual).real


def lm_solve(
    residual_fn: Callable[..., jax.Array],
    params0: jax.Array,
    *args,
    config: LMConfig = LMConfig(),
    retract: Optional[Callable[[jax.Array, jax.Array], jax.Array]] = None,
):
    """Minimize 0.5*||residual_fn(params, *args)||^2 with dense-J LM.

    Returns ``(params, LMState)``.  ``residual_fn`` must return a flat array
    (callers ravel structured residuals).  Jit/vmap-safe.
    """
    retract = retract or _default_retract
    with jax.default_matmul_precision("highest"):
        return _lm_solve_impl(residual_fn, params0, args, config, retract)


def _lm_solve_impl(residual_fn, params0, args, config, retract):
    dtype = params0.dtype
    n_params = params0.shape[-1]

    def res_and_jac(p):
        r = residual_fn(p, *args)
        jac = jax.jacfwd(lambda q: residual_fn(q, *args))(p)
        return r, jac

    r0, j0 = res_and_jac(params0)

    init = LMState(
        params=params0,
        residual=r0,
        jac=j0,
        loss=_loss_of(r0),
        lam=jnp.asarray(config.init_lambda, dtype),
        nu=jnp.asarray(2.0, dtype),
        iter_num=jnp.zeros((), jnp.int32),
        accepted=jnp.zeros((), jnp.int32),
        grad_norm=jnp.asarray(jnp.inf, dtype),
        converged=jnp.zeros((), bool),
        gain=jnp.zeros((), dtype),
    )


    def cond(state: LMState):
        return jnp.logical_and(state.iter_num < config.maxiter, ~state.converged)

    def body(state: LMState):
        jtj = state.jac.T @ state.jac
        grad = state.jac.T @ state.residual
        grad_norm = jnp.max(jnp.abs(grad))

        if config.diag_damping:
            damp = jnp.clip(jnp.diag(jtj), 1e-10, None)
        else:
            damp = jnp.ones(n_params, dtype)
        a = jtj + state.lam * jnp.diag(damp)

        # Jacobi equilibration before the factorization: parameters mix
        # scales wildly (focal^2 ~1e6 vs rotation ~1), and the raw normal
        # equations lose too many digits in f32.  Solve
        # (D^-1/2 A D^-1/2) y = -D^-1/2 g, step = D^-1/2 y.
        d_inv_sqrt = 1.0 / jnp.sqrt(jnp.clip(jnp.diag(a), 1e-20, None))
        a_eq = a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
        # PD by construction (JtJ PSD + positive diagonal damping); a failed
        # factorization surfaces as NaN step -> rejected below.
        chol = jax.scipy.linalg.cho_factor(a_eq)
        step = d_inv_sqrt * jax.scipy.linalg.cho_solve(chol, -(d_inv_sqrt * grad))

        cand = retract(state.params, step)
        r_cand = residual_fn(cand, *args)
        loss_cand = _loss_of(r_cand)

        # Predicted reduction of the damped quadratic model:
        # 0.5 * step^T (lam * D * step - grad).
        pred = 0.5 * jnp.vdot(step, state.lam * damp * step - grad).real
        pred = jnp.maximum(pred, jnp.asarray(1e-32, dtype))
        gain = (state.loss - loss_cand) / pred

        accept = jnp.logical_and(jnp.isfinite(loss_cand), loss_cand < state.loss)

        lam_acc = state.lam * jnp.maximum(
            jnp.asarray(1.0 / 3.0, dtype), 1.0 - (2.0 * gain - 1.0) ** 3
        )
        lam_new = jnp.where(accept, lam_acc, state.lam * state.nu)
        lam_new = jnp.clip(lam_new, config.min_lambda, config.max_lambda)
        nu_new = jnp.where(accept, jnp.asarray(2.0, dtype), state.nu * 2.0)

        # Only recompute the linearization after accepted steps.
        def accepted_lin(_):
            r_new, j_new = res_and_jac(cand)
            return cand, r_new, j_new, _loss_of(r_new)

        def rejected_lin(_):
            return state.params, state.residual, state.jac, state.loss

        params_new, r_new, j_new, loss_new = jax.lax.cond(
            accept, accepted_lin, rejected_lin, None
        )

        # xtol may be a traced operand (see DynamicLMParams), so the
        # "disabled when 0" semantics are expressed in-graph.
        xtol = jnp.asarray(config.xtol, dtype)
        step_small = jnp.logical_and(
            xtol > 0,
            jnp.linalg.norm(step)
            < xtol * (jnp.linalg.norm(state.params) + xtol),
        )
        rel_decrease = (state.loss - loss_cand) <= config.ftol * jnp.maximum(
            state.loss, jnp.asarray(1e-32, dtype)
        )
        converged = jnp.logical_or(
            grad_norm < config.gtol,
            jnp.logical_or(jnp.logical_and(accept, rel_decrease), step_small),
        )

        return LMState(
            params=params_new,
            residual=r_new,
            jac=j_new,
            loss=loss_new,
            lam=lam_new,
            nu=nu_new,
            iter_num=state.iter_num + 1,
            accepted=state.accepted + accept.astype(jnp.int32),
            grad_norm=grad_norm,
            converged=converged,
            gain=gain,
        )

    final = jax.lax.while_loop(cond, body, init)
    return final.params, final


def lm_solve_batched(
    residual_fn: Callable[..., jax.Array],
    params0: jax.Array,
    *args,
    config: LMConfig = LMConfig(),
    retract: Optional[Callable[[jax.Array, jax.Array], jax.Array]] = None,
):
    """vmap of ``lm_solve`` over a leading batch axis of every argument.

    Accelerator analog of the reference's ``jax.jit(jax.vmap(lm.run))``
    (pose_optimization.py:71): one compiled executable refines B poses in
    lockstep with static shapes.
    """
    solver = functools.partial(lm_solve, residual_fn, config=config, retract=retract)
    return jax.vmap(solver)(params0, *args)
