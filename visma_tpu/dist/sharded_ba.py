"""Landmark-sharded distributed bundle adjustment.

Parallel decomposition: the landmark axis L shards over the mesh's "d"
axis (landmarks are conditionally independent given poses — the Schur
complement is a SUM of per-landmark contributions). Per device:

  local build:   S_local, b_local from the device's landmark shard
  collective:    (S, b) = psum over "d"  -- one (6K)^2 all-reduce on the interconnect
  replicated:    dense Cholesky solve for pose updates
  local:         landmark back-substitution on the shard

Communication is O((6K)^2) per iteration, independent of L — the weak-
scaling shape BASELINE.json asks for (more landmarks per host at fixed
K communicates the same bytes). XLA lowers the psum to ring
reduce-scatter+all-gather over the interconnect.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visma_tpu.ba.gauss_newton import (backsub_landmarks,
                                       build_reduced_system, total_cost,
                                       _apply)
from visma_tpu.ba.problem import BaProblem


def _shard_problem(prob: BaProblem, mesh: Mesh) -> Tuple[BaProblem, int]:
    """Pad L to a multiple of the mesh size and device_put the landmark-
    indexed arrays with landmark sharding (poses replicated)."""
    n = mesh.devices.size
    L = prob.num_landmarks
    pad = (-L) % n
    X = jnp.pad(prob.X, ((0, pad), (0, 0)))
    obs = jnp.pad(prob.obs, ((0, pad), (0, 0), (0, 0)))
    mask = jnp.pad(prob.mask, ((0, pad), (0, 0)))

    land = NamedSharding(mesh, P("d"))
    repl = NamedSharding(mesh, P())
    padded = BaProblem(
        R=jax.device_put(prob.R, repl), p=jax.device_put(prob.p, repl),
        X=jax.device_put(X, land), obs=jax.device_put(obs, land),
        mask=jax.device_put(mask, land),
        intr=jax.device_put(prob.intr, repl))
    return padded, L


def _baseline(prob: BaProblem):
    """||p_last - p0|| of the problem as given: the scale anchor every
    step of a solve pins, as `ba_solve` does."""
    return jnp.linalg.norm(prob.p[-1] - prob.p[0])


def _sharded_step(mesh: Mesh):
    """Build the shard_map'd GN step for a given mesh."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(BaProblem(R=P(), p=P(), X=P("d"), obs=P("d"),
                            mask=P("d"), intr=P()), P(), P()),
        out_specs=(BaProblem(R=P(), p=P(), X=P("d"), obs=P("d"),
                             mask=P("d"), intr=P()), P()),
    )
    def step(prob_shard: BaProblem, damping, anchor):
        with jax.default_matmul_precision("highest"):
            n_dev = jax.lax.psum(1, "d")
            # poses are replicated, so the scale prior is added on every
            # shard; divide its weight by the mesh size to keep the psum'd
            # total equal to the single-device prior
            S_local, b_local, aux = build_reduced_system(
                prob_shard, damping, scale_anchor=anchor,
                scale_weight=1e6 / n_dev)
            # the gauge rows are written identically on every shard by
            # build_reduced_system; rescale so the psum keeps them intact
            n = n_dev
            gauge = jnp.arange(S_local.shape[0]) < 6
            gmask = gauge[:, None] | gauge[None, :]
            S_local = jnp.where(gmask, S_local / n, S_local)

            S = jax.lax.psum(S_local, "d")
            b = jax.lax.psum(jnp.where(gauge, b_local / n, b_local), "d")

            cho = jax.scipy.linalg.cho_factor(0.5 * (S + S.T))
            dxp = jax.scipy.linalg.cho_solve(cho, b)
            dxl = backsub_landmarks(aux, dxp)
            new = _apply(prob_shard, dxp, dxl)
            cost = jax.lax.psum(total_cost(new), "d")
            return new, cost

    return step


# jitted executables cached by mesh/iters so repeated solves reuse the
# live executable instead of re-deserializing from the persistent cache
# every call (the Msckf.run lesson; jax Mesh is hashable)
@functools.lru_cache(maxsize=16)
def _jitted_step(mesh: Mesh):
    return jax.jit(_sharded_step(mesh))


@functools.lru_cache(maxsize=16)
def _jitted_solver(mesh: Mesh, iters: int):
    step = _sharded_step(mesh)

    @jax.jit
    def run(p0, lam0):
        anchor = _baseline(p0)

        def body(carry, _):
            cur, lam, cost = carry
            cand, cand_cost = step(cur, lam, anchor)
            better = cand_cost < cost
            nxt = jax.tree.map(lambda a, b: jnp.where(better, a, b), cand, cur)
            lam_new = jnp.where(better, jnp.maximum(lam * 0.5, 1e-6),
                                jnp.minimum(lam * 4.0, 1e2))
            return (nxt, lam_new, jnp.where(better, cand_cost, cost)), cost

        # initial cost via one replicated evaluation
        c0 = total_cost(p0)
        (sol, _, c_fin), hist = jax.lax.scan(
            body, (p0, lam0, c0), None, length=iters)
        return sol, hist

    return run


def sharded_ba_step(prob: BaProblem, mesh: Mesh, damping: float = 1e-3):
    """One distributed GN step. Returns (problem, cost)."""
    padded, L = _shard_problem(prob, mesh)
    new, cost = _jitted_step(mesh)(padded, jnp.asarray(damping, jnp.float32),
                                   _baseline(prob))
    return BaProblem(R=new.R, p=new.p, X=new.X[:L], obs=new.obs[:L],
                     mask=new.mask[:L], intr=new.intr), cost


# Past this many keyframes the matrix-free PCG path wins: the dense path
# psums the full (6K)^2 reduced system and Cholesky-factors it replicated
# (O(K^2) comm, O(K^3) flops per GN step); PCG communicates O(6K) per CG
# iteration and never materializes S.
PCG_CROSSOVER_K = 64


def sharded_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                     damping: float = 1e-3, solver: str = "auto",
                     cg_iters: int = 25):
    """Distributed LM loop (same acceptance logic as ba_solve), jitted as
    one computation over the mesh. Returns (solution, cost history).

    solver: "dense" psums the (6K)^2 reduced system and solves it
    replicated; "pcg" uses the matrix-free distributed PCG
    (dist/pcg_ba.py, O(6K) comm per CG iteration); "auto" picks PCG when
    num_poses > PCG_CROSSOVER_K.
    """
    if solver == "auto":
        solver = "pcg" if prob.num_poses > PCG_CROSSOVER_K else "dense"
    if solver == "pcg":
        from visma_tpu.dist.pcg_ba import pcg_ba_solve

        return pcg_ba_solve(prob, mesh, iters=iters, cg_iters=cg_iters,
                            damping=damping)
    if solver != "dense":
        raise ValueError(f"unknown solver {solver!r}")
    padded, L = _shard_problem(prob, mesh)
    sol, hist = _jitted_solver(mesh, iters)(
        padded, jnp.asarray(damping, jnp.float32))
    return BaProblem(R=sol.R, p=sol.p, X=sol.X[:L], obs=sol.obs[:L],
                     mask=sol.mask[:L], intr=sol.intr), hist
