"""Matrix-free distributed PCG on the Schur-reduced camera system.

The dense distributed path (sharded_ba.py) psums the full (6K)^2 reduced
system every GN step — fine for sliding windows, quadratic in keyframes
for big maps. This solver never materializes S: each device keeps its
landmark shard's Schur building blocks (Hpp/Hpl/Hll_inv partials,
ba/gauss_newton.py:build_blocks) and the reduced system is solved by
preconditioned conjugate gradients where one S@v product is

    local:  u = Hpp_loc v  -  Hpl (Hll^-1 (Hpl^T v))     [batched einsums]
    comm:   Sv = psum(u, "d")                            [6K floats]

so per-CG-iteration communication is O(6K) on the interconnect instead of
O((6K)^2) per GN step — the long-sequence/many-keyframe scaling shape
promised in SURVEY.md §2.3 (ring-reduction of per-block Hessians; XLA
lowers the psum to a ring reduce-scatter + all-gather over the interconnect).

Preconditioner: block-Jacobi with the exact 6x6 diagonal blocks of S
(one (K,6,6) psum per GN step). Gauge fixing, Levenberg damping, floor,
and the monocular scale-anchor prior are applied post-psum (replicated),
matching build_reduced_system's dense construction bit-for-bit in
operator form.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from visma_tpu.ba.gauss_newton import (_apply, backsub_landmarks,
                                       build_blocks, total_cost)
from visma_tpu.ba.problem import BaProblem
from visma_tpu.dist.sharded_ba import _baseline, _shard_problem

_GAUGE_W = 1e6


def _schur_pieces(prob_shard: BaProblem, damping, scale_weight,
                  anchor=None):
    """Everything one GN step needs, built from the local landmark shard.

    Returns (matvec, Minv (K,6,6), b (6K,), aux) where matvec is the
    replicated-in/replicated-out S@v operator (contains one psum)."""
    K = prob_shard.num_poses
    Hpp, bp, Hll_inv, Hpl, bl = build_blocks(prob_shard, damping)

    T1 = jnp.einsum("lkij,ljm->lkim", Hpl, Hll_inv)          # (L,K,6,3)

    # exact diagonal blocks of S: D_k = Hpp_k - sum_l T1_lk Hpl_lk^T
    D_local = Hpp - jnp.einsum("lkim,lkjm->kij", T1, Hpl)    # (K,6,6)
    D = jax.lax.psum(D_local, "d")

    # rhs
    b_local = bp - jnp.einsum("lkim,lm->ki", T1, bl)         # (K,6)
    b = jax.lax.psum(b_local, "d").reshape(-1)

    # replicated extras: damping * diag, floor, gauge, scale prior
    diagS = jax.vmap(jnp.diag)(D).reshape(-1)                # (6K,)
    floor = 1e-6 * jnp.max(jnp.abs(diagS)) + 1e-8
    gauge = jnp.arange(6 * K) < 6
    notg = ~gauge

    # scale-anchor prior on the last pose's position rows (same
    # construction as build_reduced_system); anchor=None holds the
    # current baseline
    if anchor is None:
        anchor = _baseline(prob_shard)
    dvec = prob_shard.p[K - 1] - prob_shard.p[0]
    dn = jnp.maximum(jnp.linalg.norm(dvec), 1e-9)
    e = dvec / dn
    base = 6 * (K - 1) + 3

    b = jnp.where(gauge, 0.0, b)
    b = b.at[base : base + 3].add(scale_weight * e * (anchor - dn))

    add_diag = damping * diagS + floor                        # (6K,)

    def matvec(v):
        """S @ v with gauge rows/cols pinned to _GAUGE_W * I."""
        vm = jnp.where(notg, v, 0.0)
        vk = vm.reshape(K, 6)
        u = jnp.einsum("kij,kj->ki", Hpp, vk)
        a = jnp.einsum("lkij,ki->lj", Hpl, vk)               # (L,3)
        c = jnp.einsum("lij,lj->li", Hll_inv, a)
        u = u - jnp.einsum("lkij,lj->ki", Hpl, c)
        Sv = jax.lax.psum(u, "d").reshape(-1)
        Sv = Sv + add_diag * vm
        Sv = Sv.at[base : base + 3].add(
            scale_weight * e * jnp.dot(e, vm[base : base + 3]))
        Sv = jnp.where(notg, Sv, 0.0)                        # gauge cols
        return jnp.where(gauge, _GAUGE_W * v, Sv)            # gauge rows

    # block-Jacobi preconditioner with the same extras folded in
    Dd = D + jax.vmap(jnp.diag)((damping * jax.vmap(jnp.diag)(D))
                                + floor * jnp.ones((K, 6)))
    Dd = Dd.at[K - 1, 3:, 3:].add(scale_weight * jnp.outer(e, e))
    Dd = Dd.at[0].set(jnp.eye(6) * _GAUGE_W)                 # gauge block
    Minv = jnp.linalg.inv(Dd)                                # (K,6,6)
    return matvec, Minv, b, (Hll_inv, Hpl, bl)


def _pcg(matvec, Minv, b, iters: int):
    """Fixed-iteration preconditioned CG (replicated vectors; the only
    communication is the psum inside matvec). Returns (x, |r| history)."""
    K6 = b.shape[0]

    def precond(r):
        return jnp.einsum("kij,kj->ki", Minv, r.reshape(-1, 6)).reshape(-1)

    x0 = jnp.zeros(K6, b.dtype)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.dot(r0, z0)

    def body(carry, _):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        return (x, r, p, rz_new), jnp.linalg.norm(r)

    (x, r, _, _), hist = jax.lax.scan(body, (x0, r0, p0, rz0), None,
                                      length=iters)
    return x, hist


def _pcg_step(mesh: Mesh, cg_iters: int):
    """Build the shard_map'd matrix-free GN step for a mesh."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(BaProblem(R=P(), p=P(), X=P("d"), obs=P("d"),
                            mask=P("d"), intr=P()), P(), P()),
        out_specs=(BaProblem(R=P(), p=P(), X=P("d"), obs=P("d"),
                             mask=P("d"), intr=P()), P()),
    )
    def step(prob_shard: BaProblem, damping, anchor):
        with jax.default_matmul_precision("highest"):
            matvec, Minv, b, aux = _schur_pieces(prob_shard, damping,
                                                 scale_weight=1e6,
                                                 anchor=anchor)
            dxp, _hist = _pcg(matvec, Minv, b, cg_iters)
            dxl = backsub_landmarks(aux, dxp)
            new = _apply(prob_shard, dxp, dxl)
            cost = jax.lax.psum(total_cost(new), "d")
            return new, cost

    return step


@functools.lru_cache(maxsize=16)
def _jitted_pcg_solver(mesh: Mesh, iters: int, cg_iters: int):
    step = _pcg_step(mesh, cg_iters)

    @jax.jit
    def run(p0, lam0):
        anchor = _baseline(p0)

        def body(carry, _):
            cur, lam, cost = carry
            cand, cand_cost = step(cur, lam, anchor)
            better = cand_cost < cost
            nxt = jax.tree.map(lambda a, b: jnp.where(better, a, b),
                               cand, cur)
            lam_new = jnp.where(better, jnp.maximum(lam * 0.5, 1e-6),
                                jnp.minimum(lam * 4.0, 1e2))
            return (nxt, lam_new, jnp.where(better, cand_cost, cost)), cost

        c0 = total_cost(p0)
        (sol, _, _), hist = jax.lax.scan(body, (p0, lam0, c0), None,
                                         length=iters)
        return sol, hist

    return run


def pcg_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                 cg_iters: int = 25, damping: float = 1e-3
                 ) -> Tuple[BaProblem, jnp.ndarray]:
    """Distributed LM loop with the matrix-free PCG inner solver.

    Same acceptance logic and gauge/prior construction as
    sharded_ba_solve; communication per GN step is one (K,6,6) + one
    (K,6) psum plus cg_iters (K,6) psums — O(K) not O(K^2)."""
    padded, L = _shard_problem(prob, mesh)
    sol, hist = _jitted_pcg_solver(mesh, iters, cg_iters)(
        padded, jnp.asarray(damping, jnp.float32))
    return BaProblem(R=sol.R, p=sol.p, X=sol.X[:L], obs=sol.obs[:L],
                     mask=sol.mask[:L], intr=sol.intr), hist
