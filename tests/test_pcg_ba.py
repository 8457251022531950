"""Matrix-free distributed PCG Schur solver (dist/pcg_ba.py).

The operator form must match the dense construction
(ba/gauss_newton.py:build_reduced_system) exactly; the solver must reach
the same optimum as the dense sharded solver on the 8-virtual-device mesh.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from visma_tpu.ba.gauss_newton import ba_solve, build_reduced_system
from visma_tpu.ba.problem import BaProblem, synthetic_ba_problem
from visma_tpu.dist import make_mesh
from visma_tpu.dist.pcg_ba import _schur_pieces, pcg_ba_solve
from visma_tpu.dist.sharded_ba import _shard_problem, sharded_ba_solve


class TestMatvecParity:
    def test_matvec_matches_dense(self):
        """psum'd matrix-free S@v == dense S @ v for random v (incl. the
        gauge pinning, damping, floor, and scale-anchor prior)."""
        assert jax.device_count() >= 8
        prob, _ = synthetic_ba_problem(num_poses=6, num_landmarks=64,
                                       noise_px=0.5, pose_noise=0.02)
        damping = 1e-3
        mesh = make_mesh(8)
        padded, L = _shard_problem(prob, mesh)

        rng = np.random.default_rng(0)
        V = jnp.asarray(rng.standard_normal((5, 36)), jnp.float32)

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(BaProblem(R=P(), p=P(), X=P("d"), obs=P("d"),
                                mask=P("d"), intr=P()), P()),
            out_specs=(P(), P()),
        )
        def harness(shard, vs):
            with jax.default_matmul_precision("highest"):
                matvec, _, b, _ = _schur_pieces(shard, damping, 1e6)
                return jax.vmap(matvec)(vs), b

        Sv, b_pcg = jax.jit(harness)(padded, V)

        with jax.default_matmul_precision("highest"):
            anchor = jnp.linalg.norm(prob.p[-1] - prob.p[0])
            S, b, _ = build_reduced_system(prob, damping,
                                           scale_anchor=anchor,
                                           scale_weight=1e6)
            Sv_dense = jnp.einsum("ij,vj->vi", S, V)

        scale = np.abs(np.asarray(Sv_dense)).max()
        np.testing.assert_allclose(np.asarray(Sv), np.asarray(Sv_dense),
                                   atol=2e-5 * scale)
        np.testing.assert_allclose(np.asarray(b_pcg), np.asarray(b),
                                   atol=2e-5 * max(1.0,
                                                   np.abs(b).max()))


class TestPcgSolve:
    def test_matches_dense_solvers(self):
        prob, truth = synthetic_ba_problem(num_poses=8, num_landmarks=96,
                                           noise_px=0.5, pose_noise=0.03)
        mesh = make_mesh(8)
        sol_p, hist_p = pcg_ba_solve(prob, mesh, iters=10, cg_iters=30)
        sol_d, _ = sharded_ba_solve(prob, mesh, iters=10)
        np.testing.assert_allclose(np.asarray(sol_p.p), np.asarray(sol_d.p),
                                   atol=5e-3)

        from visma_tpu.align import umeyama

        T = np.asarray(umeyama(jnp.asarray(np.asarray(sol_p.p)),
                               jnp.asarray(truth["p"].astype(np.float32)),
                               with_scaling=True))
        p_al = np.asarray(sol_p.p) @ T[:3, :3].T + T[:3, 3]
        assert np.linalg.norm(p_al - truth["p"], axis=1).max() < 0.01
        # cost history decreases
        h = np.asarray(hist_p)
        assert h[-1] <= h[0]

    def test_landmark_padding(self):
        prob, _ = synthetic_ba_problem(num_poses=6, num_landmarks=50)
        mesh = make_mesh(8)
        sol, hist = pcg_ba_solve(prob, mesh, iters=3, cg_iters=20)
        assert sol.X.shape == prob.X.shape
        assert np.isfinite(np.asarray(hist)).all()


class TestSolverDispatch:
    """sharded_ba_solve's `solver` flag wires the matrix-free PCG path into
    the system."""

    def test_flag_selects_equal_solutions(self):
        prob, _ = synthetic_ba_problem(num_poses=8, num_landmarks=96,
                                       noise_px=0.5, pose_noise=0.03)
        mesh = make_mesh(8)
        sol_d, _ = sharded_ba_solve(prob, mesh, iters=8, solver="dense")
        sol_p, _ = sharded_ba_solve(prob, mesh, iters=8, solver="pcg",
                                    cg_iters=30)
        np.testing.assert_allclose(np.asarray(sol_p.p), np.asarray(sol_d.p),
                                   atol=5e-3)
        np.testing.assert_allclose(np.asarray(sol_p.R), np.asarray(sol_d.R),
                                   atol=5e-3)

    def test_auto_crossover(self, monkeypatch):
        """auto = dense below the crossover, pcg above it."""
        import visma_tpu.dist.sharded_ba as sba

        calls = []
        monkeypatch.setattr(
            "visma_tpu.dist.pcg_ba.pcg_ba_solve",
            lambda prob, mesh, **kw: calls.append("pcg") or (prob, None))
        monkeypatch.setattr(
            sba, "_jitted_solver",
            lambda mesh, iters: lambda p, lam: calls.append("dense")
            or (p, None))

        small, _ = synthetic_ba_problem(num_poses=6, num_landmarks=32)
        big, _ = synthetic_ba_problem(num_poses=sba.PCG_CROSSOVER_K + 1,
                                      num_landmarks=32)
        mesh = make_mesh(8)
        sharded_ba_solve(small, mesh, iters=1, solver="auto")
        sharded_ba_solve(big, mesh, iters=1, solver="auto")
        assert calls == ["dense", "pcg"]

    def test_submap_polish_pcg(self):
        from visma_tpu.dist.submap_ba import submap_ba_solve

        prob, truth = synthetic_ba_problem(num_poses=16, num_landmarks=128,
                                           noise_px=0.5, pose_noise=0.02)
        mesh = make_mesh(8)
        sol, _ = submap_ba_solve(prob, mesh, iters=6, polish_iters=3,
                                 polish_solver="pcg")
        from visma_tpu.align import umeyama

        T = np.asarray(umeyama(jnp.asarray(np.asarray(sol.p)),
                               jnp.asarray(truth["p"].astype(np.float32)),
                               with_scaling=True))
        p_al = np.asarray(sol.p) @ T[:3, :3].T + T[:3, 3]
        assert np.linalg.norm(p_al - truth["p"], axis=1).max() < 0.02
