"""Edge-likelihood tests: distance transform correctness + hypothesis
scoring ranks the true pose best."""
import numpy as np
import jax.numpy as jnp
import pytest

from visma_tpu.render import Intrinsics, Renderer
from visma_tpu.render.likelihood import (chamfer_score,
                                         edge_distance_transform,
                                         score_hypotheses)


class TestDistanceTransform:
    def test_exact_against_scipy(self):
        import scipy.ndimage as ndi

        rng = np.random.default_rng(0)
        edges = (rng.random((48, 64)) > 0.97).astype(np.float32)
        edges[10, 20] = 1.0  # ensure nonempty
        dt = np.asarray(edge_distance_transform(jnp.asarray(edges),
                                                iters=64))
        ref = ndi.distance_transform_edt(edges < 0.5)
        # chamfer 8-neighborhood approximates Euclidean within ~8%
        mask = ref < 30
        err = np.abs(dt - ref)[mask]
        assert np.median(err) < 0.3
        assert (err / np.maximum(ref[mask], 1.0)).max() < 0.09

    def test_zero_at_edges(self):
        edges = np.zeros((16, 16), np.float32)
        edges[8, 8] = 1.0
        dt = np.asarray(edge_distance_transform(jnp.asarray(edges)))
        assert dt[8, 8] == 0.0
        assert abs(dt[8, 12] - 4.0) < 0.2


class TestChamferScore:
    def test_perfect_overlap_scores_zero(self):
        e = np.zeros((32, 32), np.float32)
        e[10:20, 15] = 1.0
        dt = edge_distance_transform(jnp.asarray(e))
        s = float(chamfer_score(jnp.asarray(e), dt))
        assert s < 0.01

    def test_offset_scores_distance(self):
        e = np.zeros((32, 32), np.float32)
        e[:, 10] = 1.0
        shifted = np.roll(e, 5, axis=1)
        dt = edge_distance_transform(jnp.asarray(e))
        s = float(chamfer_score(jnp.asarray(shifted), dt))
        assert abs(s - 5.0) < 0.3

    def test_empty_render_maximally_bad(self):
        e = np.zeros((32, 32), np.float32)
        e[:, 10] = 1.0
        dt = edge_distance_transform(jnp.asarray(e))
        s = float(chamfer_score(jnp.zeros((32, 32)), dt, tau=10.0))
        assert s == 10.0


class TestHypothesisScoring:
    def test_true_pose_wins(self):
        """Render an object at a true pose; the scoring over a hypothesis
        sweep must rank the true pose (or its immediate neighbor) best."""
        intr = Intrinsics(fx=120.0, fy=120.0, cx=63.5, cy=47.5, rows=96,
                          cols=128, z_near=0.05, z_far=10.0)
        r = Renderer(intr)
        # asymmetric mesh: an L of two boxes
        from tests.test_render import icosphere

        V, F = icosphere(1, 0.4)
        V = np.concatenate([V, V * 0.5 + np.array([0.5, 0, 0], np.float32)])
        F = np.concatenate([F, F + len(V) // 2])
        r.set_mesh(V + np.array([0, 0, 2.0], np.float32), F)

        true_pose = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
        observed = np.asarray(r.render_edge(jnp.asarray(true_pose)))

        # hypothesis sweep: lateral offsets
        hyps = []
        offsets = np.linspace(-0.3, 0.3, 13)
        for dx in offsets:
            h = true_pose.copy()
            h[0, 3] = dx
            hyps.append(h)
        scores = np.asarray(score_hypotheses(
            r, jnp.asarray(np.stack(hyps)), jnp.asarray(observed)))
        best = int(np.argmin(scores))
        assert abs(offsets[best]) < 0.06, (best, scores.round(2))
        # score grows with offset magnitude (monotone-ish envelope)
        assert scores[0] > scores[best] and scores[-1] > scores[best]
