"""Procedural real-scale bench meshes (io/procedural.py)."""
import numpy as np

from visma_tpu.io.procedural import (bench_mesh_db, box_mesh, cylinder_mesh,
                                     desk_mesh, merge_meshes,
                                     office_chair_mesh)


def test_box_mesh_counts_and_bounds():
    V, F = box_mesh(0.4, 0.8, 0.2, subdiv=3, center=(1.0, 2.0, 3.0))
    assert F.shape == (12 * 9, 3)
    assert F.min() >= 0 and F.max() < len(V)
    lo, hi = V.min(0), V.max(0)
    np.testing.assert_allclose(hi - lo, [0.4, 0.8, 0.2], atol=1e-6)
    np.testing.assert_allclose((hi + lo) / 2, [1.0, 2.0, 3.0], atol=1e-6)


def test_cylinder_mesh_counts():
    seg, stacks = 12, 3
    V, F = cylinder_mesh(0.1, 0.5, segments=seg, stacks=stacks)
    assert F.shape == (2 * seg * stacks + 2 * seg, 3)
    assert F.max() < len(V)
    r = np.hypot(V[:, 0], V[:, 2])
    assert r.max() <= 0.1 + 1e-6
    assert abs(V[:, 1]).max() <= 0.25 + 1e-6


def test_merge_reindexes():
    a = box_mesh(0.1, 0.1, 0.1, subdiv=1)
    b = box_mesh(0.2, 0.2, 0.2, subdiv=2, center=(1, 0, 0))
    V, F = merge_meshes([a, b])
    assert len(V) == len(a[0]) + len(b[0])
    assert len(F) == len(a[1]) + len(b[1])
    assert F.max() == len(V) - 1 or F.max() < len(V)


def test_bench_meshes_are_real_scale_and_5k_faces():
    """The semantic bench substrate: >=5k faces (the aeron's class) and
    furniture-scale extents."""
    for name, (V, F) in (("desk", desk_mesh()),
                         ("chair", office_chair_mesh())):
        assert len(F) >= 5000, (name, len(F))
        ext = V.max(0) - V.min(0)
        assert 0.4 < ext.max() < 1.5, (name, ext)
        assert F.min() >= 0 and F.max() < len(V)
        assert V.dtype == np.float32 and F.dtype == np.int32


def test_bench_db_loads():
    db = bench_mesh_db()
    assert set(db) == {"chair", "desk"}
    for V, F in db.values():
        assert len(F) >= 4999
