"""One process of the multi-process jax.distributed BA test.

Launched by tests/test_multihost.py as N real OS processes; each
contributes its virtual CPU devices (XLA_FLAGS in the parent's env) to a
GLOBAL mesh via the jax.distributed rendezvous, then all processes
jointly run the landmark-sharded BA solve (SPMD: identical program, each
holding only its addressable shards).

argv: process_id num_processes coordinator_address out_npz
"""
import sys


def main():
    pid, n = int(sys.argv[1]), int(sys.argv[2])
    coord, out = sys.argv[3], sys.argv[4]

    import jax

    # virtual CPU devices only, set before any backend initializes
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n, process_id=pid)
    assert jax.process_count() == n, jax.process_count()

    import numpy as np

    from visma_tpu.ba.problem import synthetic_ba_problem
    from visma_tpu.dist import make_mesh
    from visma_tpu.dist.sharded_ba import sharded_ba_solve

    prob, _ = synthetic_ba_problem(num_poses=8, num_landmarks=64,
                                   noise_px=0.5, pose_noise=0.02)
    mesh = make_mesh()  # all GLOBAL devices (spans both processes)
    n_global = mesh.devices.size
    sol, hist = sharded_ba_solve(prob, mesh, iters=5)

    # poses + cost history are replicated outputs -> addressable everywhere
    np.savez(out, p=np.asarray(sol.p), R=np.asarray(sol.R),
             hist=np.asarray(hist), n_global_devices=n_global,
             process_count=jax.process_count())
    print(f"worker {pid}: {n_global} global devices, "
          f"final cost {float(hist[-1]):.6f}")


if __name__ == "__main__":
    main()
