"""Multi-process distributed tests.

1. REAL process boundaries: N OS processes rendezvous through
   jax.distributed (DCN analog: localhost gRPC coordinator), form one
   GLOBAL device mesh from their per-process virtual CPU devices, and
   jointly solve the landmark-sharded BA — exercising cross-process
   collectives and per-process data feeding, which the single-process
   8-virtual-device mesh cannot.

2. Fault drill: a checkpointing worker is SIGKILLed mid-run; the Watchdog
   detects the death and respawns it; the worker resumes from its latest
   snapshot; the final state must equal an uninterrupted run's.
"""
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

WORKERS = pathlib.Path(__file__).parent / "workers"
REPO = pathlib.Path(__file__).parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(n_local_devices: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{n_local_devices}")
    env["JAX_PLATFORMS"] = "cpu"
    # workers must import visma_tpu even when the package is not
    # pip-installed (sys.path[0] of a script is ITS directory, not cwd)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # don't inherit the test process's persistent-cache lock contention
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


class TestMultiProcess:
    N_PROC = 2
    DEV_PER_PROC = 2

    def test_two_process_distributed_ba(self, tmp_path):
        coord = f"127.0.0.1:{_free_port()}"
        outs = [tmp_path / f"out_{i}.npz" for i in range(self.N_PROC)]
        procs = [
            subprocess.Popen(
                [sys.executable, str(WORKERS / "mp_ba_worker.py"),
                 str(i), str(self.N_PROC), coord, str(outs[i])],
                env=_worker_env(self.DEV_PER_PROC), cwd=str(REPO),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(self.N_PROC)
        ]
        deadline = time.time() + 300
        for p in procs:
            timeout = max(5.0, deadline - time.time())
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()  # exact PIDs we spawned
                pytest.fail("multi-process BA timed out")
            assert p.returncode == 0, out.decode()

        res = [np.load(o) for o in outs]
        # the global mesh really spanned both processes
        for r in res:
            assert int(r["process_count"]) == self.N_PROC
            assert int(r["n_global_devices"]) == \
                self.N_PROC * self.DEV_PER_PROC
        # replicated outputs must be IDENTICAL across processes
        np.testing.assert_array_equal(res[0]["p"], res[1]["p"])
        np.testing.assert_array_equal(res[0]["hist"], res[1]["hist"])

        # and must match the single-process solve of the same problem
        from visma_tpu.ba.problem import synthetic_ba_problem
        from visma_tpu.dist import make_mesh
        from visma_tpu.dist.sharded_ba import sharded_ba_solve

        prob, _ = synthetic_ba_problem(num_poses=8, num_landmarks=64,
                                       noise_px=0.5, pose_noise=0.02)
        sol, hist = sharded_ba_solve(prob, make_mesh(4), iters=5)
        np.testing.assert_allclose(res[0]["p"], np.asarray(sol.p),
                                   atol=5e-4)
        np.testing.assert_allclose(res[0]["hist"][-1],
                                   np.asarray(hist)[-1], rtol=1e-4)


class TestFaultDrill:
    TOTAL_STEPS = 6

    def _spawn(self, workdir, sleep_s):
        return subprocess.Popen(
            [sys.executable, str(WORKERS / "fault_worker.py"),
             str(workdir), str(self.TOTAL_STEPS), str(sleep_s)],
            env=_worker_env(4), cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def test_kill_and_recover_equals_uninterrupted(self, tmp_path):
        from visma_tpu.dist.multihost import Watchdog

        # --- uninterrupted oracle run -----------------------------------
        clean = tmp_path / "clean"
        clean.mkdir()
        p = self._spawn(clean, 0.0)
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()
        ref = np.load(clean / "final.npz")

        # --- killed + watchdog-recovered run ----------------------------
        drill = tmp_path / "drill"
        drill.mkdir()
        ckpt_latest = drill / "ckpt" / "latest.json"

        victim = self._spawn(drill, 0.3)
        # wait until at least 2 checkpoints exist, then SIGKILL (exact pid)
        deadline = time.time() + 120
        while time.time() < deadline:
            if ckpt_latest.exists():
                import json

                if json.loads(ckpt_latest.read_text())["step"] >= 2:
                    break
            time.sleep(0.1)
        else:
            victim.kill()
            pytest.fail("worker produced no checkpoints")
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait()
        assert victim.returncode != 0
        assert not (drill / "final.npz").exists()

        wd = Watchdog(lambda: self._spawn(drill, 0.0),
                      heartbeat_path=str(drill / "heartbeat"),
                      stale_timeout_s=60.0, poll_s=0.5, max_restarts=2)
        restarts = wd.run()
        # the watchdog spawned the resume worker (restarts counts only
        # failures DURING its supervision; the pre-kill is external)
        assert restarts == 0
        got = np.load(drill / "final.npz")

        # recovery must reproduce the uninterrupted run exactly: the
        # checkpoint carries the full BaProblem and the steps are
        # deterministic
        np.testing.assert_allclose(got["p"], ref["p"], atol=1e-6)
        np.testing.assert_allclose(got["X"], ref["X"], atol=1e-6)

    def test_watchdog_restarts_crashing_worker(self, tmp_path):
        """A worker that dies twice then succeeds: the Watchdog must keep
        restarting until completion and report the restart count."""
        from visma_tpu.dist.multihost import Watchdog

        marker = tmp_path / "crashes"
        script = tmp_path / "flaky.py"
        script.write_text(
            "import pathlib, sys\n"
            "m = pathlib.Path(sys.argv[1])\n"
            "n = int(m.read_text()) if m.exists() else 0\n"
            "m.write_text(str(n + 1))\n"
            "sys.exit(1 if n < 2 else 0)\n")
        hb = tmp_path / "hb"
        hb.write_text("0 0\n")

        def spawn():
            hb.touch()
            return subprocess.Popen([sys.executable, str(script),
                                     str(marker)])

        wd = Watchdog(spawn, heartbeat_path=str(hb), stale_timeout_s=60.0,
                      poll_s=0.05, max_restarts=5)
        assert wd.run() == 2
        assert marker.read_text() == "3"

    def test_watchdog_gives_up(self, tmp_path):
        from visma_tpu.dist.multihost import Watchdog

        hb = tmp_path / "hb"
        hb.write_text("0 0\n")

        def spawn():
            hb.touch()
            return subprocess.Popen([sys.executable, "-c",
                                     "import sys; sys.exit(3)"],
                                    env={**os.environ, "PYTHONPATH": ""})

        wd = Watchdog(spawn, heartbeat_path=str(hb), stale_timeout_s=60.0,
                      poll_s=0.05, max_restarts=2)
        with pytest.raises(RuntimeError, match="giving up"):
            wd.run()

    def test_watchdog_kills_hung_worker(self, tmp_path):
        """Alive-but-hung worker (stale heartbeat): the Watchdog must kill
        the exact PID and respawn."""
        from visma_tpu.dist.multihost import Watchdog

        attempt = tmp_path / "attempt"
        script = tmp_path / "hangy.py"
        script.write_text(
            "import pathlib, sys, time\n"
            "m = pathlib.Path(sys.argv[1])\n"
            "hb = pathlib.Path(sys.argv[2])\n"
            "n = int(m.read_text()) if m.exists() else 0\n"
            "m.write_text(str(n + 1))\n"
            "hb.write_text('alive')\n"
            "if n == 0:\n"
            "    time.sleep(600)  # hang; heartbeat goes stale\n"
            "sys.exit(0)\n")
        hb = tmp_path / "hb"

        def spawn():
            return subprocess.Popen([sys.executable, str(script),
                                     str(attempt), str(hb)],
                                    env={**os.environ, "PYTHONPATH": ""})

        wd = Watchdog(spawn, heartbeat_path=str(hb), stale_timeout_s=1.0,
                      poll_s=0.2, max_restarts=2)
        t0 = time.time()
        assert wd.run() == 1
        assert time.time() - t0 < 30
        assert attempt.read_text() == "2"


class TestInitialize:
    """initialize() reads its rendezvous from the environment and gives
    each process only the devices LOCAL_DEVICE_IDS names (one process
    per GPU on a multi-GPU host)."""

    def _capture(self, monkeypatch):
        import jax

        calls = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        return calls

    def test_local_device_ids_from_env(self, monkeypatch):
        from visma_tpu.dist.multihost import initialize

        calls = self._capture(monkeypatch)
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("NUM_PROCESSES", "4")
        monkeypatch.setenv("PROCESS_ID", "0")
        monkeypatch.setenv("LOCAL_DEVICE_IDS", "2,3")
        initialize()
        assert calls == [{"coordinator_address": "localhost:1234",
                          "num_processes": 4, "process_id": 0,
                          "local_device_ids": [2, 3]}]

    def test_single_process_is_a_noop(self, monkeypatch):
        from visma_tpu.dist.multihost import initialize

        calls = self._capture(monkeypatch)
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        initialize()
        assert calls == []
