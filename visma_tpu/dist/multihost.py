"""Multi-host orchestration helpers.

Each process calls `initialize()` once before any jax op
(jax.distributed handles the rendezvous; collectives then span every
process's devices). On a host with several GPUs, each process takes only
the cards LOCAL_DEVICE_IDS names, so processes do not all claim every card.
Failure detection / recovery follows SURVEY §5: workers checkpoint every K
steps (visma_tpu.utils.checkpoint) and touch a Heartbeat file; a Watchdog
supervises the worker process, detects death or a stale heartbeat, and
restarts it — the worker resumes from its latest snapshot
(checkpoint-restart recovery). Exercised as a real kill-and-recover drill
in tests/test_multihost.py.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Optional, Sequence

import jax


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """jax.distributed.initialize with env-var defaults
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID, and LOCAL_DEVICE_IDS
    as a comma-separated list such as "0" or "2,3"). No-op when
    single-process."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    if local_device_ids is None and os.environ.get("LOCAL_DEVICE_IDS"):
        local_device_ids = [int(x) for x in
                            os.environ["LOCAL_DEVICE_IDS"].split(",")]
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or int(os.environ["NUM_PROCESSES"]),
        process_id=process_id, local_device_ids=local_device_ids)


class Heartbeat:
    """Minimal liveness file for external monitors: touch() from the train
    loop, stale() from a watchdog."""

    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def touch(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as fp:
                fp.write(f"{step} {now}\n")
            self._last = now

    def stale(self, timeout_s: float = 120.0) -> bool:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return True
        return (time.time() - mtime) > timeout_s


class Watchdog:
    """Supervise a worker process; restart it from its latest checkpoint on
    death or heartbeat staleness.

    spawn: callable returning a started subprocess.Popen — it must launch
    the worker in RESUME mode (the worker itself loads the latest snapshot
    via visma_tpu.utils.checkpoint.latest_step/load_state, so a restart
    after any failure continues instead of recomputing).
    """

    def __init__(self, spawn: Callable[[], subprocess.Popen],
                 heartbeat_path: str, stale_timeout_s: float = 120.0,
                 poll_s: float = 2.0, max_restarts: int = 3):
        self.spawn = spawn
        self.hb = Heartbeat(heartbeat_path)
        self.stale_timeout_s = stale_timeout_s
        self.poll_s = poll_s
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self) -> int:
        """Run the worker to successful completion, restarting on failure.
        Returns the number of restarts performed; raises RuntimeError when
        max_restarts is exhausted."""
        proc = self.spawn()
        spawned = time.time()
        while True:
            rc = proc.poll()
            if rc == 0:
                return self.restarts
            failed = rc is not None          # crashed / killed
            # staleness is measured from the last heartbeat OR the spawn,
            # whichever is later: a fresh worker gets a full timeout of
            # startup grace before it must have touched the file
            grace = (time.time() - spawned) <= self.stale_timeout_s
            if not failed and not grace and self.hb.stale(
                    self.stale_timeout_s):
                # hung: kill the EXACT pid we spawned (never a pattern)
                proc.kill()
                proc.wait()
                failed = True
            if failed:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"worker failed {self.restarts} times; giving up")
                proc = self.spawn()
                spawned = time.time()
            time.sleep(self.poll_s)
