"""The on-card smoke script's contract, checked where there is no card:
its last line, its refusal to run without a GPU or without the repo, and
where it keeps the compile cache. bench.py refuses a CPU the same way."""
import json
import os
import shutil
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=120)


def _prints_no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_last_line_format():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_exits_nonzero_on_cpu():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert _prints_no_result(proc)
    assert "no GPU" in proc.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert _prints_no_result(proc)


def test_compile_cache_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert chip_smoke.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chip_smoke.compile_cache_dir() == str(tmp_path)


def test_bench_refuses_cpu():
    proc = _run(["bench.py"], REPO)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr
