"""The port's zygote (ray_lightning_tpu_torch/runtime/zygote.py,
runtime/api.py's ``create_actors(zygote=True)`` and ``TORCHRT_ZYGOTE=1``)
on the CPU, as tests/test_zygote.py drives the JAX one: a forked spawn is
fast and isolated, with its environment applied after the fork and
``torch.set_num_threads`` taken from its ``OMP_NUM_THREADS``; a
constructor's error surfaces as ``ActorError``. Beyond it: the zygote never
initializes CUDA and refuses to fork once it has; no child, and not the
zygote, outlives the process that created them, checked by pid after that
process is SIGKILLed."""
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.runtime import zygote
from ray_lightning_tpu_torch.runtime.api import pid_exited

from torch_ray_helpers import Boom, Probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _runtime():
    yield
    rt.shutdown()


def _gone(pids, within=10.0):
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        if all(pid_exited(p) for p in pids):
            return True
        time.sleep(0.05)
    return all(pid_exited(p) for p in pids)


def test_zygote_spawn_fast_and_isolated(monkeypatch):
    monkeypatch.setenv(rt.api.ZYGOTE_ENV, "1")
    rt.init(num_cpus=4)
    status = rt.warm_zygote().status()
    a = rt.create_actor(Probe, args=(5,), env={"OMP_NUM_THREADS": "3",
                                               "TORCHRT_PROBE": "a"},
                        timeout=TIMEOUT)
    t0 = time.perf_counter()
    b = rt.create_actor(Probe, args=(100,), env={"OMP_NUM_THREADS": "1"},
                        timeout=TIMEOUT)
    fork_spawn = time.perf_counter() - t0
    assert fork_spawn < 5.0, f"fork spawn took {fork_spawn:.1f}s"
    assert a.incr.remote(3).result(timeout=TIMEOUT) == 8
    assert b.incr.remote().result(timeout=TIMEOUT) == 101
    fa = a.facts.remote("TORCHRT_PROBE").result(timeout=TIMEOUT)
    fb = b.facts.remote("TORCHRT_PROBE").result(timeout=TIMEOUT)
    assert len({fa["pid"], fb["pid"], os.getpid(), status["pid"]}) == 4
    # forked from the zygote, not spawned by this process
    assert fa["ppid"] == fb["ppid"] == status["pid"]
    assert (fa["env"], fb["env"]) == ("a", None)
    assert (fa["threads"], fb["threads"]) == (3, 1)
    assert a._pid == fa["pid"]
    rt.kill(a)
    rt.kill(b)
    assert _gone([fa["pid"], fb["pid"]])
    assert not pid_exited(status["pid"])  # the zygote serves on


def test_zygote_construction_error_surfaces(monkeypatch):
    monkeypatch.setenv(rt.api.ZYGOTE_ENV, "1")
    rt.init(num_cpus=2)
    with pytest.raises(rt.ActorError, match="kaboom"):
        rt.create_actor(Boom, timeout=TIMEOUT)
    # the zygote survives a child's failure and spawns again
    ok = rt.create_actors([(Probe, (), {})], zygote=True, timeout=TIMEOUT)[0]
    assert ok.incr.remote().result(timeout=TIMEOUT) == 1


def test_zygote_never_initializes_cuda(monkeypatch):
    rt.init(num_cpus=2)
    status = rt.warm_zygote().status()
    assert status == {"pid": status["pid"], "cuda_initialized": False,
                      "python_threads": 1}
    # a zygote that had initialized CUDA, or ran a second thread, refuses
    # to fork: the child could not use the card, or a lock might be held
    monkeypatch.setattr(zygote.threading, "active_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert "initialized CUDA" in zygote._fork_check()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert zygote._fork_check() is None
    monkeypatch.setattr(zygote.threading, "active_count", lambda: 2)
    assert "2 Python threads" in zygote._fork_check()


CREATOR = """
import sys, time
from ray_lightning_tpu_torch import runtime as rt
sys.path.insert(0, {tests!r})
from torch_ray_helpers import Probe
rt.init(num_cpus=2)
z = rt.warm_zygote()
(a,) = rt.create_actors([(Probe, (), {{}})], zygote=True, timeout=60)
print(z.pid, a._pid, flush=True)
time.sleep(600)
"""


def test_no_child_outlives_its_creator():
    """The creator is SIGKILLed (no atexit, no shutdown): its zygote sees
    the connection close and exits, and the zygote's child dies with it."""
    proc = subprocess.Popen(
        [sys.executable, "-c", CREATOR.format(tests=os.path.dirname(
            os.path.abspath(__file__)))],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        zygote_pid, child_pid = map(int, proc.stdout.readline().split())
        assert not pid_exited(zygote_pid) and not pid_exited(child_pid)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert _gone([zygote_pid, child_pid]), (zygote_pid, child_pid)
