"""The fleet's pure policy in the port (ray_lightning_tpu_torch/serving/
replica.py: ``pick_least_loaded``, ``autoscale_decision``,
``needs_relaunch``, the ``Autoscaler`` and the load tap), held against the
JAX package's on the same inputs: the same verdicts, and an Autoscaler over
one fake fleet in each package, fed the same load sequence, gives the same
deltas, history, outcomes and capacity-blocked streaks."""
import itertools

import pytest

from ray_lightning_tpu.observability import metrics as jmetrics
from ray_lightning_tpu.serving import replica as jax_replica
from ray_lightning_tpu_torch.observability import metrics as pmetrics
from ray_lightning_tpu_torch.serving import replica as port_replica

LOADS = [
    {},
    {0: {"queue_depth": 3, "active": 1}, 1: {"queue_depth": 0, "active": 1}},
    {0: {"queue_depth": 9}},
    {3: {"queue_depth": 2}, 7: {"queue_depth": 0}},
    {0: {"queue_depth": 0, "role": "prefill"},
     1: {"queue_depth": 5, "role": "decode"},
     2: {"queue_depth": 1, "role": "decode"},
     3: {"queue_depth": 0, "role": "both"}},
    {0: {"queue_depth": 9, "active": 2, "role": "prefill"},
     1: {"queue_depth": 0, "active": 1, "itl_p99_ms": 80.0,
         "role": "decode"}},
    {0: {"queue_depth": 0, "active": 1, "ttft_p95_ms": 900.0}},
    {0: {"queue_depth": 0, "active": 0}, 1: {}},
    {0: {"queue_depth": 7, "active": 2, "role": "prefill"},
     1: {"queue_depth": 0, "active": 0, "role": "decode"},
     2: {"queue_depth": 0, "active": 0, "role": "decode"}},
]


def _verdict(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("loads", LOADS, ids=range(len(LOADS)))
def test_pick_least_loaded_matches_jax(loads):
    keys = sorted(loads) or [0, 1, 2]
    cases = [dict(num_replicas=n, rr_counter=rr)
             for n in (0, 1, 2, 3, 4) for rr in range(4)]
    cases += [dict(num_replicas=0, rr_counter=rr, indices=idx)
              for rr in range(3)
              for idx in ([], keys, keys[:1], keys[1:], [keys[-1], 99])]
    cases += [dict(num_replicas=4, rr_counter=rr, role=role, **extra)
              for rr in range(3) for role in ("prefill", "decode", "both")
              for extra in ({}, {"indices": keys[1:]})]
    for kw in cases:
        assert _verdict(port_replica.pick_least_loaded, loads, **kw) == \
            _verdict(jax_replica.pick_least_loaded, loads, **kw), kw


@pytest.mark.parametrize("loads", LOADS, ids=range(len(LOADS)))
def test_autoscale_decision_matches_jax(loads):
    for n, lo, hi, qh, ttft, slo, itl, role, comp, comp_high in \
            itertools.product((1, 2, 4), (0, 1, 2), (1, 3, 4), (1.0, 4.0),
                              (None, 500.0), (False, True), (None, 50.0),
                              (None, "prefill", "decode"), (None, 0.3),
                              (None, 0.2)):
        args = (loads, n, lo, hi)
        kw = dict(queue_high=qh, ttft_high_ms=ttft, slo_breached=slo,
                  itl_high_ms=itl, role=role, ttft_component_s=comp,
                  ttft_component_high_s=comp_high)
        assert _verdict(port_replica.autoscale_decision, *args, **kw) == \
            _verdict(jax_replica.autoscale_decision, *args, **kw), (args, kw)


def test_needs_relaunch_matches_jax():
    for last, started, now, hang, startup in itertools.product(
            (None, 10.0, 98.0), (0.0, 60.0), (100.0,), (None, 5.0),
            (None, 50.0)):
        args = (last, started, now, hang, startup)
        assert port_replica.needs_relaunch(*args) == \
            jax_replica.needs_relaunch(*args), args


class _FakeFleet:
    """One scripted fleet: ``loads`` come from the script, scale actions
    are recorded, and ``add_replica`` refuses past ``capacity``."""

    def __init__(self, mod, n=2, capacity=None):
        self.mod = mod
        self.n = n
        self.capacity = capacity
        self.load_reports = {}
        self.calls = []

    @property
    def num_replicas(self):
        return self.n

    def loads(self):
        return self.load_reports

    def add_replica(self, role=None):
        if self.capacity is not None and self.n >= self.capacity:
            raise self.mod.CapacityBlocked("at capacity")
        self.calls.append(("add", role))
        self.n += 1

    def remove_replica(self, role=None):
        self.calls.append(("remove", role))
        self.n -= 1
        return 0


class _Monitor:
    def __init__(self, script):
        self.script = list(script)
        self.regs = []
        self.now = False

    def evaluate(self, reg=None):
        self.regs.append(reg)
        self.now = self.script.pop(0) if self.script else False

    def breached(self):
        return self.now


BUSY = {0: {"queue_depth": 8, "active": 1}}
IDLE = {0: {"queue_depth": 0, "active": 0}}
ROLE_BUSY = {0: {"queue_depth": 9, "role": "prefill"},
             1: {"queue_depth": 0, "active": 1, "itl_p99_ms": 120.0,
                 "role": "decode"},
             2: {"queue_depth": 0, "active": 1, "role": "decode"}}
ROLE_IDLE = {0: {"queue_depth": 9, "role": "prefill"},
             1: {"queue_depth": 0, "active": 0, "role": "decode"},
             2: {"queue_depth": 0, "active": 0, "role": "decode"}}

SCRIPTS = {
    "hysteresis": (dict(min_replicas=1, max_replicas=4, queue_high=1.0,
                        cooldown_s=10.0, idle_ticks_down=2),
                   dict(n=2), None,
                   [(0.0, BUSY), (1.0, BUSY), (11.0, BUSY), (30.0, IDLE),
                    (41.0, IDLE), (45.0, IDLE), (60.0, IDLE), (70.0, IDLE)]),
    "capacity_blocked": (dict(min_replicas=1, max_replicas=6,
                              queue_high=1.0),
                         dict(n=2, capacity=3), None,
                         [(0.0, BUSY), (1.0, BUSY), (2.0, BUSY), (3.0, IDLE),
                          (4.0, BUSY), (5.0, BUSY), (6.0, IDLE),
                          (7.0, IDLE)]),
    "slo": (dict(min_replicas=1, max_replicas=3, idle_ticks_down=1),
            dict(n=2), [True, False, True, False, False],
            [(0.0, IDLE), (1.0, IDLE), (2.0, IDLE), (3.0, IDLE),
             (4.0, IDLE)]),
    "decode_pool": (dict(min_replicas=1, max_replicas=4, queue_high=1.0,
                         itl_high_ms=50.0, role="decode"),
                    dict(n=3), None,
                    [(0.0, ROLE_BUSY), (10.0, ROLE_IDLE), (20.0, ROLE_IDLE),
                     (30.0, ROLE_IDLE)]),
    "prefill_pool": (dict(min_replicas=1, max_replicas=4, queue_high=1.0,
                          role="prefill"),
                     dict(n=3), None,
                     [(0.0, ROLE_BUSY), (10.0, ROLE_IDLE)]),
}


def _run_script(mod, kw, fleet_kw, slo, ticks):
    fleet = _FakeFleet(mod, **fleet_kw)
    monitor = _Monitor(slo) if slo is not None else None
    scaler = mod.Autoscaler(fleet, slo_monitor=monitor, **kw)
    trace = []
    for now, loads in ticks:
        fleet.load_reports = loads
        delta = scaler.tick(now=now)
        trace.append((delta, scaler.last_outcome,
                      scaler.capacity_blocked_streak,
                      scaler.capacity_blocked_total, fleet.n))
    return dict(trace=trace, history=scaler.history, calls=fleet.calls,
                ups=scaler.scale_ups, downs=scaler.scale_downs,
                regs=monitor.regs if monitor else None)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_autoscaler_matches_jax_on_one_script(name):
    kw, fleet_kw, slo, ticks = SCRIPTS[name]
    port = _run_script(port_replica, kw, fleet_kw, slo, ticks)
    jax = _run_script(jax_replica, kw, fleet_kw, slo, ticks)
    assert port == jax
    if name == "capacity_blocked":
        outcomes = [t[1] for t in port["trace"]]
        assert "capacity_blocked" in outcomes
        # the streak resets once the verdict stops asking for capacity
        assert [t[2] for t in port["trace"]][2:4] == [2, 0]
    if slo is not None:
        assert port["regs"] == [None] * len(ticks)


def test_autoscaler_validates_like_jax():
    for mod in (port_replica, jax_replica):
        with pytest.raises(ValueError, match="idle_ticks_down"):
            mod.Autoscaler(_FakeFleet(mod), idle_ticks_down=0)


class _Hist:
    def __init__(self, s, c):
        self.sum, self.count = s, c


class _Registry:
    def __init__(self):
        self.metrics = {}

    def items(self):
        return list(self.metrics.items())


def test_component_signal_matches_jax():
    """The lineage TTFT signal read from a registry: the mean over the
    samples since the last read of the pool's own component."""
    name = pmetrics.SERVE_TTFT_COMPONENT_METRIC
    assert name == jmetrics.SERVE_TTFT_COMPONENT_METRIC
    reg = _Registry()
    scalers = {}
    for mod in (port_replica, jax_replica):
        for role in ("prefill", "decode", None):
            scalers[(mod, role)] = mod.Autoscaler(
                _FakeFleet(mod), role=role, ttft_component_high_s=0.1)
    steps = [
        {(name, (("component", "queue_wait"),)): _Hist(0.6, 3),
         (name, (("component", "decode"),)): _Hist(0.2, 4),
         ("other", ()): _Hist(9.0, 9)},
        {(name, (("component", "queue_wait"),)): _Hist(1.0, 5),
         (name, (("component", "decode"),)): _Hist(0.2, 4)},
    ]
    for metrics in steps:
        reg.metrics = metrics
        for role in ("prefill", "decode", None):
            got = scalers[(port_replica, role)]._component_signal(reg)
            want = scalers[(jax_replica, role)]._component_signal(reg)
            assert got == want, (role, got, want)
    assert scalers[(port_replica, "prefill")]._component_signal(None) is None
    assert jax_replica.Autoscaler.POOL_COMPONENT == \
        port_replica.Autoscaler.POOL_COMPONENT


def test_load_tap_matches_jax():
    port, jax = port_replica._LoadTap(), jax_replica._LoadTap()
    for tap in (port, jax):
        tap.on_beat(1, 4, 0.0, {"load": {"queue_depth": 2, "active": 1}})
        tap.on_beat(2, 4, 0.0, {"other": 1})
        tap.on_beat(3, 4, 0.0, None)
        tap.heartbeat_age(1, 0.25)
        tap.record_event("straggler", rank=1, silent_s=1.0)
    assert port.snapshot() == jax.snapshot() == {
        1: {"queue_depth": 2, "active": 1}}
    assert port.ages == jax.ages and port.events == jax.events
    snap = port.snapshot()
    snap[1]["queue_depth"] = 99  # a copy
    assert port.loads[1]["queue_depth"] == 2


def test_public_names_match_jax():
    from ray_lightning_tpu_torch import serving

    assert sorted(port_replica.__all__) == sorted(jax_replica.__all__)
    for name in jax_replica.__all__:
        assert getattr(serving, name) is getattr(port_replica, name)
