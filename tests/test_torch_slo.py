"""PyTorch port, SLO serving: `repro_torch.runtime.ewma` and `.slo` and
GraphServe's deadlines, expiry sweep, tolerance router, measured backend
pair and governor, held against the reference step by step.

The units (`Ewma`, `StragglerGate`, `LatencyBank`, `SLOGovernor`) take the
same seeded sequences in both packages and must agree value for value and
decision for decision; the one exception is the port's repair of
`Ewma.value`, which never leaves the range of its samples. The engines run
on fake clocks with equal scripts (`FakeClock` below, the port's twin of
`tests/clockwork.py`), the reference's cost constants set on the port (as
the GraSp tests do) and the reference's kernels as their jnp twins; each
decision (dispatch order, expiry, late flag, served tier, backend,
governor level, summary counters) must be equal. No test sleeps.
"""
import dataclasses
from typing import Callable, List, Tuple

import jax
import numpy as np
import pytest

from clockwork import FakeClock as RefFakeClock

from repro.core import costs as rcosts
from repro.core import graph as rg
from repro.core import models as rmodels
from repro.core import sparsity as rsp
from repro.runtime import ewma as rewma
from repro.runtime import gnn_server as rserve
from repro.runtime import scheduler as rsched
from repro.runtime import slo as rslo
from repro_torch import bridge
from repro_torch.core import costs as tcosts
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.core import sparsity as tsp
from repro_torch.data.graphs import planetoid_like
from repro_torch.runtime import ewma as tewma
from repro_torch.runtime import gnn_server as tserve
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import slo as tslo
from repro_torch.runtime.clock import Clock

IN_FEATS, HIDDEN, CLASSES, HEADS = 16, 16, 4, 4
PKGS = ("jax", "torch")


class FakeClock(Clock):
    """Virtual time for the port's engine: `advance(s)` moves it, and
    `script(match, s)` sets what a dispatch under a matching batch key
    costs (`on_batch`, called between the dispatch's timestamps);
    `default_batch_s` covers the rest. The newest matching script wins."""

    def __init__(self, start: float = 0.0, default_batch_s: float = 0.0):
        self._now = float(start)
        self.default_batch_s = float(default_batch_s)
        self._scripts: List[Tuple[Callable, float]] = []
        self.batch_log: List[Tuple[tuple, float]] = []

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def on_batch(self, key, span=None) -> None:
        cost = self.default_batch_s
        for pred, seconds in self._scripts:
            if pred(key):
                cost = seconds
                break
        self.batch_log.append((tuple(key), cost))
        self._now += cost

    def advance(self, seconds: float) -> None:
        assert seconds >= 0, "virtual time cannot rewind"
        self._now += float(seconds)

    def script(self, match, seconds: float) -> None:
        """`match` is a predicate over the batch key, or {index: value}."""
        if isinstance(match, dict):
            items = tuple(match.items())

            def pred(key, _items=items):
                return all(key[i] == v for i, v in _items)
        else:
            pred = match
        self._scripts.insert(0, (pred, float(seconds)))


@pytest.fixture(scope="module", autouse=True)
def _reference_constants():
    """The reference's TPU constants on the port's cost rules (the bank's
    seed and the GraSp rule), and the reference's kernels as jnp twins."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcosts, "DENSE_RATE", rcosts.MXU_RATE)
        mp.setattr(tcosts, "INT8_RATE", 2.0 * rcosts.MXU_RATE)
        mp.setattr(tcosts, "GRASP_RATE", rcosts.MXU_RATE)
        mp.setattr(tcosts, "HBM_BW", rcosts.HBM_BW)
        mp.setattr(tcosts, "GRASP_STEP_OVERHEAD_S",
                   rsp.GRASP_STEP_OVERHEAD_S)
        mp.setattr(tcosts, "AGG_CALL_S", 0.0)
        mp.setenv("REPRO_KERNEL_MODE", "ref")
        yield


# ------------------------------------------------------------------ units


def _seq(seed, n=60):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(mean=-5.0, sigma=1.0, size=n)
    xs[rng.random(n) < 0.1] *= 20.0                 # stragglers
    return [float(x) for x in xs]


@pytest.mark.parametrize("alpha", [0.01, 0.1, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewma_equals_reference_within_the_samples(seed, alpha):
    ref, port = rewma.Ewma(alpha), tewma.Ewma(alpha)
    assert port.value is None and ref.value is None
    for x in _seq(seed):
        want, got = ref.observe(x), port.observe(x)
        assert (port.count, port.min, port.max) == (ref.count, ref.min,
                                                    ref.max)
        assert port.min <= got <= port.max
        # equal wherever the reference stays within its samples; where it
        # rounds past them the port holds the bound
        assert got == min(max(want, ref.min), ref.max)


def test_ewma_clamps_where_the_reference_rounds_out():
    """The reference fault the port repairs: one sample of 7.0 at alpha
    0.01 reads 7.000000000000001 there, exactly 7.0 here."""
    ref, port = rewma.Ewma(0.01), tewma.Ewma(0.01)
    ref.observe(7.0)
    port.observe(7.0)
    assert ref.value > 7.0
    assert port.value == 7.0
    bank = tewma.LatencyBank(alpha=0.01)
    bank.seed("k", 123.0)
    bank.observe("k", 7.0)
    assert bank.predict("k") == bank.measured("k") == 7.0
    out = 0
    for x in np.linspace(0.1, 10.0, 200):
        for a in (0.01, 0.03, 0.07, 0.3):
            r, p = rewma.Ewma(a), tewma.Ewma(a)
            r.observe(float(x))
            p.observe(float(x))
            assert p.value == float(x)
            out += r.value != float(x)
    assert out > 0                    # the reference leaves its sample


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_straggler_gate_equals_reference(seed):
    ref = rewma.StragglerGate(factor=2.5, alpha=0.1)
    port = tewma.StragglerGate(factor=2.5, alpha=0.1)
    flagged = 0
    for x in _seq(seed):
        verdict = port.check(x)
        assert verdict == ref.check(x)
        flagged += verdict
        assert port.baseline == pytest.approx(ref.baseline, rel=1e-15)
    assert flagged > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_bank_equals_reference(seed):
    rng = np.random.default_rng(seed)
    keys = [("m", b, t, be, "none", 0) for b in (64, 128)
            for t in ("fp32", "int8") for be in ("dense", "grasp")]
    ref, port = rewma.LatencyBank(), tewma.LatencyBank()
    for _ in range(300):
        key = keys[rng.integers(len(keys))]
        op = rng.integers(3)
        if op == 0:
            s = float(rng.lognormal(-8.0, 1.0))
            ref.seed(key, s)
            port.seed(key, s)
        elif op == 1:
            s = float(rng.lognormal(-5.0, 1.0))
            ref.observe(key, s)
            port.observe(key, s)
        for k in keys:
            assert port.samples(k) == ref.samples(k)
            assert port.predict(k) == _within(ref, k, ref.predict(k))
            assert port.measured(k) == _within(ref, k, ref.measured(k))
        for bucket in (64, 128):
            match = lambda k, b=bucket: k[1] == b          # noqa: E731
            got = port.measured_pair(match, lambda k: k[3])
            want = ref.measured_pair(match, lambda k: k[3])
            assert got == pytest.approx(want, rel=1e-15)
        assert port.ewma_vs_model() == pytest.approx(ref.ewma_vs_model(),
                                                     rel=1e-15)
    assert port.keys() == ref.keys()


def _within(bank, key, v):
    """The reference bank's value held to its key's sample range: what
    the port's `Ewma` answers (the seed passes unchanged)."""
    e = bank._entries.get(key)
    if v is None or e is None or e.ewma.count == 0:
        return v
    return min(max(v, e.ewma.min), e.ewma.max)


GOVERNORS = (dict(target_p99_ms=10.0, window=2, min_samples=1,
                  breach_checks=2, clear_checks=2, max_queue_depth=2,
                  ladder=("fp32", "int8")),
             dict(target_p99_ms=5.0, window=8, min_samples=3,
                  breach_checks=3, clear_checks=4, max_queue_depth=5),
             dict())


@pytest.mark.parametrize("cfg", range(len(GOVERNORS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_governor_equals_reference_decision_for_decision(cfg, seed):
    ref = rslo.SLOGovernor(rslo.SLOConfig(**GOVERNORS[cfg]))
    port = tslo.SLOGovernor(tslo.SLOConfig(**GOVERNORS[cfg]))
    rng = np.random.default_rng(seed)
    # slow and fast phases, so the level walks down and back up
    lat = np.concatenate([rng.uniform(0.0, 0.004, 20),
                          rng.uniform(0.02, 0.08, 30),
                          rng.uniform(0.0, 0.004, 100)])
    registered = ["fp32", "int8", "int8+grax"]
    levels = set()
    for x in lat:
        ref.observe(float(x))
        port.observe(float(x))
        assert port.p99_ms() == ref.p99_ms()
        assert ((port.level, port.downgrades, port.upgrades)
                == (ref.level, ref.downgrades, ref.upgrades))
        for default in ("fp32", "int8"):
            for reg in (registered, registered[:2], ["fp32"]):
                assert (port.tier_override(default, reg)
                        == ref.tier_override(default, reg))
        for depth in (0, 2, 5, 64):
            assert port.should_shed(depth) == ref.should_shed(depth)
        levels.add(port.level)
    assert port.downgrades > 0 and port.upgrades > 0 and len(levels) > 1


def test_measured_pair_flips_select_agg_backend_like_reference():
    """The reference's pinned inversion: the model prefers grasp at (2048,
    64 features, 4 blocks), measured latencies say dense; both packages
    flip, a partial pair never overrides, eligibility always holds."""
    for measured in (None, (1e-4, 5e-4), (None, 5e-4), (5e-4, None)):
        for mx in (1, 10):
            args = dict(nnz_blocks=4, max_row_nnz=mx, mode="auto",
                        measured=measured)
            got = tsp.select_agg_backend(2048, 64, **args)
            want = rsp.select_agg_backend(2048, 64, **args)
            assert got[0] == want[0]
            assert got[1:] == pytest.approx(want[1:], rel=1e-12)
    assert tsp.select_agg_backend(2048, 64, nnz_blocks=4, max_row_nnz=1,
                                  measured=(1e-4, 5e-4))[0] == "dense"
    assert tsp.select_agg_backend(2048, 64, nnz_blocks=4,
                                  max_row_nnz=1)[0] == "grasp"


# ---------------------------------------------------------------- engines


def _graph(pkg, n, seed):
    g = planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=IN_FEATS,
                       num_classes=CLASSES, seed=seed, train_per_class=2)
    return rg.Graph(**dataclasses.asdict(g)) if pkg == "jax" else g


def _cfg(pkg, kind):
    cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    return cls(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
               num_classes=CLASSES, heads=HEADS)


def _params(pkg, kind, seed):
    p = rmodels.init_params(jax.random.PRNGKey(seed), _cfg("jax", kind))
    if pkg == "jax":
        return p
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                  device="cpu")


_ENGINES = {}


def _engine(pkg, name):
    """One engine per (package, flavor), warm, shared by the tests; each
    test gives it a fresh fake clock and reads counters as differences."""
    if (pkg, name) in _ENGINES:
        return _ENGINES[(pkg, name)]
    mod, gmod = (rserve, rg) if pkg == "jax" else (tserve, tg)
    clock = RefFakeClock() if pkg == "jax" else FakeClock()
    sc = mod.GraphServeConfig(ladder=gmod.BucketLadder(buckets=(128, 256)),
                              batch_slots=2, return_logits=True)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if name == "governed":
        slo_mod = rslo if pkg == "jax" else tslo
        kw["slo"] = slo_mod.SLOConfig(
            target_p99_ms=10.0, window=2, min_samples=1, breach_checks=2,
            clear_checks=2, max_queue_depth=2, ladder=("fp32", "int8"))
    eng = mod.GraphServe(sc, seed=0, clock=clock, **kw)
    if name == "plain":            # gcn + gat, fp32: EDF and expiry
        eng.register_model("gcn", _cfg(pkg, "gcn"), _params(pkg, "gcn", 0))
        eng.register_model("gat", _cfg(pkg, "gat"), _params(pkg, "gat", 1))
    elif name == "tiers":          # the full ladder, auto backend: routing
        eng.register_model("gcn", _cfg(pkg, "gcn"), _params(pkg, "gcn", 0),
                           tiers=("fp32", "int8", "int8+grax"),
                           agg_backend="auto")
    else:                          # fp32/int8 under a governor
        eng.register_model("gcn", _cfg(pkg, "gcn"), _params(pkg, "gcn", 0),
                           tiers=("fp32", "int8"))
    eng.warmup()
    if name in ("tiers", "governed"):
        eng.calibrate("gcn", _graph(pkg, 60, 9))
    _ENGINES[(pkg, name)] = eng
    return eng


def _pair(name, **clock_kw):
    """Both packages' engines of one flavor, each on a fresh fake clock."""
    out = {}
    for pkg in PKGS:
        eng = _engine(pkg, name)
        eng.clock = (RefFakeClock if pkg == "jax" else FakeClock)(**clock_kw)
        if eng.governor is not None:
            g = eng.governor
            g.level = g.downgrades = g.upgrades = 0
            g._breach_streak = g._clear_streak = 0
            g._lat.clear()
        out[pkg] = eng
    return out


def _by_uid(eng, uid):
    return next(r for r in eng.finished if r.uid == uid)


def _both(engines, fn):
    """Run `fn(pkg, eng)` on each package's engine; return the results."""
    return {pkg: fn(pkg, eng) for pkg, eng in engines.items()}


def test_bank_seeds_equal_reference():
    for name in ("plain", "tiers", "governed"):
        ref, port = _engine("jax", name), _engine("torch", name)
        assert set(port.bank.keys()) == set(ref.bank.keys())
        for k in ref.bank.keys():
            assert port.bank._entries[k].seed == pytest.approx(
                ref.bank._entries[k].seed, rel=1e-12), k
        assert all(k[5] == 0 for k in port.bank.keys())


def test_edf_dispatch_order_equals_reference():
    engines = _pair("plain")

    def run(pkg, eng):
        sched_mod = rsched if pkg == "jax" else tsched
        sched = sched_mod.PipelineScheduler(
            eng, sched_mod.PipelineConfig(deterministic=True))
        for i in range(2):
            sched.submit(_graph(pkg, 40 + i, i), model="gat")
        for i in range(2):
            sched.submit(_graph(pkg, 50 + i, i), model="gcn",
                         deadline_ms=5.0)
        n0 = len(eng.finished)
        out = sched.drain()
        sched.close()
        return ([r.model for r in eng.finished[n0:]],
                [r.uid for r in out])
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["gcn", "gcn", "gat", "gat"]


def test_expiry_without_dispatch_equals_reference():
    engines = _pair("plain")

    def run(pkg, eng):
        m0 = (eng.metrics["deadline_misses"], eng.metrics["batches"])
        uid_exp = eng.submit(_graph(pkg, 40, 0), model="gcn",
                             deadline_ms=10.0)
        eng.clock.advance(0.02)                 # queue wait spends it
        uid_ok = eng.submit(_graph(pkg, 41, 1), model="gat")
        eng.run()
        r_exp, r_ok = _by_uid(eng, uid_exp), _by_uid(eng, uid_ok)
        return (r_exp.done, r_exp.deadline_missed, r_exp.preds is None,
                r_exp.finished_s - r_exp.submitted_s,
                r_ok.preds is not None, r_ok.deadline_missed,
                eng.metrics["deadline_misses"] - m0[0],
                eng.metrics["batches"] - m0[1])
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == (True, True, True, pytest.approx(0.02), True,
                            False, 1, 1)


def test_executed_but_late_equals_reference():
    engines = _pair("plain", default_batch_s=0.05)

    def run(pkg, eng):
        m0 = eng.metrics["deadline_misses"]
        late = eng.submit(_graph(pkg, 40, 0), model="gcn", deadline_ms=10.0)
        eng.run()                               # the dispatch costs 50 ms
        never = eng.submit(_graph(pkg, 42, 2), model="gcn")
        eng.clock.advance(3600.0)               # no deadline: never expires
        eng.run()
        r, n = _by_uid(eng, late), _by_uid(eng, never)
        return (r.deadline_missed, r.preds is not None,
                n.deadline_missed, n.preds is not None,
                eng.metrics["deadline_misses"] - m0)
    got = _both(engines, run)
    assert got["torch"] == got["jax"] == (True, True, False, True, 1)


def test_ready_buffer_sweep_equals_reference():
    engines = _pair("plain")

    def run(pkg, eng):
        sched_mod = rsched if pkg == "jax" else tsched
        sched = sched_mod.PipelineScheduler(
            eng, sched_mod.PipelineConfig(deterministic=True))
        t_exp = sched.submit(_graph(pkg, 40, 0), model="gcn",
                             deadline_ms=10.0)
        t_ok = sched.submit(_graph(pkg, 41, 1), model="gat")
        eng.clock.advance(0.05)
        out = sched.drain()
        sched.close()
        return (out[t_exp].deadline_missed, out[t_exp].preds is None,
                out[t_ok].deadline_missed, out[t_ok].preds is None,
                sched.metrics["completed"])
    got = _both(engines, run)
    assert got["torch"] == got["jax"] == (True, True, False, False, 2)


def test_tolerance_router_tiers_equal_reference():
    engines = _pair("governed")

    def run(pkg, eng):
        eng.clock.script({2: "fp32"}, 5e-3)
        eng.clock.script({2: "int8"}, 1e-4)
        eng.models["gcn"].accuracy_delta["int8"] = -2.0
        tiers = []
        for i, tol in enumerate((1.0, 3.0, 0.5, 2.0, 10.0)):
            uid = eng.submit(_graph(pkg, 40 + i, i), model="gcn",
                             tolerance=tol)
            eng.run()
            tiers.append(_by_uid(eng, uid).tier)
        uid = eng.submit(_graph(pkg, 46, 6), model="gcn", tier="int8",
                         tolerance=0.0)      # an explicit tier is a contract
        eng.run()
        tiers.append(_by_uid(eng, uid).tier)
        return tiers
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ["fp32", "int8", "fp32", "int8", "int8", "int8"]


def test_tolerance_router_measured_over_seed_equals_reference():
    engines = _pair("governed")

    def run(pkg, eng):
        eng.clock.script({2: "fp32"}, 1e-6)
        eng.clock.script({2: "int8"}, 1e-3)
        eng.models["gcn"].accuracy_delta["int8"] = -2.0
        old = eng.bank
        eng.bank = (rewma if pkg == "jax" else tewma).LatencyBank()
        try:
            eng.bank.seed(("gcn", 128, "fp32", "dense", "none", 0), 2e-7)
            eng.bank.seed(("gcn", 128, "int8", "dense", "none", 0), 1e-7)
            tiers = []
            for i in range(3):
                uid = eng.submit(_graph(pkg, 42 + i, i), model="gcn",
                                 tolerance=3.0)
                eng.run()
                tiers.append(_by_uid(eng, uid).tier)
            return tiers, eng.bank.measured(("gcn", 128, "int8", "dense",
                                             "none", 0))
        finally:
            eng.bank = old
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == (["int8", "fp32", "fp32"], pytest.approx(1e-3))


def test_measured_pair_flips_engine_routing_like_reference():
    engines = _pair("tiers")

    def run(pkg, eng):
        backends = []
        uid = eng.submit(_graph(pkg, 200, 0), model="gcn", tier="fp32")
        eng.run()
        backends.append(_by_uid(eng, uid).backend)        # the model's
        pair0 = eng._measured_agg_pair("gcn", 256)
        eng.bank.observe(("gcn", 256, "fp32", "dense", "none", 0), 1e-3)
        eng.bank.observe(("gcn", 256, "fp32", "grasp", "none", 0), 1e-6)
        uid = eng.submit(_graph(pkg, 200, 0), model="gcn", tier="fp32")
        eng.run()
        r = _by_uid(eng, uid)
        backends.append(r.backend)
        eng.assert_warm()
        return backends, r.preds is not None, pair0[1] is None
    got = _both(engines, run)
    assert got["torch"] == got["jax"] == (["dense", "grasp"], True, True)


def test_governor_cycle_equals_reference():
    engines = _pair("governed")

    def run(pkg, eng):
        eng.clock.script({2: "fp32"}, 0.05)
        eng.clock.script({2: "int8"}, 0.001)
        steps = []
        for i in range(8):
            uid = eng.submit(_graph(pkg, 40 + i, i), model="gcn")
            eng.run()
            g = eng.governor
            steps.append((_by_uid(eng, uid).tier, g.level, g.downgrades,
                          g.upgrades))
        pinned = eng.submit(_graph(pkg, 50, 3), model="gcn", tier="fp32")
        eng.governor.level = eng.governor.max_level
        pinned2 = eng.submit(_graph(pkg, 51, 4), model="gcn", tier="fp32")
        eng.run()
        s = eng.summary()
        eng.assert_warm()
        return (steps, _by_uid(eng, pinned).tier, _by_uid(eng, pinned2).tier,
                s["slo_downgrades"], s["slo_upgrades"], s["slo_level"])
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    steps = got["torch"][0]
    assert [t for t, *_ in steps][:6] == ["fp32", "fp32", "int8", "int8",
                                         "int8", "fp32"]
    assert got["torch"][1:3] == ("fp32", "fp32")


def test_governor_shed_equals_reference():
    engines = _pair("governed")

    def run(pkg, eng):
        sched_mod = rsched if pkg == "jax" else tsched
        eng.governor.level = eng.governor.max_level
        shed0 = eng.metrics["shed_requests"]
        sched = sched_mod.PipelineScheduler(
            eng, sched_mod.PipelineConfig(deterministic=True))
        sched.submit(_graph(pkg, 40, 0), model="gcn")
        sched.submit(_graph(pkg, 41, 1), model="gcn")
        with pytest.raises(sched_mod.QueueFull):
            sched.submit(_graph(pkg, 42, 2), model="gcn")
        rejected = sched.metrics["rejected"]
        eng.governor.level = 0
        out = sched.drain()
        sched.close()
        return (rejected, eng.metrics["shed_requests"] - shed0,
                [r.tier for r in out])
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (1, 1)


SLO_KEYS = ("deadline_misses", "shed_requests", "slo_downgrades",
            "slo_upgrades", "slo_level")


def test_summary_slo_keys_equal_reference():
    for name in ("plain", "governed"):
        ref, port = _engine("jax", name), _engine("torch", name)
        rs, ps = ref.summary(), port.summary()
        assert {k: ps[k] for k in SLO_KEYS} == {k: rs[k] for k in SLO_KEYS}
        assert (ps["ewma_vs_model"] is None) == (rs["ewma_vs_model"] is None)
        if rs["ewma_vs_model"] is not None:
            assert ps["ewma_vs_model"] == pytest.approx(rs["ewma_vs_model"],
                                                        rel=1e-9)
    assert _engine("torch", "plain").summary()["deadline_misses"] > 0


def test_soak_mixed_deadlines_and_tiers_equals_reference():
    """Mixed deadline, tolerance and tier traffic over two buckets through
    the deterministic scheduler in virtual time: the same completions,
    expiries, tiers and backends in both packages, each request once,
    and no recompile."""
    engines = _pair("tiers", default_batch_s=1e-3)

    def run(pkg, eng):
        sched_mod = rsched if pkg == "jax" else tsched
        m0 = eng.metrics["deadline_misses"]
        sched = sched_mod.PipelineScheduler(
            eng, sched_mod.PipelineConfig(deterministic=True))
        for i in range(16):
            kw = {}
            if i % 3 == 0:
                kw["tier"] = "int8"
            elif i % 3 == 1:
                kw["tolerance"] = 5.0
            if i % 4 == 0:
                kw["deadline_ms"] = 0.0
            elif i % 4 == 2:
                kw["deadline_ms"] = 1e6
            n = 40 if i % 2 == 0 else 200
            assert sched.submit(_graph(pkg, n, i), model="gcn", **kw) == i
            eng.clock.advance(1e-4)
        out = sched.drain()
        sched.close()
        eng.assert_warm()
        return ([(r.uid, r.tier, r.backend, r.bucket, r.deadline_missed,
                  r.preds is None) for r in out],
                eng.metrics["deadline_misses"] - m0)
    got = _both(engines, run)
    assert got["torch"] == got["jax"]
    rows, misses = got["torch"]
    assert len({r[0] for r in rows}) == 16
    assert misses == 4 == sum(r[4] for r in rows)
