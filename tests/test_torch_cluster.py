"""The port's cluster layer against the JAX package's: replay, load
balancing, the fault plane and disaggregation, on ``SimExecutor`` replicas.

``data/``, ``chaos/``, ``sim/``, ``cluster/`` and ``disagg/pools.py``,
``disagg/router.py`` are copies of the JAX package's modules, byte-equal
modulo the package name (checked here file by file). On the same trace and
seed ``replay()`` returns byte-equal summaries and per-request metrics in
both packages (``repr`` compared, so float formatting and dict order are
held too) for ``fairbatching`` under the PAB, cache-affinity, round-robin
and two-stage disaggregation load balancers, a rank failure, an elastic
rejoin, a seeded chaos campaign, transfer faults on the migration link and
a source rank lost while its payload is on the wire.
"""
import pathlib
import re

import pytest

import repro.chaos as jchaos
import repro.cluster as jcluster
import repro.core.cost_model as jcost
import repro.data.traces as jtraces
import repro.disagg as jdisagg
import repro.sim as jsim
import repro_torch.chaos as tchaos
import repro_torch.cluster as tcluster
import repro_torch.core.cost_model as tcost
import repro_torch.data.traces as ttraces
import repro_torch.disagg as tdisagg
import repro_torch.sim as tsim

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIES = sorted(
    str(p.relative_to(SRC / "repro"))
    for d in ("cache", "data", "chaos", "sim", "cluster", "disagg")
    for p in (SRC / "repro" / d).glob("*.py")
    if p.name != "migration.py")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_equal_modulo_package(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def test_migration_differs_only_where_jax_touches_device_arrays():
    """``disagg/migration.py`` is a torch port in capture, the COW drain
    and install, and a copy everywhere else."""
    import ast
    trees = {pkg: ast.parse((SRC / pkg / "disagg" / "migration.py")
                            .read_text()) for pkg in ("repro", "repro_torch")}
    defs = {pkg: {n.name: ast.dump(n) for n in t.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
            for pkg, t in trees.items()}
    assert defs["repro"].keys() == defs["repro_torch"].keys()
    differ = {k for k in defs["repro"]
              if defs["repro"][k] != defs["repro_torch"][k]}
    assert differ == {"KVPayload", "capture_kv", "_mirror_cow",
                      "install_kv_pages"}


def _pkgs(port: bool):
    if port:
        return tsim, ttraces, tchaos, tdisagg, tcost
    return jsim, jtraces, jchaos, jdisagg, jcost


def _case(name, port):
    """(trace, replay kwargs) of one case, built from one package."""
    sim, traces, chaos, disagg, cost = _pkgs(port)
    scen = traces.make_scenario
    if name == "pab_admission":
        return traces.make_trace("qwentrace", rps=12.0, duration=4.0,
                                 seed=3), dict(n_ranks=4, lb="pab",
                                               admission=True, seed=1)
    if name == "cache_lb":
        return scen("shared-sysprompt", rps=6.0, duration=8.0, seed=7,
                    n_sysprompts=12), dict(n_ranks=3, lb="cache",
                                           prefix_cache_pages=128, seed=2)
    if name == "roundrobin_cache":
        return scen("multi-turn", rps=4.0, duration=8.0, seed=5), dict(
            n_ranks=2, lb="roundrobin", prefix_cache_pages=256,
            admission=True, seed=9)
    if name == "disagg_kv":
        return scen("multi-turn", rps=6.0, duration=6.0, seed=6), dict(
            n_ranks=3, lb="disagg", prefix_cache_pages=64, seed=1,
            disagg=disagg.DisaggConfig(n_prefill=1, mode="kv"))
    if name == "disagg_auto_shed":
        return scen("bursty-gamma", rps=10.0, duration=5.0, seed=2), dict(
            n_ranks=4, lb="disagg", seed=3,
            disagg=disagg.DisaggConfig(n_prefill=2, mode="auto",
                                       shed_pab=64.0))
    if name == "rank_failure":
        return traces.make_trace("qwentrace", rps=12.0, duration=4.0,
                                 seed=3), dict(n_ranks=4, lb="pab",
                                               failures=[(2.0, 1)], seed=0)
    if name == "elastic_rejoin":
        return scen("shared-sysprompt", rps=4.0, duration=10.0, seed=3), \
            dict(n_ranks=2, lb="cache", prefix_cache_pages=256, seed=4,
                 failures=[(3.0, 0)], joins=[(6.0, 2)])
    if name == "chaos_campaign":
        plan = chaos.FaultPlan.generate(
            seed=3, duration=5.0, n_ranks=4, crash_rate=2 / 5.0,
            straggler_rate=1 / 5.0, straggle_factor=4.0,
            pressure_rate=1 / 5.0, pressure_frac=0.6, report_drop_rate=0.2,
            report_delay_rate=0.1)
        assert plan.crashes
        return traces.make_trace("qwentrace", rps=20.0, duration=5.0,
                                 seed=7), dict(
            n_ranks=4, lb="pab", chaos=plan, checkpoint_interval=0.5,
            prefix_cache_pages=64, seed=1)
    if name in ("chaos_xfer_faults", "dead_source_mid_xfer"):
        # a thin link keeps payloads on the wire long enough to fail or to
        # lose their source
        link = cost.LinkModel(latency=5e-3, bandwidth=2e8)
        kw = dict(n_ranks=3, lb="disagg", prefix_cache_pages=64, seed=1,
                  disagg=disagg.DisaggConfig(n_prefill=1, mode="kv",
                                             link=link))
        if name == "chaos_xfer_faults":
            kw["chaos"] = chaos.FaultPlan(seed=2, xfer_fail_rate=0.5,
                                          max_retries=2)
        else:
            kw["failures"] = [(1.0, 0)]
        return scen("multi-turn", rps=10.0, duration=4.0, seed=6), kw
    raise KeyError(name)


def _reaches(name, res) -> bool:
    """The case is not vacuous: the port's run reached the layer it names."""
    s = res.summary
    mig, faults = s.get("migrations", {}), s.get("faults", {})
    return {
        "pab_admission": lambda: s["rejected"] >= 0 and len(res.metrics) > 0,
        "cache_lb": lambda: s["cache_hit_tokens"] > 0 and any(
            res.cluster.lb.prefixes[r] for r in range(3)),
        "roundrobin_cache": lambda: s["cache_hit_tokens"] > 0,
        "disagg_kv": lambda: mig["kv"] > 0 and mig["ref_tokens"] > 0,
        "disagg_auto_shed": lambda: mig["launched"] > 0,
        "rank_failure": lambda: faults["crashes"] == 1
        and faults["detections"] == 1 and faults["redispatched"] > 0,
        "elastic_rejoin": lambda: len(res.cluster.lb.prefixes) == 3,
        "chaos_campaign": lambda: faults["crashes"] >= 1,
        "chaos_xfer_faults": lambda: mig["xfer_failures"] > 0
        and mig["xfer_retries"] > 0,
        "dead_source_mid_xfer": lambda: mig["dead_source"] > 0
        and faults["crashes"] == 1,
    }[name]()


@pytest.mark.parametrize("name", [
    "pab_admission", "cache_lb", "roundrobin_cache", "disagg_kv",
    "disagg_auto_shed", "rank_failure", "elastic_rejoin", "chaos_campaign",
    "chaos_xfer_faults", "dead_source_mid_xfer"])
def test_replay_byte_equal_to_jax(name):
    out = []
    for port in (False, True):
        trace, kw = _case(name, port)
        res = _pkgs(port)[0].replay(trace, "fairbatching", **kw)
        out.append((repr(res.summary), repr(res.metrics), res.duration,
                    len(trace)))
    (s_j, m_j, d_j, n_j), (s_t, m_t, d_t, n_t) = out
    assert n_t == n_j and d_t == d_j
    assert s_t == s_j
    assert m_t == m_j
    assert _reaches(name, res)


def test_cluster_pab_lb_and_straggler_match_jax():
    """tests/test_cluster.py's direct ``Cluster`` use: PAB-LB over a
    straggling rank, the same summary and per-rank loads."""
    out = []
    for cl_mod, traces in ((jcluster, jtraces), (tcluster, ttraces)):
        trace = traces.make_trace("qwentrace", rps=4.0, duration=12,
                                  seed=3)
        cfg = cl_mod.ClusterConfig(n_ranks=4, scheduler="fairbatching",
                                   admission=False,
                                   straggler_ranks={0: 3.0})
        cl = cl_mod.Cluster(cfg, cl_mod.PABLB(4))
        done = cl.run(trace)
        out.append((repr(cl.summary()), sorted(cl._rank_of.items()),
                    len(done)))
    assert out[0] == out[1]
    loads = [sum(1 for _, rk in out[1][1] if rk == r) for r in range(4)]
    assert loads[0] < min(loads[1:])


def test_traces_and_scenarios_match_jax():
    for name in sorted(jtraces.SCENARIOS):
        a = jtraces.make_scenario(name, rps=3.0, duration=5.0, seed=11)
        b = ttraces.make_scenario(name, rps=3.0, duration=5.0, seed=11)
        assert repr(a) == repr(b), name
