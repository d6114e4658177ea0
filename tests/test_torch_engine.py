"""The port's host-side engine against the JAX package's, on the sim plane.

One seeded trace of requests goes through each package's ``Engine`` with
its ``SimExecutor``: every plan and step record, each request's TTFT and
TPOT, and the engine's snapshot must be byte-equal.
The scheduler core, request, metrics, KV-allocator and engine modules of
the port are copies, so any difference is a porting fault.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jeng
import repro_torch.core as tcore
import repro_torch.engine as teng

SCHEDULERS = ["fairbatching", "sarathi", "vllm-vanilla"]


def make_trace(pkg, seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.03))
        plen = int(rng.integers(8, 900))
        reqs.append(pkg.Request(
            i, arrival=t, prompt_len=plen,
            max_new_tokens=int(rng.integers(2, 48)),
            ttft_slo=float(rng.choice([0.5, 1.0, 2.0])), tpot_slo=0.06))
    return reqs


def capture_plans(eng) -> list:
    """Record every plan the scheduler forms (the SimExecutor never
    defers, so plans are the whole control-plane trace)."""
    plans, orig = [], eng.sched.schedule

    def schedule(now, tasks):
        plan = orig(now, tasks)
        plans.append(tuple((it.req_id, it.n_tokens, it.kind.name)
                           for it in plan.items))
        return plan

    eng.sched.schedule = schedule
    return plans


def run(core, eng_pkg, sched_name: str, seed: int):
    true = core.LinearCostModel(a=6e-3, b=9e-5, c=4e-8)
    sched = core.make_scheduler(sched_name,
                                core.LinearCostModel(a=5e-3, b=1e-4, c=5e-8))
    ex = eng_pkg.SimExecutor(true, noise_sigma=0.05, gc_pause_every=0.7,
                             gc_pause_len=0.05, seed=seed)
    eng = eng_pkg.Engine(sched, ex, eng_pkg.EngineConfig(ttft_slo=1.0,
                                                         tpot_slo=0.06))
    trace = capture_plans(eng)
    for r in make_trace(eng_pkg, seed):
        eng.submit(r)
    done = eng.run()
    return eng, trace, done


@pytest.mark.parametrize("sched_name", SCHEDULERS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sim_engine_trace_byte_equal(sched_name, seed):
    ej, tj, dj = run(jcore, jeng, sched_name, seed)
    et, tt, dt = run(tcore, teng, sched_name, seed)
    assert len(ej.steps) > 20
    assert tj == tt
    assert ([dataclasses.astuple(s) for s in ej.steps]
            == [dataclasses.astuple(s) for s in et.steps])
    assert ([dataclasses.astuple(m) for m in dj]
            == [dataclasses.astuple(m) for m in dt])
    assert ej.snapshot() == et.snapshot()
    sj = jeng.summarize(dj, duration=ej.now)
    st = teng.summarize(dt, duration=et.now)
    assert repr(sj) == repr(st)
