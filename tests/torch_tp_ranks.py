"""Rank bodies of ``tests/test_torch_tp.py``, run in the processes that
``repro_torch.launch.mesh.spawn`` starts. This module imports torch and the
port, never JAX: the parent test computes the JAX oracle and hands each
rank numpy weights and prompts.

``run_cases(rank, world, cases)`` builds a ``1 × world`` mesh on the gloo
group and serves each case through the sharded executor: rank 0 drives an
``Engine`` with the fairbatching scheduler on the model clock
(``ModelTimedExecutor``) and stops the other ranks, which replay its
dispatches in ``serve_worker``. Each rank returns one record a case.
"""
import dataclasses
import sys

import torch

from repro_torch.configs import get_reduced
from repro_torch.core import LinearCostModel, make_scheduler
from repro_torch.disagg.migration import capture_kv, install_kv_pages
from repro_torch.engine import (Engine, EngineConfig, PagedTransformerExecutor,
                                Request)
from repro_torch.engine.numerics import (ModelTimedExecutor,
                                         capture_schedule, vtc_counters)
from repro_torch.engine.spec_decode import TruncatedSelfDraft
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import params_from_numpy

PAGE, NUM_PAGES, MAX_PAGES = 16, 64, 8
# the engine's clock: step times from this model, not the wall
CLOCK = LinearCostModel(a=1e-3, b=1e-4, c=0.0)
# the scheduler's own cost model (as tests/test_tp_executor.py's)
SCHED_MODEL = LinearCostModel(a=1e-4, b=1e-6, c=1e-10)


def case_cfg(case: dict):
    return dataclasses.replace(get_reduced(case["arch"]),
                               **case.get("overrides", {}))


def requests(prompts: list, n_new: int = 5) -> list:
    return [Request(i, arrival=0.002 * i, prompt_len=len(t),
                    max_new_tokens=n_new, ttft_slo=5.0, tpot_slo=5.0,
                    tokens=list(t)) for i, t in enumerate(prompts)]


def executor(cfg, params, mesh, case: dict) -> PagedTransformerExecutor:
    return PagedTransformerExecutor(
        cfg, params, num_pages=NUM_PAGES, page_size=PAGE,
        max_pages_per_seq=MAX_PAGES, mode=case.get("mode", "fused"),
        kv_dtype=case.get("kv_dtype", "fp32"),
        moe_impl=case.get("moe_impl", "exact"), mesh=mesh, device="cpu")


def drive(ex, prompts: list, cost_shards: int, max_steps: int = 400):
    """Serve ``prompts`` on ``ex`` (rank 0 of a mesh, or one device) on
    the model clock; returns (tokens by request, decision trace, VTC
    counters, engine steps)."""
    sched = make_scheduler("fairbatching", SCHED_MODEL)
    eng = Engine(sched, ModelTimedExecutor(ex, CLOCK),
                 EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                              cost_shards=cost_shards))
    for r in requests(prompts):
        eng.submit(r)
    trace = capture_schedule(eng)
    n = 0
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
    if eng.has_work:
        raise AssertionError(f"engine still busy after {max_steps} steps")
    tokens = {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}
    return tokens, trace, vtc_counters(eng), len(eng.steps)


def _refusals(cfg, params, mesh, world: int) -> dict:
    """Each path the sharded executor refuses (ROADMAP A13b), by the
    error's message; no collective runs."""
    out = {}
    ex = executor(cfg, params, mesh, {})
    req = requests([[1, 2, 3]])[0]
    calls = {
        "execute_multi": lambda: ex.execute_multi(None, {}, 0.0, 2),
        "set_draft": lambda: ex.set_draft(TruncatedSelfDraft(1)),
        "attach_cache": lambda: ex.attach_cache(None),
        "capture_kv": lambda: capture_kv(ex, 0),
        "install_kv_pages": lambda: install_kv_pages(ex, None, req, None,
                                                     0.0),
    }
    if world == 4:
        wide = make_test_mesh(data=2, model=2)
        calls["data_axis"] = lambda: executor(cfg, params, wide, {})
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def run_cases(rank: int, world: int, cases: list) -> list:
    torch.set_num_threads(1)
    mesh = make_test_mesh(data=1, model=world)
    recs = []
    for case in cases:
        cfg = case_cfg(case)
        params = params_from_numpy(case["params"], "cpu")
        if case.get("refusals"):
            recs.append({"refusals": _refusals(cfg, params, mesh, world)})
            continue
        ex = executor(cfg, params, mesh, case)
        rec = {"n_shards": ex.n_shards,
               "kv_heads": ex.k_pages.shape[3],
               "jax_imported": "jax" in sys.modules}
        if rank == 0:
            tokens, trace, vtc, steps = drive(ex, case["prompts"],
                                              case.get("cost_shards", 1))
            ex.stop_workers()
            rec.update(tokens=tokens, trace=trace, vtc=vtc, steps=steps)
        else:
            assert ex.serve_worker() == ex.n_dispatches
        rec.update(dispatches=ex.n_dispatches,
                   all_reduces=ex.tp.all_reduces,
                   per_dispatch=ex.tp.reduces_per_dispatch(cfg.n_layers))
        recs.append(rec)
    return recs
