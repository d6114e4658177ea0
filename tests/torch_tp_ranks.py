"""Rank bodies of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_decode.py``, run in the processes that
``repro_torch.launch.mesh.spawn`` starts. This module imports torch and the
port, never JAX: the parent test computes the JAX oracle and hands each
rank numpy weights and prompts.

``run_cases(rank, world, cases)`` builds a ``1 × world`` mesh on the gloo
group and serves each case through the sharded executor: rank 0 drives an
``Engine`` with the fairbatching scheduler on the model clock
(``ModelTimedMultiExecutor``: committed horizons and speculative rounds
too) and stops the other ranks, which replay its dispatches in
``serve_worker``. A case may set ``commit_horizon``, ``speculate`` and a
``draft`` (and ``force_reject``), which every rank installs. Each rank
returns one record a case, with the log of the dispatches it ran.
"""
import dataclasses
import sys

import torch

from repro_torch.configs import get_reduced
from repro_torch.core import LinearCostModel, make_scheduler
from repro_torch.disagg.migration import capture_kv, install_kv_pages
from repro_torch.engine import (Engine, EngineConfig, PagedTransformerExecutor,
                                Request)
from repro_torch.engine.numerics import (ModelTimedMultiExecutor,
                                         capture_schedule, vtc_counters)
from repro_torch.engine.spec_decode import SmallModelDraft, TruncatedSelfDraft
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


def make_draft(case: dict):
    """The case's draft adapter, a new one for each rank (or None):
    ``("truncated", n_layers)`` or ``("small", arch, overrides, numpy
    params)``."""
    spec = case.get("draft")
    if spec is None:
        return None
    if spec[0] == "truncated":
        return TruncatedSelfDraft(spec[1])
    _, arch, overrides, params = spec
    return SmallModelDraft(
        dataclasses.replace(get_reduced(arch), **overrides),
        params_from_numpy(params, "cpu"))


def install_draft(ex, case: dict) -> None:
    draft = make_draft(case)
    if draft is not None:
        ex.set_draft(draft)
        ex.spec_force_reject = case.get("force_reject", False)


def serve(ex, prompts: list, cost_shards: int, max_steps: int = 400, *,
          commit_horizon: int = 1, speculate: int = 0):
    """Serve ``prompts`` on ``ex`` (rank 0 of a mesh, or one device) on
    the model clock; returns the engine and its decision trace."""
    sched = make_scheduler("fairbatching", SCHED_MODEL)
    eng = Engine(sched, ModelTimedMultiExecutor(ex, CLOCK),
                 EngineConfig(ttft_slo=5.0, tpot_slo=5.0,
                              cost_shards=cost_shards,
                              commit_horizon=commit_horizon,
                              speculate=speculate))
    for r in requests(prompts):
        eng.submit(r)
    trace = capture_schedule(eng)
    n = 0
    while eng.has_work and n < max_steps:
        eng.step()
        n += 1
    if eng.has_work:
        raise AssertionError(f"engine still busy after {max_steps} steps")
    return eng, trace


def tokens_of(eng) -> dict:
    return {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}


def drive(ex, prompts: list, cost_shards: int, max_steps: int = 400):
    """``serve``; returns (tokens by request, decision trace, VTC
    counters, engine steps)."""
    eng, trace = serve(ex, prompts, cost_shards, max_steps)
    return tokens_of(eng), trace, vtc_counters(eng), len(eng.steps)


def drive_case(ex, case: dict, cost_shards: int) -> dict:
    """``serve`` at the case's prompts and engine settings; returns the
    tokens, trace, VTC counters, engine steps and the speculative
    counters (rounds, accepted, drafted)."""
    eng, trace = serve(ex, case["prompts"], cost_shards,
                       commit_horizon=case.get("commit_horizon", 1),
                       speculate=case.get("speculate", 0))
    return {"tokens": tokens_of(eng), "trace": trace,
            "vtc": vtc_counters(eng), "steps": len(eng.steps),
            "spec": (eng.spec_rounds, eng.spec_accepted, eng.spec_drafted)}


# the step bodies a dispatch runs, by the kind the log names it
STEP_BODIES = {"_fused_step": "fused", "_chunk_step": "chunk",
               "_decode_step": "decode", "_multi_decode_step": "multi",
               "_spec_multi_step": "spec"}


def log_dispatches(ex) -> list:
    """Wrap ``ex``'s step bodies (a sharded executor's): each dispatch
    appends (kind, key, the all-reduces it ran) to the returned list; the
    key is the horizon of a ``multi`` and (rounds, γ) of a ``spec``,
    followed by the tokens (and a ``spec``'s emission counts) the rank's
    loop produced."""
    log = []
    for name, kind in STEP_BODIES.items():
        def run(*a, _body=getattr(ex, name), _kind=kind, **kw):
            n0 = ex.tp.all_reduces
            out = _body(*a, **kw)
            key = (a[1:] if _kind == "multi" else
                   (kw["rounds"], kw["gamma"]) if _kind == "spec" else ())
            if key:
                key = (*key, out.tolist())
            log.append((_kind, tuple(key), ex.tp.all_reduces - n0))
            return out
        setattr(ex, name, run)
    return log


def _refusals(cfg, params, mesh, world: int) -> dict:
    """Each path the sharded executor refuses (ROADMAP A13b), by the
    error's message; no collective runs."""
    out = {}
    ex = executor(cfg, params, mesh, {})
    req = requests([[1, 2, 3]])[0]
    calls = {
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
        install_draft(ex, case)
        log = log_dispatches(ex)
        rec = {"n_shards": ex.n_shards,
               "kv_heads": ex.k_pages.shape[3],
               "jax_imported": "jax" in sys.modules}
        if rank == 0:
            rec.update(drive_case(ex, case, case.get("cost_shards", 1)))
            ex.stop_workers()
        else:
            assert ex.serve_worker() == ex.n_dispatches
        draft = case.get("draft")
        # a draft sharded like the target reduces over its layers; a
        # replicated one runs no collective
        draft_layers = (draft[1] if draft and draft[0] == "truncated"
                        else None)
        rec.update(dispatches=ex.n_dispatches,
                   all_reduces=ex.tp.all_reduces,
                   per_dispatch=ex.tp.reduces_per_dispatch(cfg.n_layers),
                   log=log,
                   derived=[ex.tp.reduces_per_dispatch(
                       cfg.n_layers, steps=key[0] if key else 1,
                       gamma=key[1] if kind == "spec" else 0,
                       draft_layers=draft_layers)
                       for kind, key, _ in log],
                   free_blocks=ex.alloc.free_blocks,
                   backfills=getattr(ex.draft, "n_backfill_dispatches", 0))
        recs.append(rec)
    return recs
