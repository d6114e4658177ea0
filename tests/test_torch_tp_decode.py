"""Committed multi-step decode (DESIGN.md §12) and speculative decode (§18)
on the port's sharded data plane (§17), on gloo process groups on the CPU.

Each case serves the same prompts as ``tests/test_torch_tp.py`` through
the sharded executor with ``commit_horizon`` or ``speculate`` set, and is
held to:

* the **token stream** of the JAX package's single-device
  ``mode="sequential"`` executor (the JAX TP executor cannot be the oracle,
  ROADMAP §C): greedy tokens, so every multi-step and speculative path
  must emit them exactly;
* the port's single-device run (TP 1) of the same ``EngineConfig`` and
  draft on the model clock (``ModelTimedMultiExecutor``): plans,
  deferrals, VTC counters and the speculative counters byte-equal;
* on every rank, one logged dispatch a step message, and each dispatch's
  all-reduces equal to ``TensorParallel.reduces_per_dispatch`` and to the
  closed form: 2·L + 2 a pass, ``horizon`` passes a committed horizon,
  and a speculative round's verify pass plus γ draft passes of 2·n + 2
  (a ``TruncatedSelfDraft`` of n layers) or none (a replicated
  ``SmallModelDraft``);
* no page leaked on any rank.

The multi-rank cases live here, in spawns of their own, apart from
``tests/test_torch_tp.py``'s: one spawn a TP degree (2, then 4), each
started on first use. Speculative horizons stay at 2 rounds (ROADMAP §C).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_reduced
from repro.models import ModelOpts, build_model
from repro_torch.engine.numerics import assert_same_decisions
from repro_torch.launch.mesh import spawn
from repro_torch.models import params_from_numpy

import torch_tp_ranks as R
from test_torch_tp import SEED, _jax_sequential, _prompts

STABLELM = ("stablelm-3b", {"window": None})
MIXTRAL = ("mixtral-8x7b", {"window": None})
DRAFT_LAYERS = 1                 # the truncated self-draft's depth
GAMMA = 2

# name: (target, case options)
CASES = {
    "stablelm_fp32_multi": (STABLELM, {"commit_horizon": 4}),
    "stablelm_int8_multi": (STABLELM, {"commit_horizon": 4,
                                       "kv_dtype": "int8"}),
    "stablelm_self_draft": (STABLELM, {
        "commit_horizon": 2, "speculate": GAMMA,
        "draft": ("truncated", DRAFT_LAYERS)}),
    "stablelm_self_draft_reject": (STABLELM, {
        "commit_horizon": 2, "speculate": GAMMA,
        "draft": ("truncated", DRAFT_LAYERS), "force_reject": True}),
    "stablelm_small_draft": (STABLELM, {
        "commit_horizon": 2, "speculate": GAMMA, "draft": "small"}),
    "mixtral_exact_multi": (MIXTRAL, {"commit_horizon": 4}),
}
# the cases of each spawn
RUNS = {2: ["stablelm_fp32_multi", "stablelm_int8_multi",
            "stablelm_self_draft", "stablelm_self_draft_reject",
            "stablelm_small_draft", "mixtral_exact_multi"],
        4: ["stablelm_fp32_multi"]}
# each spawn's time limit in seconds: at least 4 x its wall time in a full
# tier-1 run with 6 xdist workers (7.8 s at TP 2, 8.5 s at TP 4), at most
# 600
TIMEOUT = {2: 120, 4: 120}
CELLS = [(tp, name) for tp, names in RUNS.items() for name in names]


def _init(arch: str, overrides: dict, seed: int):
    cfg = dataclasses.replace(get_reduced(arch), **overrides)
    params = build_model(cfg, ModelOpts(attn_impl="dense")).init(
        jax.random.PRNGKey(seed))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def world():
    """Per case: the case sent to the ranks, the JAX single-device
    sequential stream, and the port's TP 1 run of the same engine
    settings and draft on the model clock (its ``drive_case`` record and
    executor)."""
    cases, oracle, single = {}, {}, {}
    targets, jax_runs = {}, {}
    # the separate draft: stablelm's reduced arch at one layer, own weights
    small = (STABLELM[0], {**STABLELM[1], "n_layers": 1},
             _init(STABLELM[0], {**STABLELM[1], "n_layers": 1}, 42)[2])
    for name, ((arch, overrides), opts) in CASES.items():
        if arch not in targets:
            targets[arch] = _init(arch, overrides, 0)
        cfg, jparams, nparams = targets[arch]
        prompts = _prompts(cfg.vocab, SEED)
        if opts.get("draft") == "small":
            opts = {**opts, "draft": ("small", *small)}
        case = {"arch": arch, "overrides": overrides, "params": nparams,
                "prompts": prompts, **opts}
        cases[name] = case
        key = (arch, case.get("kv_dtype", "fp32"))
        if key not in jax_runs:
            jax_runs[key] = _jax_sequential(cfg, jparams, prompts, key[1])
        oracle[name] = jax_runs[key]
        ex = R.executor(R.case_cfg(case), params_from_numpy(nparams, "cpu"),
                        None, case)
        R.install_draft(ex, case)
        single[name] = (R.drive_case(ex, case, 1), ex)
    return cases, oracle, single


@pytest.fixture(scope="module")
def runs(world):
    """``runs(tp)``: {case: [record of each rank]} from one spawn of
    ``tp`` ranks, started on the first call."""
    cases, done = world[0], {}

    def get(tp: int) -> dict:
        if tp not in done:
            names = RUNS[tp]
            per_rank = spawn(R.run_cases, tp, "gloo",
                             [dict(cases[n], cost_shards=tp) for n in names],
                             timeout=TIMEOUT[tp])
            done[tp] = {n: [recs[i] for recs in per_rank]
                        for i, n in enumerate(names)}
        return done[tp]
    return get


def _kinds(case: dict) -> set:
    return {"spec"} if case.get("speculate") else {"multi"}


@pytest.mark.parametrize("name", CASES)
def test_tp1_reference_matches_jax_sequential(world, name):
    """The port's single-device run of each case (the decisions'
    reference) emits the JAX stream too, through the same path."""
    rec, ex = world[2][name]
    assert rec["tokens"] == world[1][name]
    assert _kinds(world[0][name]) <= {k[0] for k in ex.compile_keys}


@pytest.mark.parametrize("tp,name", CELLS)
def test_tokens_match_jax_sequential(world, runs, tp, name):
    """Every multi-step and speculative stream under TP equals the JAX
    single-device sequential stream, and the run took its path."""
    got = runs(tp)[name][0]
    assert got["n_shards"] == tp
    assert got["tokens"] == world[1][name], f"TP={tp} {name} diverged"
    assert all(len(t) == 5 for t in got["tokens"].values())
    assert _kinds(world[0][name]) <= {k for k, _, _ in got["log"]}


@pytest.mark.parametrize("tp,name", CELLS)
def test_decisions_byte_equal_to_tp1(world, runs, tp, name):
    """At per-shard budgets (``cost_shards`` = TP) on the model clock,
    plans, deferral sets, VTC counters, engine steps and the speculative
    counters (rounds, accepted, drafted) equal TP 1's."""
    got = runs(tp)[name][0]
    ref = world[2][name][0]
    assert_same_decisions(ref["trace"], got["trace"],
                          label=f"TP=1 vs TP={tp} {name}")
    assert got["vtc"] == ref["vtc"]
    assert got["steps"] == ref["steps"]
    assert got["spec"] == ref["spec"]
    case = world[0][name]
    if case.get("speculate"):
        assert got["spec"][2] > 0
        if case.get("force_reject"):
            assert got["spec"][1] == 0


@pytest.mark.parametrize("tp,name", CELLS)
def test_dispatches_and_all_reduces_match_derivation(world, runs, tp,
                                                     name):
    """Every rank runs rank 0's dispatches, in order, and its multi-step
    and speculative loops produce rank 0's tokens and acceptances; each
    dispatch runs the all-reduces the derivation gives:
    ``reduces_per_dispatch`` and the closed form, summing to the rank's
    count."""
    recs = runs(tp)[name]
    case = world[0][name]
    n_layers = R.case_cfg(case).n_layers
    one_pass = lambda layers: 2 * layers + 2
    draft = case.get("draft")
    draft_pass = (one_pass(draft[1]) if draft and draft[0] == "truncated"
                  else 0)
    r0 = recs[0]
    assert r0["dispatches"] == len(r0["log"]) == \
        world[2][name][1].n_dispatches
    for r in recs:
        assert [(k, key) for k, key, _ in r["log"]] == \
            [(k, key) for k, key, _ in r0["log"]]
        assert r["dispatches"] == len(r["log"])
        for (kind, key, n), derived in zip(r["log"], r["derived"]):
            if kind == "multi":
                want = key[0] * one_pass(n_layers)
            elif kind == "spec":
                want = key[0] * (one_pass(n_layers) + key[1] * draft_pass)
            else:
                want = one_pass(n_layers)
            assert n == derived == want, (kind, key)
        assert r["all_reduces"] == sum(n for _, _, n in r["log"])


@pytest.mark.parametrize("tp,name", CELLS)
def test_no_pages_leak(world, runs, tp, name):
    """Every reservation (the optimistic speculative one included) comes
    back: each rank's allocator holds all but the trash page."""
    assert {r["free_blocks"] for r in runs(tp)[name]} == {R.NUM_PAGES - 1}
    assert world[2][name][1].alloc.free_blocks == R.NUM_PAGES - 1


def test_small_draft_backfills_on_every_rank(world, runs):
    """The replicated draft's backfill chunks run on every rank (from the
    step message), as many as TP 1 runs, and no collective."""
    recs = runs(2)["stablelm_small_draft"]
    want = world[2]["stablelm_small_draft"][1].draft.n_backfill_dispatches
    assert want > 0
    assert [r["backfills"] for r in recs] == [want] * 2


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for tp in RUNS
                   for recs in runs(tp).values() for r in recs)
