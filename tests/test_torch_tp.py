"""The port's sharded data plane (DESIGN.md §17) on gloo process groups on
the CPU, held to the JAX package's single-device sequential stream.

The JAX TP suite (``tests/test_tp_executor.py``) cannot be the oracle: it
stops where JAX indexes the vocab-sharded embedding. So, as there, the bar
is the **token stream** of JAX's ``mode="sequential"`` executor on one
device: under TP the o-proj and FFN-down sums add the ranks' partial
products in another order, so logits agree only to reassociation, and the
greedy tokens must be equal, for fp32 and int8 KV, dense and MoE (``exact``).
Under ``capacity`` the port's single-device fused run is the reference on
the same plans (capacity drops follow the packing). Also pinned: one
dispatch a step, 2·L + 2 all-reduces a dispatch on every rank, scheduler
decisions byte-equal across TP 1, 2 and 4 on the model clock, the
replicated-KV guard, and the refusals of ROADMAP A13b. The multi-step and
speculative paths under a mesh are ``tests/test_torch_tp_decode.py``'s.

``spawn`` starts each TP degree once (2, then 4 ranks) and every case runs
inside it (``torch_tp_ranks.run_cases``); the ranks import no JAX and get
numpy weights and prompts from here.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jeng
from repro.configs import get_reduced
from repro.engine import numerics as jnum
from repro.models import ModelOpts, build_model
from repro_torch.launch.mesh import spawn
from repro_torch.models import params_from_numpy

import torch_tp_ranks as R

SEED = 1


def _prompts(vocab: int, seed: int, n: int = 5, max_prompt: int = 40):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, 1 + (7 * i + seed)
                                          % max_prompt)] for i in range(n)]


# name: (arch, config overrides, case options)
CASES = {
    "stablelm_fp32": ("stablelm-3b", {"window": None}, {}),
    "stablelm_int8": ("stablelm-3b", {"window": None}, {"kv_dtype": "int8"}),
    "stablelm_sequential": ("stablelm-3b", {"window": None},
                            {"mode": "sequential"}),
    "mixtral_exact": ("mixtral-8x7b", {"window": None}, {}),
    "kimi_exact": ("kimi-k2-1t-a32b", {"window": None}, {}),
    "mixtral_capacity": ("mixtral-8x7b", {"window": None},
                         {"moe_impl": "capacity"}),
    # Hkv 2 at TP 4: the guard replicates the KV heads; window 16 kept
    "h2o_fp32": ("h2o-danube-1.8b", {}, {}),
    # an odd vocab and d_ff: the guards replicate both, so only the o-proj
    # all-reduces
    "stablelm_replicated": ("stablelm-3b",
                            {"window": None, "vocab": 255, "d_ff": 129}, {}),
}
# the cases of each spawn, in order
RUNS = {2: ["stablelm_fp32", "stablelm_int8", "stablelm_sequential",
            "mixtral_exact", "kimi_exact", "mixtral_capacity",
            "stablelm_replicated"],
        4: ["stablelm_fp32", "stablelm_int8", "h2o_fp32"]}


def _jax_sequential(cfg, params, prompts, kv_dtype: str) -> dict:
    """The JAX package's single-device sequential stream on the model
    clock."""
    ex = jeng.PagedTransformerExecutor(
        cfg, params, num_pages=R.NUM_PAGES, page_size=R.PAGE,
        max_pages_per_seq=R.MAX_PAGES, mode="sequential", kv_dtype=kv_dtype)
    sched = jcore.make_scheduler(
        "fairbatching", jcore.LinearCostModel(a=1e-4, b=1e-6, c=1e-10))
    eng = jeng.Engine(sched, jnum.ModelTimedExecutor(
        ex, jcore.LinearCostModel(a=1e-3, b=1e-4, c=0.0)),
        jeng.EngineConfig(ttft_slo=5.0, tpot_slo=5.0))
    for i, t in enumerate(prompts):
        eng.submit(jeng.Request(i, arrival=0.002 * i, prompt_len=len(t),
                                max_new_tokens=5, ttft_slo=5.0, tpot_slo=5.0,
                                tokens=list(t)))
    n = 0
    while eng.has_work and n < 400:
        eng.step()
        n += 1
    assert not eng.has_work
    return {rid: list(r.generated_tokens) for rid, r in eng.requests.items()}


@pytest.fixture(scope="module")
def world():
    """Per case: the case sent to the ranks, the JAX oracle's tokens (or
    for ``capacity`` the port's single-device fused tokens), and the
    port's single-device sequential run on the model clock (TP = 1)."""
    cases, oracle, single = {}, {}, {}
    models, jax_runs = {}, {}
    for name, (arch, overrides, opts) in CASES.items():
        cfg = dataclasses.replace(get_reduced(arch), **overrides)
        arch_key = (arch, tuple(sorted(overrides.items())))
        if arch_key not in models:
            model = build_model(cfg, ModelOpts(attn_impl="dense"))
            jparams = model.init(jax.random.PRNGKey(0))
            models[arch_key] = (jparams, jax.tree.map(np.asarray, jparams))
        jparams, nparams = models[arch_key]
        prompts = _prompts(cfg.vocab, SEED)
        case = {"arch": arch, "overrides": overrides, "params": nparams,
                "prompts": prompts, **opts}
        cases[name] = case
        tcfg = R.case_cfg(case)
        tparams = params_from_numpy(nparams, "cpu")
        if opts.get("moe_impl") == "capacity":
            ex = R.executor(tcfg, tparams, None, case)      # fused
            oracle[name] = R.drive(ex, prompts, 1)[0]
        else:
            key = (arch_key, opts.get("kv_dtype", "fp32"))
            if key not in jax_runs:
                jax_runs[key] = _jax_sequential(cfg, jparams, prompts,
                                                key[1])
            oracle[name] = jax_runs[key]
        ex = R.executor(tcfg, tparams, None, {**case, "mode": "sequential"})
        single[name] = R.drive(ex, prompts, 1)
    return cases, oracle, single


@pytest.fixture(scope="module")
def runs(world):
    """{tp: {case: [record of each rank]}} from one spawn a TP degree."""
    cases = world[0]
    out = {}
    for tp, names in RUNS.items():
        for_ranks = [dict(cases[n], cost_shards=tp) for n in names]
        for_ranks.append({**cases["stablelm_fp32"], "refusals": True})
        per_rank = spawn(R.run_cases, tp, "gloo", for_ranks, timeout=240)
        out[tp] = {n: [recs[i] for recs in per_rank]
                   for i, n in enumerate(names + ["refusals"])}
    return out


TOKEN_CASES = [(tp, n) for tp, names in RUNS.items() for n in names
               if n != "mixtral_capacity"]


@pytest.mark.parametrize("tp,name", TOKEN_CASES)
def test_tp_tokens_match_jax_sequential(world, runs, tp, name):
    """Fused (and sequential) token streams under TP equal the JAX
    single-device sequential stream: dense fp32 and int8 KV, MoE exact,
    the replicated-KV guard."""
    got = runs[tp][name][0]
    assert got["n_shards"] == tp
    assert got["tokens"] == world[1][name], f"TP={tp} {name} diverged"
    assert all(len(t) == 5 for t in got["tokens"].values())


def test_tp_capacity_matches_single_device_fused(world, runs):
    """``capacity`` at TP 2 (experts split 2 a rank, dispatch from the
    replicated router) gives the single-device fused run's tokens on the
    same plans (the model clock makes them so)."""
    got = runs[2]["mixtral_capacity"][0]
    ref = world[1]["mixtral_capacity"]
    assert got["tokens"] == ref
    assert got["trace"].fingerprint() == \
        world[2]["mixtral_capacity"][1].fingerprint()


@pytest.mark.parametrize("tp", sorted(RUNS))
def test_one_dispatch_per_step_under_tp(runs, tp):
    """Sharding does not multiply launches: one dispatch a fused engine
    step on rank 0, and every rank replays each dispatch."""
    for name, recs in runs[tp].items():
        if name == "refusals" or "sequential" in name:
            continue
        assert recs[0]["steps"] > 5
        assert recs[0]["dispatches"] == recs[0]["steps"], name
        assert {r["dispatches"] for r in recs} == {recs[0]["dispatches"]}


@pytest.mark.parametrize("tp", sorted(RUNS))
def test_all_reduces_per_dispatch(world, runs, tp):
    """2·L + 2 all-reduces a dispatch on every rank where every dimension
    is sharded: the embedding, one after each o-proj and each FFN-down or
    MoE combine, the logits (sequential chunk and decode dispatches
    included). A replicated vocab and FFN run none: L a dispatch."""
    for name, recs in runs[tp].items():
        if name == "refusals":
            continue
        n_layers = R.case_cfg(world[0][name]).n_layers
        want = n_layers if name == "stablelm_replicated" else 2 * n_layers + 2
        for r in recs:
            assert r["per_dispatch"] == want, name
            assert r["all_reduces"] == want * r["dispatches"], name


def test_scheduler_decisions_byte_equal_across_tp(world, runs):
    """At per-shard budgets (``cost_shards`` = TP) on the model clock,
    plans, deferral sets and VTC counters are byte-equal across TP 1, 2
    and 4: the data plane's parallelism never reaches the control
    plane."""
    tok1, trace1, vtc1, _ = world[2]["stablelm_fp32"]
    for tp in (2, 4):
        rec = runs[tp]["stablelm_fp32"][0]
        assert rec["tokens"] == tok1
        jnum.assert_same_decisions(trace1, rec["trace"],
                                   label=f"TP=1 vs TP={tp}")
        assert rec["vtc"] == vtc1


def test_kv_heads_a_rank(runs):
    """The pools hold Hkv/TP heads a rank (stablelm: 4 at TP 2 → 2, at
    TP 4 → 1), and every head where TP does not divide Hkv (h2o reduced:
    Hkv 2 at TP 4)."""
    assert {r["kv_heads"] for r in runs[2]["stablelm_fp32"]} == {2}
    assert {r["kv_heads"] for r in runs[4]["stablelm_fp32"]} == {1}
    assert {r["kv_heads"] for r in runs[4]["h2o_fp32"]} == {2}


@pytest.mark.parametrize("tp", sorted(RUNS))
def test_mesh_refusals(runs, tp):
    """ROADMAP A13b's paths raise ``NotImplementedError`` naming it: the
    prefix cache, KV migration both ways, and (at 4 ranks) a data axis of
    2. Multi-step and speculative decode run under a mesh
    (``tests/test_torch_tp_decode.py``)."""
    want = {"attach_cache", "capture_kv",
            "install_kv_pages"} | ({"data_axis"} if tp == 4 else set())
    for rec in runs[tp]["refusals"]:
        got = rec["refusals"]
        assert set(got) == want
        assert all(msg is not None and "A13b" in msg
                   for msg in got.values()), got


def test_ranks_import_no_jax(runs):
    assert not any(r["jax_imported"] for recs in runs.values()
                   for name, rs in recs.items() if name != "refusals"
                   for r in rs)
