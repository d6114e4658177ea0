"""The port's step cost analysis (``src/repro_torch/launch/cost_analysis.py``)
against the JAX package's HLO analysis, and the abstract route of the
kernel wrappers.

FLOPs: one reduced cell of each family and mode (dense train, prefill and
decode; MoE prefill and decode; SSM train and prefill; hybrid prefill;
the encoder-decoder's decode), at small shapes added to both packages'
``SHAPES``, the JAX cell built ``for_analysis`` and lowered on a mesh with
``Auto`` axes (the reference's own ``make_mesh`` axes are ``Explicit`` on
this JAX and cannot lower a cell: ROADMAP §C). The port's FLOPs equal
JAX's dot FLOPs within 1 % once two named terms are taken out of both,
each pinned to its size:

  * the cross-entropy head: JAX pads the tokens to whole ``ce_chunk``
    chunks and XLA folds the one-chunk map's recomputation into its
    forward, 3 × 2·⌈T/c⌉c·d·V; the port runs the T tokens, forward,
    recomputation, dh and dW, 4 × 2·T·d·V;
  * the SSD chunk scan: JAX's einsums over every (i, j) pair of a chunk,
    the dots of ``ssd_chunked`` (and its VJP) lowered alone, once a
    Mamba2 block; the port's B5 by ``kernels.bounds`` (the causal pairs).

Per-rank argument bytes equal JAX's ``memory_analysis()`` on a 2 × 2 mesh
of host devices for a decode and a train cell. Then the ideas of
``tests/test_hlo_analysis.py``, the peak of live storages, collectives,
and B4 and B5 on ``meta`` tensors against the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType

import repro.configs as jconfigs
import repro.launch.steps as jsteps
from repro.configs.base import ShapeConfig as JShape
from repro.launch.hlo_analysis import analyze as janalyze
from repro.models.mamba2 import ssd_chunked as jssd
import repro_torch.configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import bounds, ref
from repro_torch.kernels import mamba2_scan as scan_mod
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh

SMALL = {"t_small": (256, 2, "train"), "p_small": (256, 2, "prefill"),
         "d_small": (256, 2, "decode")}
FLOP_CELLS = [("h2o-danube-1.8b", "t_small"), ("h2o-danube-1.8b", "p_small"),
              ("h2o-danube-1.8b", "d_small"), ("mixtral-8x7b", "p_small"),
              ("mixtral-8x7b", "d_small"), ("mamba2-1.3b", "t_small"),
              ("mamba2-1.3b", "p_small"), ("zamba2-2.7b", "p_small"),
              ("seamless-m4t-large-v2", "d_small")]
ONE = Mesh.abstract((1, 1), ("data", "model"))


@pytest.fixture
def small_shapes(monkeypatch):
    for name, (s, b, kind) in SMALL.items():
        monkeypatch.setitem(jconfigs.SHAPES, name, JShape(name, s, b, kind))
        monkeypatch.setitem(tconfigs.SHAPES, name,
                            ShapeConfig(name, s, b, kind))


def _auto_mesh(shape):
    names = ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * 2)


def _ce_terms(cfg, shape):
    """(JAX, port) FLOPs of the cross-entropy head's products."""
    s = jconfigs.SHAPES[shape]
    t = s.global_batch * (s.seq_len - 1)
    c = jsteps._model_opts(cfg, "train").ce_chunk
    unit = 2 * cfg.d_model * cfg.vocab
    return 3 * unit * (-(-t // c) * c), 4 * unit * t


def _jax_ssd_term(cfg, shape):
    """JAX's dot FLOPs of one block's SSD scan at the cell's shapes, from
    a state passed in (a zero one in the model's prefill); in training the
    forward and its VJP, without one. Every operand is an argument, so
    that XLA folds no product with a constant."""
    s = jconfigs.SHAPES[shape]
    sc = cfg.ssm
    h, p, n = sc.n_heads(cfg.d_model), sc.head_dim, sc.d_state
    b, t = s.global_batch, s.seq_len
    chunk = min(sc.chunk, t)
    arg = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    xs = (arg(b, t, h, p), arg(b, t, h), arg(b, t, n), arg(b, t, n))
    if s.kind == "train":
        def fn(x, a, bm, cm, dy):
            y, vjp = jax.vjp(lambda *z: jssd(*z, chunk)[0], x, a, bm, cm)
            return y, vjp(dy)
        xs += (arg(b, t, h, p),)
    else:
        def fn(x, a, bm, cm, s0):
            return jssd(x, a, bm, cm, chunk, s0)
        xs += (arg(b, h, p, n),)
    return janalyze(jax.jit(fn).lower(*xs).compile().as_text())["flops"]


@pytest.mark.parametrize("arch,shape", FLOP_CELLS)
def test_flops_match_jax_dot_flops(small_shapes, arch, shape):
    want = janalyze(jsteps.build_cell(
        arch, shape, _auto_mesh((1, 1)), reduced=True,
        for_analysis=True).lower().compile().as_text())["flops"]
    cell = steps.build_cell(arch, shape, ONE, reduced=True,
                            for_analysis=True)
    got = ca.analyze(cell.fn, *cell.abstract_args())
    cfg = cell.arch
    if cell.mode == "train":
        j_ce, p_ce = _ce_terms(cfg, shape)
        want, got_f = want - j_ce, got["flops"] - p_ce
    else:
        got_f = got["flops"]
    if cfg.ssm is not None:
        kern = sum(k["flops"] for k in got["kernels"].values())
        assert set(got["kernels"]) <= {"mamba2_scan", "mamba2_scan_backward"}
        want -= cfg.n_layers * _jax_ssd_term(cfg, shape)
        got_f -= kern
        assert kern > 0
    assert abs(got_f - want) <= 0.01 * want, (got_f, want)


def test_b5_term_is_the_bound_formula(small_shapes):
    """The port's SSD term: per block one B5 call, at scan_bound's FLOPs
    for the chunks of the prompt, from a zero state (an initial state
    passed: C · state in every chunk)."""
    cell = steps.build_cell("mamba2-1.3b", "p_small", ONE, reduced=True)
    got = ca.analyze(cell.fn, *cell.abstract_args())["kernels"]
    cfg = cell.arch
    sc = cfg.ssm
    nc = 256 // sc.chunk
    one = bounds.scan_bound(2, nc, sc.chunk, sc.n_heads(cfg.d_model),
                            sc.head_dim, sc.d_state, nc, 4, 2)
    assert got == {"mamba2_scan": {"calls": cfg.n_layers,
                                   "flops": cfg.n_layers * one["flops"],
                                   "bytes": cfg.n_layers * one["bytes"]}}


@pytest.mark.parametrize("arch,shape", [("h2o-danube-1.8b", "d_small"),
                                        ("h2o-danube-1.8b", "t_small")])
def test_rank_argument_bytes_match_jax(small_shapes, host_devices, arch,
                                       shape):
    """Rank (0, 0) of a 2 × 2 mesh: the port's ``rank_shapes`` bytes, the
    dry run's ``argument_bytes``, against XLA's per-device arguments."""
    want = jsteps.build_cell(arch, shape, _auto_mesh((2, 2)),
                             reduced=True).lower().compile()
    want = want.memory_analysis().argument_size_in_bytes
    cell = steps.build_cell(arch, shape, Mesh.abstract((2, 2),
                                                       ("data", "model")),
                            reduced=True)
    got = ca.tree_bytes(cell.rank_shapes({"data": 0, "model": 0}))
    assert got == want
    assert ca.tree_bytes(cell.abstract_args()) > got


# --------------------------------------------------------------------------
# the ideas of tests/test_hlo_analysis.py
# --------------------------------------------------------------------------

def test_tree_bytes():
    t = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    assert ca.tree_bytes(t((16, 1024), torch.bfloat16)) == 16 * 1024 * 2
    assert ca.tree_bytes(t((), torch.float32)) == 4
    assert ca.tree_bytes({"a": t((8, 8), torch.float32),
                          "b": [t((4,), torch.int32)]}) == 8 * 8 * 4 + 16


def test_single_matmul_against_its_formula():
    m, k, n = 96, 64, 40
    x = torch.empty(m, k, device="meta")
    w = torch.empty(k, n, device="meta")
    r = ca.analyze(torch.matmul, x, w)
    assert r["flops"] == 2 * m * k * n
    assert r["bytes"] == 4 * (m * k + k * n + m * n)
    assert r["output_bytes"] == 4 * m * n and r["alias_bytes"] == 0


def test_loop_of_layers_counts_each_layer(small_shapes):
    """An eager loop dispatches every iteration: L layers count L × one
    layer, in a bare loop and in a ``DecoderLM`` prefill."""
    def f(x, reps):
        for _ in range(reps):
            x = torch.tanh(x @ x)
        return x
    x = torch.empty(128, 128, device="meta")
    one = ca.analyze(f, x, 1)["flops"]
    assert one == 2 * 128 ** 3
    assert ca.analyze(f, x, 8)["flops"] == 8 * one
    flops = [ca.analyze(c.fn, *c.abstract_args())["flops"] for c in (
        steps.build_cell("mixtral-8x7b", "p_small", ONE, reduced=True,
                         layers=n) for n in (1, 2, 5))]
    assert flops[2] - flops[0] == 4 * (flops[1] - flops[0])


def test_peak_counts_live_storages():
    """Arguments resident from the start; a temporary lives until its last
    tensor dies; an in-place update allocates nothing."""
    a = torch.empty(1000, device="meta")

    def f(x):
        for _ in range(3):
            y = x * 2                   # 4000 bytes, freed each turn
            del y
        x.add_(1)                       # in place
        return x, x + 1
    r = ca.analyze(f, a)
    assert r["argument_bytes"] == 4000
    assert r["peak_bytes"] == 8000
    assert r["output_bytes"] == 8000 and r["alias_bytes"] == 4000
    assert r["temp_bytes"] == 0


def test_collectives_are_counted(tmp_path):
    # a file store: no port that a parallel worker could take first
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.ones(64)
        r = ca.analyze(lambda t: dist.all_reduce(t), x)
    finally:
        dist.destroy_process_group()
    (name, c), = r["collectives"].items()
    assert "allreduce" in name and c["count"] == 1
    assert c["bytes"] >= 64 * 4


# --------------------------------------------------------------------------
# the kernels' abstract route
# --------------------------------------------------------------------------

def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("c", [8, 160])
def test_b4_meta_route_matches_cpu(monkeypatch, c):
    e, k, n = 4, 64, 96
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(e, c, k, generator=g), torch.randn(e, k, n,
                                                          generator=g)
    calls = _spy(monkeypatch, ref, "moe_gmm_ref")
    before = gmm_mod.moe_gmm.launches
    cpu = ca.analyze(gmm_mod.moe_gmm, x, w)
    assert len(calls) == 1                       # the CPU takes ref.py
    meta = ca.analyze(gmm_mod.moe_gmm, x.to("meta"), w.to("meta"))
    assert len(calls) == 1                       # meta does not
    assert gmm_mod.moe_gmm.launches == before    # and nothing launched
    assert meta["output"].shape == cpu["output"].shape == (e, c, n)
    assert meta["output"].device.type == "meta"
    assert meta["flops"] == cpu["flops"] == 2 * e * c * k * n
    assert meta["kernels"] == cpu["kernels"] == {"moe_gmm": {
        "calls": 1, **{key: bounds.gmm_bound(e, c, k, n)[key]
                       for key in ("flops", "bytes")}}}
    # the split-K scratch of a decode capacity is allocated on meta too
    plan = gmm_mod.gmm_plan(e, c, k, n)
    scratch = 0 if plan.scratch is None else 4 * int(np.prod(plan.scratch))
    assert meta["peak_bytes"] == (meta["argument_bytes"]
                                  + meta["output_bytes"] + scratch)


@pytest.mark.parametrize("init", [False, True])
def test_b5_meta_route_matches_cpu(monkeypatch, init):
    bsz, nc, l, h, p, n = 2, 3, 16, 4, 8, 16
    g = torch.Generator().manual_seed(1)
    xdt = torch.randn(bsz, nc, l, h, p, generator=g, requires_grad=True)
    a = torch.randn(bsz, nc, l, h, generator=g).abs().neg() \
        .requires_grad_()
    b = torch.randn(bsz, nc, l, n, generator=g, requires_grad=True)
    c = torch.randn(bsz, nc, l, n, generator=g, requires_grad=True)
    s0 = torch.zeros(bsz, h, p, n) if init else None

    def step(xdt, a, b, c, s0):
        y, st = scan_mod.MambaChunkScan.apply(xdt, a, b, c, s0,
                                              torch.float32)
        gs = torch.autograd.grad(y.sum(), (xdt, a, b, c))
        return y, st, gs
    fwd = _spy(monkeypatch, ref, "mamba_chunk_scan_ref")
    bwd = _spy(monkeypatch, ref, "mamba_chunk_scan_backward_ref")
    before = (scan_mod.mamba_chunk_scan.launches,
              scan_mod.mamba_chunk_scan_backward.launches)
    cpu = ca.analyze(step, xdt, a, b, c, s0)
    assert (len(fwd), len(bwd)) == (1, 1)
    meta_in = [t.detach().to("meta").requires_grad_() for t in (xdt, a, b, c)]
    meta = ca.analyze(step, *meta_in,
                      None if s0 is None else s0.to("meta"))
    assert (len(fwd), len(bwd)) == (1, 1)
    assert (scan_mod.mamba_chunk_scan.launches,
            scan_mod.mamba_chunk_scan_backward.launches) == before
    shapes = lambda r: [tuple(t.shape) for t in ca.tensor_leaves(
        r["output"])]
    assert shapes(meta) == shapes(cpu)
    assert meta["flops"] == cpu["flops"]
    fw = bounds.scan_bound(bsz, nc, l, h, p, n, nc - 1 + init)
    bw = bounds.scan_backward_bound(bsz, nc, l, h, p, n)
    assert meta["kernels"] == cpu["kernels"] == {
        "mamba2_scan": {"calls": 1, "flops": fw["flops"],
                        "bytes": fw["bytes"]},
        "mamba2_scan_backward": {"calls": 1, "flops": bw["flops"],
                                 "bytes": bw["bytes"]}}


def test_no_analysis_means_no_report():
    """Without an active analysis the hook is a no-op context."""
    assert bounds.counted("moe_gmm", lambda: 1 / 0) is bounds._NOTHING
