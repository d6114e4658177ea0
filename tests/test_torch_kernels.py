"""The port's paged-attention plain versions against the JAX package.

The same numpy inputs go through the port's ``paged_attention_ragged_ref``
and ``paged_attention_ref``, the JAX oracles and the Pallas kernels in
interpret mode, in fp32, at the JAX suite's own tolerance. The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); here the wrappers' CPU paths and argument checks and
the build's library naming are pinned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_batched
from repro.kernels.paged_attention import paged_attention_ragged as jax_kernel
from repro.kernels.ref import paged_attention_ragged_ref as jax_ref
from repro.kernels.ref import paged_attention_ref as jax_batched_ref
from repro_torch.kernels import _build
from repro_torch.kernels import mamba2_scan as tms
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ops import (paged_attention_op,
                                     paged_attention_ragged_op)
from repro_torch.kernels.ref import (paged_attention_ragged_ref,
                                     paged_attention_ref)

ATOL = 2e-4   # the JAX suite's fp32 bar (tests/test_kernels.py::_tol)

# (q_lens, pos0, H, Hkv, D, page, n_pages, window): the layouts of
# tests/test_kernels.py::test_paged_attention_ragged_sweep plus the
# full-width h2o-danube-1.8b head geometry (D=80, G=4)
LAYOUTS = [
    ([5, 1, 3], [10, 20, 0], 4, 2, 32, 16, 3, None),   # mixed chunk+decode
    ([1, 1, 1, 1], [7, 12, 0, 33], 8, 1, 64, 32, 2, None),  # decode, MQA
    ([16], [8], 4, 4, 32, 16, 4, None),                # one prefill chunk
    ([8, 2, 1], [4, 9, 30], 8, 2, 16, 8, 5, 12),       # SWA mix
    ([6, 1, 0, 1], [40, 150, 0, 300], 32, 8, 80, 128, 3, 64),  # D=80, G=4
]


def make_inputs(q_lens, pos0, H, Hkv, D, page, n_pages, seed=0, gap=3):
    """Numpy inputs of one ragged step; ``gap`` stream-padding rows at the
    end; a q_len of 0 is a pad sequence (context 0)."""
    rng = np.random.default_rng(seed)
    P = n_pages * 2 + 1
    S = len(q_lens)
    q_starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(sum(q_lens)) + gap
    ql = np.asarray(q_lens, np.int32)
    ctx = np.minimum(np.asarray(pos0, np.int32) + ql, page * n_pages)
    ctx = np.where(ql > 0, ctx, 0).astype(np.int32)
    return {
        "q": rng.standard_normal((T, H, D)).astype(np.float32),
        "k": rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        "v": rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        "bt": rng.integers(0, P, (S, n_pages)).astype(np.int32),
        "ctx": ctx,
        "qs": q_starts,
        "ql": ql,
        "p0": np.maximum(np.minimum(np.asarray(pos0, np.int32), ctx - ql),
                         0).astype(np.int32),
    }


ORDER = ("q", "k", "v", "bt", "ctx", "qs", "ql", "p0")


def run_torch(a, window, fn=paged_attention_ragged_ref):
    return fn(*(torch.from_numpy(a[k]) for k in ORDER),
              window=window).numpy()


def run_jax(a, window, fn):
    return np.asarray(fn(*(jnp.asarray(a[k]) for k in ORDER), window=window))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[:5]}")
def test_ragged_ref_matches_jax_kernel_and_oracle(layout):
    *shape, window = layout
    a = make_inputs(*shape)
    got = run_torch(a, window)
    oracle = run_jax(a, window, jax_ref)
    kernel = run_jax(a, window, lambda *x, window: jax_kernel(
        *x, window=window, interpret=True))
    assert np.abs(got - oracle).max() < ATOL
    assert np.abs(got - kernel).max() < ATOL
    n_rows = int(a["ql"].sum())
    assert got[n_rows:].shape[0] == 3
    assert np.all(got[n_rows:] == 0.0), "stream padding rows must be 0"


def test_ragged_ref_ignores_garbage_beyond_context():
    """Slots at or past context_len (allocator reuse) never reach the sum,
    in the port as in the JAX oracle."""
    a = make_inputs([3, 1], [13, 20], 4, 2, 16, 16, 2, seed=5)
    a["bt"] = np.asarray([[1, 2], [3, 4]], np.int32)
    clean = run_torch(a, None)
    for s in range(2):
        for kv in range(int(a["ctx"][s]), 32):
            pg, sl = a["bt"][s, kv // 16], kv % 16
            a["k"][pg, sl] = 1e4
            a["v"][pg, sl] = 1e4
    dirty = run_torch(a, None)
    assert np.abs(dirty - clean).max() < 1e-6
    assert np.abs(dirty - run_jax(a, None, jax_ref)).max() < ATOL


def test_row_with_no_visible_key_is_zero():
    """A sequence whose context is empty gives 0, not NaN."""
    a = make_inputs([2], [0], 4, 2, 16, 16, 1, gap=0)
    a["ctx"][:] = 0
    got = run_torch(a, None)
    assert np.all(got == 0.0)
    assert np.array_equal(got, run_jax(a, None, jax_ref))


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    a = make_inputs(*LAYOUTS[3][:-1])
    before = tpa.paged_attention_ragged.launches
    via_op = run_torch(a, 12, paged_attention_ragged_op)
    via_wrapper = run_torch(a, 12, tpa.paged_attention_ragged)
    assert np.array_equal(via_op, run_torch(a, 12))
    assert np.array_equal(via_wrapper, via_op)
    assert tpa.paged_attention_ragged.launches == before


def _tensors(q_shape=(8, 4, 16), pool=(5, 16, 2, 16), s=2, n_pages=3):
    return (torch.zeros(q_shape), torch.zeros(pool), torch.zeros(pool),
            torch.zeros((s, n_pages), dtype=torch.int32),
            {k: torch.zeros(s, dtype=torch.int32)
             for k in ("context_lens", "q_starts", "q_lens", "pos0")})


@pytest.mark.parametrize("bad, err", [
    (dict(q_shape=(8, 4, 18), pool=(5, 16, 2, 18)), ValueError),  # D % 4
    (dict(q_shape=(8, 4, 132), pool=(5, 16, 2, 132)), ValueError),  # D > 128
    (dict(q_shape=(8, 6, 16), pool=(5, 16, 2, 16)), ValueError),  # G = 3
    (dict(q_shape=(8, 4, 16), pool=(5, 16, 3, 16)), ValueError),  # H % Hkv
])
def test_wrapper_rejects_shapes_the_kernel_does_not_take(bad, err):
    q, k, v, bt, meta = _tensors(**bad)
    with pytest.raises(err):
        tpa._check(q, k, v, bt, meta)


def test_wrapper_rejects_types_and_layouts():
    q, k, v, bt, meta = _tensors()
    tpa._check(q, k, v, bt, meta)                 # the valid baseline
    with pytest.raises(TypeError):
        tpa._check(q.double(), k, v, bt, meta)
    with pytest.raises(TypeError):
        tpa._check(q, k, v, bt.long(), meta)
    with pytest.raises(ValueError):
        tpa._check(q.transpose(0, 1).contiguous().transpose(0, 1), k, v,
                   bt, meta)
    with pytest.raises(ValueError):
        tpa._check(q, k, v, bt, {**meta, "pos0": torch.zeros(
            3, dtype=torch.int32)})


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_build_names_libraries_by_source_digest(tmp_path, monkeypatch, name):
    """An edited source gets a new library name; without nvcc the build
    says so instead of loading a stale library."""
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert _build.library_path(name) == path
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_ctypes_signature_matches_the_c_launcher(name):
    """The wrapper's argtypes follow each extern "C" launcher's parameter
    list, type for type: ctypes would otherwise pass a cut pointer or
    refuse the call only on the card."""
    import ctypes
    import re
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    found = re.findall(rf'extern "C" int ({name}_\w+)\((.*?)\)', src, re.S)
    assert found, f"no launcher of {name}"
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    for symbol, params in found:
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params.split(",")]
        assert {**tpa._SIG, **tmg._SIG, **tms._SIG}[symbol] == want, symbol


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """The attention kernels include csrc/attention_body.cuh, and the
    digest covers every header: editing it renames every library (B4's
    and B5's too), so none loads a stale build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    hdr = csrc / "attention_body.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert set(before) == {"paged_attention", "paged_attention_ragged",
                           "paged_attention_ragged_quant", "moe_gmm",
                           "mamba2_scan"}
    assert all(before[n] != after[n] for n in before)


# -- batched paged attention (B3) --------------------------------------

# (B, Tq, H, Hkv, D, page, n_pages, window): the layouts of
# tests/test_kernels.py::test_paged_attention_sweep, then the full-width
# h2o-danube-1.8b head geometry (D=80, G=4) at decode, verify and chunk Tq
BATCHED = [
    (2, 1, 4, 2, 32, 16, 3, None),       # decode
    (3, 1, 8, 1, 64, 32, 4, None),       # MQA decode
    (1, 16, 4, 4, 32, 16, 4, None),      # prefill chunk, MHA
    (2, 8, 8, 2, 16, 8, 5, 12),          # SWA chunk
    (2, 1, 4, 2, 128, 128, 2, 64),       # TPU-aligned page/D
    (3, 1, 32, 8, 80, 128, 2, None),     # D=80 decode
    (2, 4, 32, 8, 80, 16, 6, None),      # D=80 verify (γ=3)
    (1, 16, 32, 8, 80, 128, 2, 100),     # D=80 chunk, window
]
BATCHED_ORDER = ("q", "k", "v", "bt", "ctx", "qs")


def make_batched_inputs(B, Tq, H, Hkv, D, page, n_pages, seed=0):
    """The JAX sweep's layout: contexts spread over the table, q at its
    end (q_starts = ctx - Tq)."""
    rng = np.random.default_rng(seed)
    P = n_pages * 2 + 1
    total = page * n_pages
    ctx = np.minimum([(total * (i + 1)) // (B + 1) + Tq for i in range(B)],
                     total).astype(np.int32)
    return {
        "q": rng.standard_normal((B, Tq, H, D)).astype(np.float32),
        "k": rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        "v": rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        "bt": rng.integers(0, P, (B, n_pages)).astype(np.int32),
        "ctx": ctx,
        "qs": (ctx - Tq).astype(np.int32),
    }


def run_batched(a, window, fn=paged_attention_ref):
    return fn(*(torch.from_numpy(a[k]) for k in BATCHED_ORDER),
              window=window).numpy()


def run_jax_batched(a, window, fn):
    return np.asarray(fn(*(jnp.asarray(a[k]) for k in BATCHED_ORDER),
                         window=window))


@pytest.mark.parametrize("layout", BATCHED, ids=lambda l: f"{l[:5]}")
def test_batched_ref_matches_jax_kernel_and_oracle(layout):
    *shape, window = layout
    a = make_batched_inputs(*shape)
    got = run_batched(a, window)
    oracle = run_jax_batched(a, window, jax_batched_ref)
    kernel = run_jax_batched(a, window, lambda *x, window: jax_batched(
        *x, window=window, interpret=True))
    assert got.shape == tuple(shape[:3]) + (shape[4],)
    assert np.abs(got - oracle).max() < ATOL
    assert np.abs(got - kernel).max() < ATOL


def test_batched_ref_ignores_garbage_beyond_context():
    """Slots at or past context_len never reach the sum, in the port as in
    the JAX oracle."""
    a = make_batched_inputs(2, 3, 4, 2, 16, 16, 2, seed=5)
    a["bt"] = np.asarray([[1, 2], [3, 4]], np.int32)
    clean = run_batched(a, None)
    for b in range(2):
        for kv in range(int(a["ctx"][b]), 32):
            pg, sl = a["bt"][b, kv // 16], kv % 16
            a["k"][pg, sl] = 1e4
            a["v"][pg, sl] = 1e4
    dirty = run_batched(a, None)
    assert np.abs(dirty - clean).max() < 1e-6
    assert np.abs(dirty - run_jax_batched(a, None, jax_batched_ref)).max() \
        < ATOL


def test_batched_row_with_no_visible_key_is_zero():
    """An empty context, or a window that ends before every key, gives 0
    (not NaN), as the Pallas flush's max(l, 1e-30) does."""
    a = make_batched_inputs(2, 2, 4, 2, 16, 16, 2)
    a["ctx"][0] = 0
    got = run_batched(a, None)
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))
    assert np.array_equal(got[0], run_jax_batched(a, None,
                                                  jax_batched_ref)[0])


def test_cpu_batched_wrapper_takes_plain_version_and_counts_nothing():
    a = make_batched_inputs(*BATCHED[3][:-1])
    before = tpa.paged_attention.launches
    via_op = run_batched(a, 12, paged_attention_op)
    via_wrapper = run_batched(a, 12, tpa.paged_attention)
    assert np.array_equal(via_op, run_batched(a, 12))
    assert np.array_equal(via_wrapper, via_op)
    assert tpa.paged_attention.launches == before


def _batched_tensors(q_shape=(2, 3, 4, 16), pool=(5, 16, 2, 16), b=2,
                     n_pages=3):
    return (torch.zeros(q_shape), torch.zeros(pool), torch.zeros(pool),
            torch.zeros((b, n_pages), dtype=torch.int32),
            {k: torch.zeros(b, dtype=torch.int32)
             for k in ("context_lens", "q_starts")})


@pytest.mark.parametrize("bad, err", [
    (dict(q_shape=(6, 4, 16)), ValueError),                   # ragged q
    (dict(q_shape=(3, 3, 4, 16)), ValueError),                # B != tables
    (dict(q_shape=(2, 3, 4, 18), pool=(5, 16, 2, 18)), ValueError),  # D % 4
    (dict(q_shape=(2, 3, 6, 16)), ValueError),                # G = 3
    (dict(pool=(5, 16, 2, 20)), ValueError),                  # D != pools
])
def test_batched_check_rejects_shapes_the_kernel_does_not_take(bad, err):
    q, k, v, bt, meta = _batched_tensors(**bad)
    with pytest.raises(err):
        tpa._check(q, k, v, bt, meta, batched=True)


def test_batched_check_rejects_types_and_layouts():
    q, k, v, bt, meta = _batched_tensors()
    tpa._check(q, k, v, bt, meta, batched=True)    # the valid baseline
    with pytest.raises(TypeError):
        tpa._check(q, k.half(), v, bt, meta, batched=True)
    with pytest.raises(TypeError):
        tpa._check(q, k, v, bt, {**meta, "q_starts": meta["q_starts"].long()},
                   batched=True)
    with pytest.raises(ValueError):
        tpa._check(q.transpose(1, 2), k, v, bt, meta, batched=True)
    with pytest.raises(ValueError):
        tpa._check(q, k, v, bt, {**meta, "context_lens": torch.zeros(
            3, dtype=torch.int32)}, batched=True)
