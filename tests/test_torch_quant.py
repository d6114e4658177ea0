"""The port's quantized-KV formats and kernel B2's plain versions against
the JAX package (DESIGN.md §14).

The same numpy inputs go through the port's ``kernels/quant.py`` and the
JAX package's: int8 values and scales are bit-equal, and fp8-e4m3 ones
too where both packages support the dtype on the CPU. The port's plain
versions of B2 (``paged_attention_ragged_quant_ref``) and of the batched
quantized op (``paged_attention_quant_ref``) read the same quantized bytes
as the JAX oracles and the Pallas kernel in interpret mode, and agree with
them within 1e-5 (fp32 sums of a few dozen keys through two libraries).
The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its wrapper's CPU path, its argument checks and
its ctypes signatures are pinned.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_ragged_quant \
    as jax_b2
from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import (paged_attention_quant_op,
                                     paged_attention_ragged_quant_op)

ATOL = 1e-5
FORMATS = ["int8", "fp8_e4m3"]


def _need(fmt):
    if fmt == "fp8_e4m3" and not (jq.supports_fp8() and tq.supports_fp8()):
        pytest.skip("fp8_e4m3 needs float8_e4m3fn in both packages")


def _rows(seed=0, shape=(6, 5, 3, 16)):
    """Normal rows with a few scaled up, a few all zero and exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0] *= 1e3
    x[1, 1] *= 1e-4
    x[2, 2] = 0.0
    x[3, 3, 0, :4] = [1.0625, -1.0625, 0.5, 127.0]   # round-half cases
    return x


def _torch_values(jvals) -> torch.Tensor:
    """A JAX quantized array as a torch tensor of the same bytes."""
    a = np.asarray(jvals)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_bit_equal_to_jax(fmt, seed):
    _need(fmt)
    x = _rows(seed)
    tv, ts = tq.quantize_kv(torch.from_numpy(x), tq.kv_quant_spec(fmt))
    jv, js = jq.quantize_kv(jnp.asarray(x), jq.kv_quant_spec(fmt))
    assert np.array_equal(_bytes(tv), _bytes(_torch_values(jv)))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip_within_row_bound_and_zero_rows_finite(fmt):
    _need(fmt)
    spec = tq.kv_quant_spec(fmt)
    x = torch.from_numpy(_rows(2))
    vals, scl = tq.quantize_kv(x, spec)
    back = tq.dequantize_kv(vals, scl)
    err = (back - x).abs().amax(dim=-1)
    assert torch.all(err <= tq.row_error_bound(x, spec))
    assert torch.isfinite(back).all() and torch.isfinite(scl).all()
    assert torch.all(back[2, 2] == 0.0), "an all-zero row comes back zero"


def test_spec_gating_matches_jax():
    """Same names, ranges and error steps as the JAX package; fp8 raises
    where unsupported, never silently becomes int8; unknown names raise."""
    for fmt in FORMATS:
        if fmt == "fp8_e4m3" and not tq.supports_fp8():
            with pytest.raises(ValueError, match="fp8_e4m3"):
                tq.kv_quant_spec(fmt)
            continue
        t, j = tq.kv_quant_spec(fmt), jq.kv_quant_spec(fmt)
        assert (t.name, t.qmax, t.half_step, t.bytes_per_elt) == \
            (j.name, j.qmax, j.half_step, j.bytes_per_elt)
    assert tq.kv_quant_spec("fp32") is None
    assert tq.kv_quant_spec(None) is None
    with pytest.raises(ValueError):
        tq.kv_quant_spec("int4")


# (q_lens, pos0, H, Hkv, D, page, n_pages, window): tests/test_kernels.py's
# QUANT_LAYOUTS (odd shapes: page ends, an empty slot, a boundary chunk),
# pages of 8 and 16, windows, and the full-width head geometry (D=80, G=4)
LAYOUTS = [
    ([1], [15], 4, 2, 32, 16, 2, None),                # ctx on a page end
    ([1, 1, 1], [15, 31, 7], 4, 2, 32, 16, 2, None),   # decode @ bounds
    ([5, 0, 1, 3], [10, 0, 20, 0], 4, 2, 32, 16, 3, None),  # pad sequence
    ([16], [16], 8, 2, 16, 8, 5, 12),                  # boundary chunk, SWA
    ([6, 1, 0, 1], [40, 70, 0, 100], 32, 8, 80, 16, 8, 64),  # D=80, G=4
]


def _quant_inputs(fmt, q_lens, pos0, H, Hkv, D, page, n_pages, seed=0):
    """One quantized ragged step as numpy arrays (values as JAX made
    them) plus distinct scale-page ids: a permutation of the value ids,
    so a wrong table would read wrong scales."""
    rng = np.random.default_rng(seed)
    P = n_pages * 2 + 1
    S = len(q_lens)
    ql = np.asarray(q_lens, np.int32)
    ctx = np.minimum(np.asarray(pos0, np.int32) + ql, page * n_pages)
    ctx = np.where(ql > 0, ctx, 0).astype(np.int32)
    spec = jq.kv_quant_spec(fmt)
    kq, ks = jq.quantize_kv(jnp.asarray(rng.standard_normal(
        (P, page, Hkv, D)).astype(np.float32)), spec)
    vq, vs = jq.quantize_kv(jnp.asarray(rng.standard_normal(
        (P, page, Hkv, D)).astype(np.float32)), spec)
    bt = rng.integers(0, P, (S, n_pages)).astype(np.int32)
    perm = rng.permutation(P).astype(np.int32)
    return {
        "q": rng.standard_normal((int(ql.sum()) + 3, H, D)).astype(
            np.float32),
        "k": kq, "v": vq,
        # scale page perm[p] holds data page p's scales
        "ks": np.asarray(ks)[np.argsort(perm)],
        "vs": np.asarray(vs)[np.argsort(perm)],
        "bt": bt, "st": perm[bt],
        "ctx": ctx,
        "qs": np.concatenate([[0], np.cumsum(ql)[:-1]]).astype(np.int32),
        "ql": ql,
        "p0": np.maximum(np.minimum(np.asarray(pos0, np.int32), ctx - ql),
                         0).astype(np.int32),
    }


ORDER = ("q", "k", "v", "ks", "vs", "bt", "st", "ctx", "qs", "ql", "p0")


def _torch_args(a, keys=ORDER):
    return [_torch_values(a[k]) if k in ("k", "v") else
            torch.from_numpy(np.asarray(a[k]).copy()) for k in keys]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[2:7]}")
def test_ragged_quant_ref_matches_jax_oracle_and_kernel(fmt, layout):
    _need(fmt)
    *shape, window = layout
    a = _quant_inputs(fmt, *shape)
    got = tref.paged_attention_ragged_quant_ref(*_torch_args(a),
                                                window=window).numpy()
    jargs = [jnp.asarray(a[k]) for k in ORDER]
    oracle = np.asarray(jref.paged_attention_ragged_quant_ref(
        *jargs, window=window))
    kernel = np.asarray(jax_b2(*jargs, window=window, interpret=True))
    assert np.abs(got - oracle).max() < ATOL
    assert np.abs(got - kernel).max() < ATOL
    n_rows = int(a["ql"].sum())
    assert np.all(got[n_rows:] == 0.0), "stream padding rows must be 0"


# (B, Tq, H, Hkv, D, page, n_pages, window): decode, verify and chunk Tq
BATCHED = [
    (3, 1, 4, 2, 32, 16, 3, None),
    (2, 4, 8, 2, 16, 8, 5, 12),
    (2, 3, 32, 8, 80, 16, 3, None),
]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", BATCHED, ids=lambda l: f"{l[:5]}")
def test_batched_quant_ref_matches_jax_oracle_and_flattened_kernel(fmt,
                                                                   layout):
    """The batched quantized oracle against JAX's, and against the JAX
    package's TPU route: (B, Tq) flattened through the Pallas B2 kernel in
    interpret mode, as the port's op flattens it through its CUDA B2."""
    _need(fmt)
    b, tq_, h, hkv, d, page, n_pages, window = layout
    a = _quant_inputs(fmt, [tq_] * b, [0] * b, h, hkv, d, page, n_pages)
    ctx = np.minimum(page * n_pages,
                     (np.arange(b) + 1) * (page * n_pages) // b)
    a["ctx"] = ctx.astype(np.int32)
    a["q"] = a["q"][:b * tq_].reshape(b, tq_, h, d)
    a["qs"] = np.maximum(a["ctx"] - tq_, 0).astype(np.int32)
    keys = ("q", "k", "v", "ks", "vs", "bt", "st", "ctx", "qs")
    got = tref.paged_attention_quant_ref(*_torch_args(a, keys),
                                         window=window).numpy()
    via_op = paged_attention_quant_op(*_torch_args(a, keys),
                                      window=window).numpy()
    jargs = [jnp.asarray(a[k]) for k in keys]
    oracle = np.asarray(jref.paged_attention_quant_ref(*jargs,
                                                       window=window))
    kernel = np.asarray(jops.paged_attention_quant_op(
        *jargs, window=window, impl="interpret"))
    assert np.array_equal(via_op, got)
    assert np.abs(got - oracle).max() < ATOL
    assert np.abs(got - kernel).max() < ATOL


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    a = _quant_inputs("int8", *LAYOUTS[3][:-1])
    before = tpa.paged_attention_ragged_quant.launches
    want = tref.paged_attention_ragged_quant_ref(*_torch_args(a), window=12)
    via_op = paged_attention_ragged_quant_op(*_torch_args(a), window=12)
    via_wrapper = tpa.paged_attention_ragged_quant(*_torch_args(a),
                                                   window=12)
    assert torch.equal(via_op, want) and torch.equal(via_wrapper, want)
    assert tpa.paged_attention_ragged_quant.launches == before


def _qtensors(dtype=torch.int8, pool=(5, 16, 2, 16), s=2, n_pages=3,
              offset=0):
    """Valid quantized inputs for ``_check``; ``offset`` bytes shift the
    value pools off 4-byte alignment."""
    n = int(np.prod(pool))
    raw = torch.zeros(n + offset, dtype=torch.uint8)[offset:]
    k = raw.view(dtype).view(pool)
    v = torch.zeros(pool, dtype=torch.uint8).view(dtype)
    meta = {k_: torch.zeros(s, dtype=torch.int32)
            for k_ in ("context_lens", "q_starts", "q_lens", "pos0")}
    scales = {"k_scales": torch.zeros(pool[:3]),
              "v_scales": torch.zeros(pool[:3]),
              "scale_tables": torch.zeros((s, n_pages), dtype=torch.int32)}
    return (torch.zeros(8, 4, pool[3]), k, v,
            torch.zeros((s, n_pages), dtype=torch.int32), meta, scales)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_quant_check_accepts_int8_and_fp8(dtype):
    q, k, v, bt, meta, scales = _qtensors(dtype)
    tpa._check(q, k, v, bt, meta, scales=scales)


@pytest.mark.parametrize("bad, err", [
    ("fp32_pools", TypeError),
    ("mixed_pools", TypeError),
    ("misaligned", ValueError),
    ("f64_scales", TypeError),
    ("scale_shape", ValueError),
    ("i64_scale_tables", TypeError),
    ("scale_tables_shape", ValueError),
])
def test_quant_check_rejects_what_b2_does_not_take(bad, err):
    q, k, v, bt, meta, scales = _qtensors(
        offset=1 if bad == "misaligned" else 0)
    if bad == "fp32_pools":
        k, v = k.float(), v.float()
    elif bad == "mixed_pools":
        v = torch.zeros(v.shape, dtype=torch.uint8).view(
            torch.float8_e4m3fn)
    elif bad == "f64_scales":
        scales["k_scales"] = scales["k_scales"].double()
    elif bad == "scale_shape":
        scales["v_scales"] = torch.zeros(5, 16, 3)
    elif bad == "i64_scale_tables":
        scales["scale_tables"] = scales["scale_tables"].long()
    elif bad == "scale_tables_shape":
        scales["scale_tables"] = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(err):
        tpa._check(q, k, v, bt, meta, scales=scales)


def test_b2_launchers_match_their_ctypes_signatures():
    """B2 exports one extern "C" launcher per value type and q type (f32,
    or bf16 with the suffix ``_bf16``), with one parameter list; the
    wrapper's argtypes follow it type for type and it picks the launcher
    by the pools' dtype and q's."""
    src = (_build.CSRC / _build.SOURCES["paged_attention_ragged_quant"]
           ).read_text()
    found = dict(re.findall(
        r'extern "C" int (paged_attention_ragged_quant_\w+)\((.*?)\)', src,
        re.S))
    assert set(found) == {f"paged_attention_ragged_quant_{v}{q}"
                          for v in ("i8", "f8") for q in ("", "_bf16")}
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    for symbol, params in found.items():
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params.split(",")]
        assert tpa._SIG[symbol] == want
    assert {f"paged_attention_ragged_quant_{s}{q}"
            for s in tpa._QUANT_SUFFIX.values()
            for q in ("", "_bf16")} == set(found)
