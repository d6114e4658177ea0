"""The port's attention over position arrays and ring-buffer KV plumbing
against the JAX package's, on the CPU.

``repro_torch.models.attention`` and the ring helpers of
``repro_torch.models.layers`` take the same inputs (numpy, from a seed) as
``repro.models.attention`` / ``repro.models.layers``. Pinned:

* ``dense_attention`` (with its log-sum-exp), ``flash_attention``,
  ``flash_attention_with_lse`` and ``merge_partial_attention`` within 1e-5
  of the JAX functions, at tests/test_attention.py's cases with and
  without a window;
* ``flash_attention_banded`` within 1e-5 of the JAX one inside its banded
  path and in each fall-back (band covering every key, queries not whole
  blocks, queries and keys of different lengths), and equal to dense
  windowed attention;
* ``prefill_ring_write`` / ``write_prefix_cache`` / ``decode_ring_write``
  exactly equal to JAX's, short of, at and past the ring's width.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro.models import layers as jl
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl

ATOL = 1e-5
CASES = [(2, 33, 65, 8, 2, 16, 16),
         (1, 7, 7, 4, 4, 8, 4),        # square causal
         (2, 1, 40, 4, 1, 32, 16)]     # decode-like MQA


def _inputs(b, tq, tk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    qp = np.array(np.broadcast_to(np.arange(tk - tq, tk, dtype=np.int32),
                                  (b, tq)))
    kp = np.array(np.broadcast_to(np.arange(tk, dtype=np.int32), (b, tk)))
    arrays = (q, k, v, qp, kp)
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 17])
@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,block", CASES)
def test_dense_and_flash_match_jax(B, Tq, Tk, H, Hkv, D, block, window):
    j, t = _inputs(B, Tq, Tk, H, Hkv, D)
    o_j, lse_j = ja.dense_attention(*j, window=window, return_lse=True)
    o_t, lse_t = ta.dense_attention(*t, window=window, return_lse=True)
    _close(o_t, o_j)
    _close(lse_t, lse_j)
    _close(ta.dense_attention(*t, window=window), o_j)
    f_j = ja.flash_attention(*j, window=window, block=block)
    f_t = ta.flash_attention(*t, window=window, block=block)
    _close(f_t, f_j)
    _close(f_t, o_j)
    fo_j, fl_j = ja.flash_attention_with_lse(*j, window=window, block=block)
    fo_t, fl_t = ta.flash_attention_with_lse(*t, window=window, block=block)
    _close(fo_t, fo_j)
    _close(fl_t, fl_j)
    _close(fl_t, lse_j)


def test_context_parallel_merge_matches_jax():
    """LSE merge over disjoint KV shards == full attention, in both
    packages (tests/test_attention.py::test_context_parallel_merge_exact)."""
    j, t = _inputs(2, 4, 64, 4, 2, 16, seed=1)
    parts_j, parts_t = [], []
    for lo, hi in ((0, 16), (16, 48), (48, 64)):
        parts_j.append(ja.flash_attention_with_lse(
            j[0], j[1][:, lo:hi], j[2][:, lo:hi], j[3], j[4][:, lo:hi],
            block=16))
        parts_t.append(ta.flash_attention_with_lse(
            t[0], t[1][:, lo:hi], t[2][:, lo:hi], t[3], t[4][:, lo:hi],
            block=16))
    m_j = ja.merge_partial_attention(jnp.stack([p[0] for p in parts_j]),
                                     jnp.stack([p[1] for p in parts_j]))
    m_t = ta.merge_partial_attention(torch.stack([p[0] for p in parts_t]),
                                     torch.stack([p[1] for p in parts_t]))
    _close(m_t, m_j)
    _close(m_t, ja.dense_attention(*j))


# (B, T, H, Hkv, D, window, q_block, block, Tq): Tq=None is Tq == Tk = T
BANDED = {"banded": (2, 64, 4, 2, 8, 8, 16, 8, None),
          "band_covers_keys": (1, 24, 4, 2, 8, 8, 16, 8, None),
          "ragged_q_blocks": (1, 60, 4, 2, 8, 8, 16, 8, None),
          "tq_ne_tk": (1, 64, 4, 4, 8, 8, 16, 8, 32)}


@pytest.mark.parametrize("case", list(BANDED))
def test_flash_banded_matches_jax(case):
    b, t, h, hkv, d, window, q_block, block, tq = BANDED[case]
    j, tt = _inputs(b, tq or t, t, h, hkv, d, seed=2)
    kw = dict(window=window, q_block=q_block, block=block)
    o_j = ja.flash_attention_banded(*j, **kw)
    o_t = ta.flash_attention_banded(*tt, **kw)
    _close(o_t, o_j)
    _close(o_t, ja.dense_attention(*j, window=window))
    band = window + q_block
    inside = band < t and (tq or t) % q_block == 0 and (tq or t) == t
    assert inside == (case == "banded")


@pytest.mark.parametrize("seq_len", [1, 5, 16, 17, 40])
def test_ring_writes_equal_jax(seq_len):
    width, b, hkv, d = 16, 2, 2, 4
    rng = np.random.default_rng(seq_len)
    k = rng.standard_normal((b, seq_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, seq_len, hkv, d)).astype(np.float32)
    idx_j, pos_j = jl.prefill_ring_write(jnp.asarray(k), seq_len, width)
    idx_t, pos_t = tl.prefill_ring_write(torch.from_numpy(k), seq_len, width)
    assert idx_t.tolist() == np.asarray(idx_j).tolist()
    assert pos_t.tolist() == np.asarray(pos_j).tolist()
    assert pos_t.dtype == torch.int32
    ck_j, cv_j, kp_j = jl.write_prefix_cache(jnp.asarray(k), jnp.asarray(v),
                                             width)
    ck_t, cv_t, kp_t = tl.write_prefix_cache(torch.from_numpy(k),
                                             torch.from_numpy(v), width)
    for got, want in ((ck_t, ck_j), (cv_t, cv_j), (kp_t, kp_j)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # three decode writes after the prefill, one sequence a step ahead
    for step in range(3):
        positions = np.array([seq_len + step, seq_len + step + 1], np.int32)
        kn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
        ck_j, cv_j, kp_j = jl.decode_ring_write(
            ck_j, cv_j, kp_j, jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(positions))
        out = tl.decode_ring_write(ck_t, cv_t, kp_t, torch.from_numpy(kn),
                                   torch.from_numpy(vn),
                                   torch.from_numpy(positions))
        assert out[0] is ck_t and out[2] is kp_t, "written in place"
        for got, want in ((ck_t, ck_j), (cv_t, cv_j), (kp_t, kp_j)):
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_empty_kv_cache_equals_jax():
    want = jl.empty_kv_cache(3, 2, 8, 2, 4, dtype=jnp.float32)
    got = tl.empty_kv_cache(3, 2, 8, 2, 4, dtype=torch.float32)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype
