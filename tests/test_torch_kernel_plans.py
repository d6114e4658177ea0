"""The host-side plans of kernels B4, B1, B2 and B3, and the attention
body's split arithmetic, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); what they launch is decided here, in plain Python,
from host-known sizes. Pinned:

* ``moe_gmm.gmm_plan`` at every capacity chip_smoke's MoE serving run
  launches B4 at (C = 4, 8, 20, 160, 640, 960, mixtral-8x7b's gate/up and
  down; kimi-k2's gate at C=4) and at ``tests/test_torch_moe.py``'s edge
  shapes: a grid inside CUDA's limits that covers every row and column,
  one block per expert and K part, shared memory a block may take, and
  the partial-sum scratch it states; ``_check`` takes what the plan can
  launch and refuses a grid past CUDA's limits.
* ``paged_attention.quant_plan`` (the ragged layout of B1 and B2) at
  chip_smoke's phase-3 and 3c steps: split counts over the table, the
  chunk-tile grid as an upper bound of the tiles the layout needs, and
  the scratch shapes.
* ``paged_attention.batched_plan`` (B3) at phase 3b's steps: decode tiles
  of 4, 8 or 16 vectors while Tq x G <= 16 and chunk tiles from 17 on,
  their splits, grids and scratch, and the chunk tiles' key split when
  their grid is short of two waves of the card.
* ``paged_attention.body_smem``: every decode and chunk kernel of the
  body, fp32 and 1-byte, fits the 232,448 bytes a block may take for D in
  {16, 32, 64, 80, 128} and G in {1, 2, 4, 8, 16}.
* ``ref.merge_partial_attention`` against the JAX
  ``models/attention.py::merge_partial_attention`` at 1e-6 on numpy inputs
  from a seed, shards a row sees no key of included.
* The body's split arithmetic in plain PyTorch
  (``ref.paged_attention_ragged_split_ref`` for fp32 pools,
  ``ref.paged_attention_ragged_quant_split_ref`` for int8 and fp8-e4m3,
  ``ref.paged_attention_split_ref`` for B3's layout) against the plain
  versions within 1e-5: splits with no visible key, a window that starts
  inside a split, contexts at a split boundary and one key either side,
  decode rows next to chunks, tiles on both sides of the decode/chunk
  threshold, and rows with no visible key (exactly 0 in B3's layout).
* ``tools/profile_torch_serve.py`` files every kernel of B4 and of the
  attention body under its class (``moe``, ``attention``), and B1's and
  B3's sources launch no kernel of their own.
"""
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import merge_partial_attention as jax_merge
from repro_torch.configs import get
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quant import kv_quant_spec, quantize_kv
from repro_torch.models.moe import _capacity

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

MAX_SMEM = 232448        # bytes one block may opt in to on the H100


# -- B4: gmm_plan ----------------------------------------------------------

def _moe_shapes():
    mix, kimi = get("mixtral-8x7b"), get("kimi-k2-1t-a32b")
    e, d, f = mix.moe.n_experts, mix.d_model, mix.moe.d_ff_expert
    shapes = []
    for c in (4, 8, 20, 160, 640, 960):
        shapes += [(e, c, d, f), (e, c, f, d)]
    shapes.append((kimi.moe.n_experts, _capacity(64, kimi.moe),
                   kimi.d_model, kimi.moe.d_ff_expert))
    return shapes


# tests/test_torch_moe.py's EDGES, and C on both sides of the bodies' edge
EDGES = [(3, 20, 96, 72), (5, 1, 33, 5), (2, 4, 17, 130), (1, 40, 130, 260),
         (384, 4, 16, 8), (4, 32, 64, 64), (4, 33, 64, 64)]


@pytest.mark.parametrize("shape", _moe_shapes() + EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gmm_plan_covers_the_output_inside_cuda_limits(shape):
    e, c, k, n = shape
    plan = tmg.gmm_plan(e, c, k, n)
    gx, gy, gz = plan.grid
    assert 0 < gx <= tmg.GRID_X and 0 < gy <= tmg.GRID_YZ
    assert 0 < gz <= tmg.GRID_YZ and gz == e * plan.parts
    assert gx * plan.rows >= c > (gx - 1) * plan.rows     # every row, once
    assert gy * tmg.BN >= n > (gy - 1) * tmg.BN
    assert 0 < plan.smem <= MAX_SMEM
    if c > tmg.STREAM_MAX_C:
        assert plan.body == "tile" and plan.rows in tmg.TILE_ROWS
        assert plan.threads == 2 * plan.rows and plan.parts == 1
        pad = -(-c // plan.rows) * plan.rows
        assert pad == min(-(-c // r) * r for r in tmg.TILE_ROWS)
    else:
        assert plan.body == "stream" and plan.rows in tmg.STREAM_ROWS
        assert plan.rows >= c and plan.threads == tmg.STREAM_THREADS
        assert 1 <= plan.parts <= tmg.MAX_PARTS
        # each part at least 4 slabs of K
        assert plan.parts == 1 or k >= 4 * tmg.STREAM_BK * plan.parts
    assert plan.scratch == ((plan.parts, e, c, n) if plan.parts > 1
                            else None)


@pytest.mark.parametrize("c, rows", [(160, 32), (640, 128), (960, 64),
                                     (33, 64), (64, 64), (4, 4), (8, 8),
                                     (20, 20), (32, 32)])
def test_gmm_plan_row_tile_pads_c_least(c, rows):
    assert tmg.gmm_plan(8, c, 4096, 14336).rows == rows


def test_gmm_plan_splits_k_only_under_its_waves():
    """mixtral's gate/up (8 x 112 column tiles) and down projection (8 x
    32) at decode capacities fill under WAVES waves of 132 SMs: K is split
    to fill them; kimi-k2's gate (384 x 16 tiles) fills the card unsplit.
    More SMs need more parts, up to MAX_PARTS."""
    assert tmg.gmm_plan(8, 8, 4096, 14336).parts == 2
    assert tmg.gmm_plan(8, 8, 14336, 4096).parts == 7
    assert tmg.gmm_plan(384, 4, 7168, 2048).parts == 1
    assert tmg.gmm_plan(8, 8, 14336, 4096, sms=264).parts == tmg.MAX_PARTS
    assert tmg.gmm_plan(1, 4, 96, 8).parts == 1      # too shallow to split


def test_gmm_check_follows_the_plan():
    x, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 12))
    assert tmg._check(x, w) == tmg.gmm_plan(2, 4, 8, 12)
    # 65536 column tiles of 128 are past gridDim.y (no element is stored)
    with pytest.raises(ValueError, match="grid"):
        tmg._check(torch.zeros((1, 4, 0)),
                   torch.zeros((1, 0, 65536 * 128 + 1)))
    tmg._check(torch.zeros((1, 4, 0)), torch.zeros((1, 0, 65535 * 128)))
    with pytest.raises(ValueError, match="grid"):     # experts past z
        tmg._check(torch.zeros((65536, 0, 1)), torch.zeros((65536, 1, 0)))
    tmg._check(torch.zeros((65535, 0, 1)), torch.zeros((65535, 1, 0)))


# -- B2: quant_plan -----------------------------------------------------------

@pytest.mark.parametrize("page", [128, 16])
@pytest.mark.parametrize("kind, splits", [("a_mixed", 8), ("b_decode", 4),
                                          ("c_window", 16)])
def test_quant_plan_at_phase_3c_steps(kind, splits, page):
    q_lens, pos0, ctx, window, max_ctx = cs._layout(
        kind, np.random.default_rng(0))
    t, s = sum(q_lens) + 5, len(q_lens)
    n_keys = -(-max_ctx // page) * page
    g = cs.H // cs.HKV
    plan = tpa.quant_plan(t, s, n_keys, cs.H, cs.HKV, cs.D)
    assert plan.n_splits == splits
    assert plan.split_keys % tpa.SPLIT_UNIT == 0
    assert (plan.n_splits - 1) * plan.split_keys < n_keys \
        <= plan.n_splits * plan.split_keys
    assert plan.decode_blocks == s * splits * cs.HKV
    assert plan.chunk_rows * g == tpa.CHUNK_VECS
    assert plan.decode_vecs == g == 4          # a decode row of 4 heads
    tiles = sum(-(-n // plan.chunk_rows) for n in q_lens
                if n * g > plan.decode_vecs)
    assert tiles <= plan.chunk_tiles == -(-t // plan.chunk_rows) + s
    assert plan.chunk_blocks == plan.chunk_tiles * cs.HKV
    assert plan.part_out == (s, splits, cs.HKV, plan.decode_vecs, cs.D)
    assert plan.part_lse == plan.part_out[:-1]
    assert max(plan.decode_blocks, plan.chunk_blocks) <= tpa.GRID_X


@pytest.mark.parametrize("n_keys, split_keys", [
    (16, 512), (512, 512), (513, 512), (8192, 512), (8193, 640),
    (16384, 1024), (16385, 1152), (32768, 2048)])
def test_quant_plan_split_size_follows_the_table_only(n_keys, split_keys):
    plan = tpa.quant_plan(64, 4, n_keys, 32, 8, 80)
    assert plan.split_keys == split_keys
    assert plan.n_splits <= tpa.MAX_SPLITS
    assert tpa.quant_plan(8, 1, n_keys, 4, 4, 16).split_keys == split_keys


@pytest.mark.parametrize("h, hkv, vecs, rows", [
    (4, 4, 4, 4), (8, 4, 4, 2), (32, 8, 4, 1), (8, 1, 8, 1), (16, 1, 16, 1)])
def test_quant_plan_decode_tile_is_a_decode_row(h, hkv, vecs, rows):
    """A decode tile holds max(4, G) vectors: one decode row of G heads,
    and at G <= 2 the rows that fill 4 vectors; the chunk tile 64."""
    plan = tpa.quant_plan(32, 3, 1024, h, hkv, 16)
    assert plan.decode_vecs == vecs and vecs // (h // hkv) == rows
    assert plan.chunk_rows * (h // hkv) == tpa.CHUNK_VECS


# -- B3: batched_plan -------------------------------------------------------

@pytest.mark.parametrize("page", [128, 16])
@pytest.mark.parametrize("kind, vecs, tiles, splits", [
    ("d_decode", 4, 64, 8), ("e_verify", 16, 16, 8), ("f_chunk", 64, 32, 4),
    ("g_window", 16, 16, 16)])
def test_batched_plan_at_phase_3b_steps(kind, vecs, tiles, splits, page):
    b, tq, _, _, _, max_ctx = cs._blayout(kind, np.random.default_rng(0))
    n_keys = -(-max_ctx // page) * page
    plan = tpa.batched_plan(b, tq, n_keys, cs.H, cs.HKV, cs.D)
    assert (plan.vecs, plan.tiles, plan.n_splits) == (vecs, tiles, splits)
    assert plan.split_keys % tpa.SPLIT_UNIT == 0
    assert (plan.n_splits - 1) * plan.split_keys < n_keys \
        <= plan.n_splits * plan.split_keys
    assert plan.blocks == tiles * splits * cs.HKV <= tpa.GRID_X
    assert plan.merge_blocks == tiles * cs.HKV
    assert plan.part_out == (tiles, splits, cs.HKV, vecs, cs.D)
    assert plan.part_lse == plan.part_out[:-1]
    g = cs.H // cs.HKV
    if vecs == tpa.CHUNK_VECS:                  # (f): 32 tiles of 16 rows
        assert plan.rows == tpa.CHUNK_VECS // g and tiles * plan.rows == tq
        assert plan.smem == tpa.body_smem(cs.D, 4, 16, 4)[1]
    else:                                        # a tile a sequence
        assert plan.rows == tq and tiles == b and tq * g <= vecs
        assert plan.split_keys == 512            # B1's for the same table
        assert plan.smem == tpa.body_smem(cs.D, 4, 16, vecs)[0]


@pytest.mark.parametrize("g, tq, vecs", [
    (4, 1, 4), (4, 2, 8), (4, 3, 16), (4, 4, 16), (4, 5, 64),
    (1, 1, 4), (1, 8, 8), (1, 16, 16), (1, 17, 64), (2, 2, 4), (2, 8, 16),
    (2, 9, 64), (8, 2, 16), (8, 3, 64), (16, 1, 16), (16, 2, 64)])
def test_batched_plan_decode_tiles_up_to_16_vectors(g, tq, vecs):
    """Tq x G = 4, 8 and 16 vectors (rounded up from below) are decode
    tiles, one a sequence; 17 and up are chunk tiles of 64 / G rows."""
    plan = tpa.batched_plan(3, tq, 1024, 2 * g, 2, 16)
    assert plan.vecs == vecs
    if vecs == tpa.CHUNK_VECS:
        assert tq * g > tpa.MAX_DECODE_VECS and plan.rows == 64 // g
        assert plan.tiles == 3 * -(-tq // plan.rows)
    else:
        assert tq * g <= vecs and (vecs == 4 or tq * g > vecs // 2)
        assert plan.rows == tq and plan.tiles == 3
        assert plan.merge_blocks == 3 * 2


def test_batched_chunk_tiles_split_keys_only_short_of_two_waves():
    """Step (f)'s 32 chunk tiles x 8 heads are 256 blocks, under the 792 of
    two waves of three blocks on each of 132 SMs: their 4096 keys go in 4
    splits of 1024, merged. Four such sequences fill the waves unsplit:
    one launch, no merge, no scratch. More SMs, more splits; never more
    than the table's 512-key pieces, nor past MAX_SPLITS."""
    p = tpa.batched_plan(1, 512, 4096, 32, 8, 80)
    assert (p.n_splits, p.split_keys, p.blocks, p.merge_blocks) == (
        4, 1024, 1024, 256)
    p = tpa.batched_plan(4, 512, 4096, 32, 8, 80)
    assert (p.n_splits, p.merge_blocks, p.part_out, p.part_lse) == (
        1, 0, None, None)
    assert p.blocks == 4 * 32 * 8
    wide = tpa.batched_plan(1, 512, 4096, 32, 8, 80, sms=264)
    assert wide.n_splits == 7 and wide.split_keys == 640
    assert tpa.batched_plan(1, 64, 4096, 32, 8, 80).n_splits == 8
    assert tpa.batched_plan(1, 64, 65536, 32, 8, 80).n_splits == \
        tpa.MAX_SPLITS
    assert tpa.batched_plan(1, 512, 512, 32, 8, 80).n_splits == 1
    assert tpa.batched_plan(1, 512, 1023, 32, 8, 80).n_splits == 1


# -- the body's shared memory -------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_body_shared_memory_fits_a_block(d, g):
    """Every decode tile a plan can ask for at this G (the ragged max(4, G),
    the batched 4, 8 and 16 at or past G) and the chunk tile, over fp32
    pools and 1-byte pools copied 16 or 4 bytes at a time."""
    tiles = sorted({max(tpa.MIN_DECODE_VECS, g),
                    *(v for v in tpa.DECODE_VECS if v >= g)})
    for elem, chs in ((4, (16,)), (1, (16, 4) if d % 16 == 0 else (4,))):
        for ch in chs:
            for vecs in tiles:
                dec, chunk = tpa.body_smem(d, elem, ch, vecs)
                assert 0 < dec <= MAX_SMEM and 0 < chunk <= MAX_SMEM


def test_body_shared_memory_at_h2o_danube_heads():
    """D = 80: the 1-byte tiles keep their sizes (45.4 and 72.5 KB: three
    chunk blocks an SM); fp32 decode tiles of 4 vectors take 86.4 KB (two
    blocks an SM) and fp32 chunk tiles 62 KB (three, as the chunk launch's
    bounds and batched_plan's waves assume)."""
    assert tpa.body_smem(80, 1, 16, 4) == (46464, 74240)
    dec, chunk = tpa.body_smem(80, 4, 16, 4)
    assert (dec, chunk) == (88448, 63488)
    assert tpa.SMEM_PER_SM // (dec + tpa.SMEM_PER_BLOCK) == 2
    assert tpa.SMEM_PER_SM // (chunk + tpa.SMEM_PER_BLOCK) == \
        tpa.CHUNK_BLOCKS_PER_SM


# -- the merge, ported ------------------------------------------------------

@pytest.mark.parametrize("seed, shape", [(0, (2, 3, 1, 4, 16)),
                                         (1, (5, 2, 4, 8, 80)),
                                         (2, (16, 1, 1, 32, 8))])
def test_merge_partial_attention_matches_jax(seed, shape):
    rng = np.random.default_rng(seed)
    outs = rng.standard_normal(shape).astype(np.float32)
    lses = (rng.standard_normal(shape[:-1]) * 4).astype(np.float32)
    # shards a row sees no key of: out 0, lse NEG_INF; the last row none
    empty = rng.random(shape[:-1]) < 0.3
    empty[..., -1] = True
    outs[empty] = 0.0
    lses[empty] = tref.NEG_INF
    got = tref.merge_partial_attention(torch.from_numpy(outs),
                                       torch.from_numpy(lses)).numpy()
    want = np.asarray(jax_merge(jnp.asarray(outs), jnp.asarray(lses)))
    assert got.shape == want.shape == shape[1:]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6
    assert np.all(got[..., -1, :] == 0.0)


# -- the split reference ----------------------------------------------------

SPLIT = 512        # quant_plan's split_keys for a table of 1024 keys


def _step(fmt, q_lens, pos0, ctx, *, h, hkv, d=16, page=16, n_pages=64,
          seed=0):
    """One ragged step over tables of n_pages x page keys: fp32 pools for
    ``fmt`` "fp32" (q, k, v, tables, the four arrays), else quantized
    (with scale pools and scale tables after v)."""
    rng = np.random.default_rng(seed)
    s = len(q_lens)
    n_pool = s * n_pages + 1
    k = torch.from_numpy(rng.standard_normal(
        (n_pool, page, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (n_pool, page, hkv, d)).astype(np.float32))
    perm = rng.permutation(n_pool)
    bt = (1 + rng.permutation(s * n_pages)).reshape(s, n_pages)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    qs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    q = torch.from_numpy(rng.standard_normal(
        (sum(q_lens) + 2, h, d)).astype(np.float32))
    meta = (i32(ctx), i32(qs), i32(q_lens), i32(pos0))
    if fmt == "fp32":
        return (q, k, v, i32(bt), *meta)
    spec = kv_quant_spec(fmt)
    kq, ks = quantize_kv(k, spec)
    vq, vs = quantize_kv(v, spec)
    inv = torch.as_tensor(np.argsort(perm))
    return (q, kq, vq, ks[inv].contiguous(), vs[inv].contiguous(), i32(bt),
            i32(perm[bt]), *meta)


# (q_lens, pos0, ctx, window, H, Hkv) with decode rows at pos0 = ctx -
# q_len; G = 4 unless stated
SPLIT_CASES = {
    "ctx_split_minus_1": ([1], [SPLIT - 2], [SPLIT - 1], None, 8, 2),
    "ctx_split": ([1], [SPLIT - 1], [SPLIT], None, 8, 2),
    "ctx_split_plus_1": ([1], [SPLIT], [SPLIT + 1], None, 8, 2),
    # keys past the first split only: split 0 has no visible key
    "window_empty_first_split": ([1, 1], [800, 600], [801, 601], 80, 8, 2),
    "window_inside_split": ([1, 3], [600, 597], [601, 600], 150, 8, 2),
    "decode_next_to_chunks": ([1, 40, 1, 0, 17, 1],
                              [900, 480, SPLIT, 0, 0, 1020],
                              [901, 520, SPLIT + 1, 0, 17, 1021], None, 8, 2),
    # one row is a decode tile (4 vectors), two rows a chunk tile
    "threshold_1_and_2_rows": ([1, 2, 1], [511, 510, 600],
                               [512, 512, 601], None, 8, 2),
    "threshold_window": ([1, 2], [512, 511], [513, 513], 6, 8, 2),
    # G = 1: four rows are a decode tile, five a chunk tile
    "g1_threshold_4_and_5_rows": ([4, 5, 4], [508, 509, 600],
                                  [512, 514, 604], None, 4, 4),
    # G = 8: a decode row is 8 vectors
    "g8_decode_rows": ([1, 1, 2], [511, 600, 512], [512, 601, 514], None,
                       8, 1),
    "no_visible_key": ([1, 2], [0, 5], [0, 7], 1, 8, 2),
    # a 2048-key table: decode rows in the fourth split, next to chunks
    "four_splits": ([1, 200, 40, 1], [2000, 900, 1000, 1500],
                    [2001, 1100, 1040, 1501], None, 8, 2, 128),
}


@pytest.mark.parametrize("fmt", ["fp32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_reference_matches_plain_version(fmt, case):
    q_lens, pos0, ctx, window, h, hkv, *pages = SPLIT_CASES[case]
    args = _step(fmt, q_lens, pos0, ctx, h=h, hkv=hkv, n_pages=pages[0]
                 if pages else 64)
    tables = args[3] if fmt == "fp32" else args[5]
    n_keys = tables.shape[1] * args[1].shape[1]
    plan = tpa.quant_plan(args[0].shape[0], len(q_lens), n_keys, h, hkv,
                          args[0].shape[2])
    assert plan.split_keys == SPLIT
    split, plain = ((tref.paged_attention_ragged_split_ref,
                     tref.paged_attention_ragged_ref) if fmt == "fp32" else
                    (tref.paged_attention_ragged_quant_split_ref,
                     tref.paged_attention_ragged_quant_ref))
    got = split(*args, split_keys=plan.split_keys,
                decode_vecs=plan.decode_vecs, window=window)
    want = plain(*args, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.all(got[sum(q_lens):] == 0)     # stream padding rows
    if case == "no_visible_key":                 # ctx 0 and a 1-key window
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_batched_split_reference_matches_plain_version(case):
    """SPLIT_CASES' sequences through B3's layout: one batched call per
    query length (B sequences of Tq rows at their pos0), laid out by
    ``batched_plan``: decode tiles split at 512 keys, chunk tiles split at
    512 too (their few blocks are far short of two waves). Rows with no
    visible key are exactly 0 (B3 writes them: its output is not
    zeroed)."""
    q_lens, pos0, ctx, window, h, hkv, *pages = SPLIT_CASES[case]
    q, k, v, bt, *_ = _step("fp32", q_lens, pos0, ctx, h=h, hkv=hkv,
                            n_pages=pages[0] if pages else 64)
    n_keys = bt.shape[1] * k.shape[1]
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    for tq in sorted({n for n in q_lens if n > 0}):
        seqs = [i for i, n in enumerate(q_lens) if n == tq]
        qb = torch.stack([q[starts[i]:starts[i] + tq] for i in seqs])
        meta = (bt[seqs], i32([ctx[i] for i in seqs]),
                i32([pos0[i] for i in seqs]))
        plan = tpa.batched_plan(len(seqs), tq, n_keys, h, hkv, q.shape[2])
        assert plan.split_keys == SPLIT and plan.n_splits == n_keys // SPLIT
        got = tref.paged_attention_split_ref(
            qb, k, v, *meta, rows=plan.rows, split_keys=plan.split_keys,
            window=window)
        want = tref.paged_attention_ref(qb, k, v, *meta, window=window)
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-5
        for j, i in enumerate(seqs):             # rows that see no key
            for t in range(tq):
                p = pos0[i] + t
                lo = 0 if window is None else max(0, p - window + 1)
                if min(ctx[i], p + 1, n_keys) <= lo:
                    assert torch.all(got[j, t] == 0)
    if case == "no_visible_key":
        assert tref.paged_attention_split_ref(
            q[:1, None], k, v, bt[:1], i32([0]), i32([0]), rows=1,
            split_keys=SPLIT, window=1).abs().max() == 0


# -- the profile's kernel classes -------------------------------------------

@pytest.mark.parametrize("source, cls", [("moe_gmm.cu", "moe"),
                                         ("attention_body.cuh", "attention")])
def test_profile_classes_every_b4_and_b2_kernel(source, cls):
    """tools/profile_torch_serve.py files each of B4's kernels (the split-K
    sum included) and each kernel of the attention body (the split, merge
    and chunk launches of B1, B2 and B3, in both layouts) under its class,
    demangled as the profiler prints it or mangled, never under
    ``other``."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    import profile_torch_serve as prof
    text = (pathlib.Path(tmg.__file__).parent / "csrc" / source).read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(",
                       text)
    assert len(names) == 3
    for name in names:
        for args in ("<8, 4>", "<float, 16, 4, attn_body::Batched>",
                     "<signed char, 4, attn_body::Ragged>"):
            assert prof.classify(f"void attn_body::{name}{args}"
                                 "(float const*)", "kernel") == cls, name
        assert prof.classify(f"_ZN9attn_body{len(name)}{name}Ev",
                             "kernel") == cls, name


@pytest.mark.parametrize("source", ["paged_attention.cu",
                                    "paged_attention_ragged.cu",
                                    "paged_attention_ragged_quant.cu"])
def test_attention_kernels_launch_only_the_body(source):
    """B3, B1 and B2 define no kernel of their own: each launcher
    instantiates the shared body (csrc/attention_body.cuh)."""
    text = (pathlib.Path(tpa.__file__).parent / "csrc" / source).read_text()
    assert "__global__" not in text and "<<<" not in text
    assert '#include "attention_body.cuh"' in text
    assert "attn_body::launch" in text or "return launch<float, 16>" in text
