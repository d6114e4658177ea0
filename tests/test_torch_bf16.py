"""bf16 through the port's kernels, optimizer and checkpoints, against the
JAX package, on the CPU.

The kernels' plain versions (what a CPU tensor takes) in bf16 against the
JAX Pallas kernels in interpret mode in bf16, on tests/test_kernels.py's
sweep shapes: B1 (ragged), B2 (a bf16 q over int8 and fp8-e4m3 pools), B3
(batched), B4 (expert GEMM) and B5 (SSD chunk scan; its backward against
``jax.vjp`` of the JAX ``ssd_chunked``). Inputs come from numpy seeds and
are rounded to bf16 once, in JAX; the port gets the same values (through
fp32, exact). Both sides widen to fp32, compute in fp32 and round the
output once, so the bar is one bf16 ulp of the output (2⁻⁷ of it: the two
fp32 results, summed in other orders, may round to neighbouring bf16
values) plus 1e-5 of the output's max for the fp32 sums' order near zero;
the JAX suite holds the Pallas kernels to its oracles at 2e-2 (times √K
for B4), which this bar is well inside. Then one AdamW and one Adafactor
step on bf16 parameters against the JAX optimizer, a bf16 checkpoint
round trip (bitwise) and a JAX-written bf16 ``.npz`` read back, the
weight bridge for bf16 trees, and the dtypes the wrappers and
``ModelOpts`` take (fp32 and bf16) and refuse (fp16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as kvq
from repro.kernels.mamba2_scan import mamba_chunk_scan as jax_scan
from repro.kernels.moe_gmm import moe_gmm as jax_gmm
from repro.kernels.paged_attention import (
    paged_attention as jax_pa, paged_attention_ragged as jax_ragged,
    paged_attention_ragged_quant as jax_ragged_quant)
from repro.models.mamba2 import ssd_chunked
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as jax_opt
from repro_torch.kernels import mamba2_scan as tscan
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ops import mamba_chunk_scan_op
from repro_torch.models import ModelOpts, params_from_numpy, params_to_numpy
from repro_torch.training import (OptConfig, apply_updates, init_opt_state,
                                  load_checkpoint, save_checkpoint)

BF16 = torch.bfloat16


def _pair(a: np.ndarray):
    """fp32 numpy → (JAX bf16, port bf16): the same rounded values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _i32(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _one_ulp(got: torch.Tensor, want, name=""):
    """``got`` (the port, bf16) within one bf16 ulp of ``want`` (JAX, bf16)
    plus 1e-5·max|want| (see the module docstring)."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert g.shape == w.shape, name
    bar = 2.0 ** -7 * np.abs(w) + 1e-5 * np.abs(w).max()
    assert np.all(np.abs(g - w) <= bar), (name, float(np.abs(g - w).max()))


# -- B3: batched paged attention (tests/test_kernels.py's sweep) ----------

@pytest.mark.parametrize("b,tq,h,hkv,d,page,n_pages,window", [
    (2, 1, 4, 2, 32, 16, 3, None), (3, 1, 8, 1, 64, 32, 4, None),
    (1, 16, 4, 4, 32, 16, 4, None), (2, 8, 8, 2, 16, 8, 5, 12),
    (2, 1, 4, 2, 128, 128, 2, 64)])
def test_paged_attention_bf16_matches_pallas(b, tq, h, hkv, d, page,
                                             n_pages, window):
    rng = np.random.default_rng(1)
    p = n_pages * 2 + 1
    qj, qt = _pair(rng.standard_normal((b, tq, h, d)))
    kj, kt = _pair(rng.standard_normal((p, page, hkv, d)))
    vj, vt = _pair(rng.standard_normal((p, page, hkv, d)))
    total = page * n_pages
    ctx = np.minimum([(total * (i + 1)) // (b + 1) + tq for i in range(b)],
                     total)
    (btj, btt), (cj, ct), (sj, st) = (
        _i32(rng.integers(0, p, (b, n_pages))), _i32(ctx), _i32(ctx - tq))
    want = jax_pa(qj, kj, vj, btj, cj, sj, window=window, interpret=True)
    got = tpa.paged_attention(qt, kt, vt, btt, ct, st, window=window)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _one_ulp(got, want)


# -- B1 and B2: ragged paged attention ------------------------------------

RAGGED = [([5, 1, 3], [10, 20, 0], 4, 2, 32, 16, 3, None),
          ([1, 1, 1, 1], [7, 12, 0, 33], 8, 1, 64, 32, 2, None),
          ([16], [8], 4, 4, 32, 16, 4, None),
          ([8, 2, 1], [4, 9, 30], 8, 2, 16, 8, 5, 12)]


def _ragged(q_lens, pos0, h, hkv, d, page, n_pages, seed=2):
    """The ragged sweep's step: q (bf16 pair), fp32 pools (numpy) and the
    int32 metadata pairs (tables, context, starts, lengths, positions)."""
    rng = np.random.default_rng(seed)
    p, s = n_pages * 2 + 1, len(q_lens)
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    q = _pair(rng.standard_normal((sum(q_lens) + 3, h, d)))
    pools = [rng.standard_normal((p, page, hkv, d)) for _ in range(2)]
    ctx = np.minimum(np.add(pos0, q_lens), page * n_pages)
    meta = [_i32(rng.integers(0, p, (s, n_pages))), _i32(ctx),
            _i32(starts), _i32(q_lens),
            _i32(np.minimum(pos0, ctx - np.asarray(q_lens)))]
    return q, pools, meta


@pytest.mark.parametrize("layout", RAGGED, ids=lambda l: f"{l[2:6]}")
def test_paged_attention_ragged_bf16_matches_pallas(layout):
    *shape, window = layout
    (qj, qt), pools, meta = _ragged(*shape)
    (kj, kt), (vj, vt) = map(_pair, pools)
    want = jax_ragged(qj, kj, vj, *(m[0] for m in meta), window=window,
                      interpret=True)
    got = tpa.paged_attention_ragged(qt, kt, vt, *(m[1] for m in meta),
                                     window=window)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _one_ulp(got, want)
    assert torch.all(got[sum(layout[0]):] == 0)


def _fmts():
    return ["int8"] + (["fp8_e4m3"] if kvq.supports_fp8() else [])


def _to_torch(vals):
    """A JAX int8 or fp8-e4m3 array as a torch tensor of the same bytes."""
    a = np.asarray(vals)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


@pytest.mark.parametrize("fmt", _fmts())
@pytest.mark.parametrize("layout", RAGGED, ids=lambda l: f"{l[2:6]}")
def test_paged_attention_ragged_quant_bf16_q_matches_pallas(layout, fmt):
    """B2 with a bf16 q over int8 / fp8-e4m3 pools quantized by the JAX
    package (scale tables = block tables), the output in q's dtype."""
    *shape, window = layout
    (qj, qt), pools, meta = _ragged(*shape, seed=3)
    spec = kvq.kv_quant_spec(fmt)
    (kq, ks), (vq, vs) = (kvq.quantize_kv(jnp.asarray(a, jnp.float32), spec)
                          for a in pools)
    bt = meta[0]
    want = jax_ragged_quant(qj, kq, vq, ks, vs, bt[0], bt[0],
                            *(m[0] for m in meta[1:]), window=window,
                            interpret=True)
    got = tpa.paged_attention_ragged_quant(
        qt, _to_torch(kq), _to_torch(vq), torch.from_numpy(np.array(ks)),
        torch.from_numpy(np.array(vs)), bt[1], bt[1],
        *(m[1] for m in meta[1:]), window=window)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _one_ulp(got, want)


# -- B4: the expert GEMM ---------------------------------------------------

@pytest.mark.parametrize("e,c,k,n,bc,bn,bk", [
    (2, 32, 32, 32, 32, 32, 32), (4, 64, 96, 128, 32, 64, 32),
    (1, 128, 128, 128, 128, 128, 128), (8, 16, 48, 64, 16, 64, 16)])
def test_moe_gmm_bf16_matches_pallas(e, c, k, n, bc, bn, bk):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((e, c, k)) * 0.3)
    wj, wt = _pair(rng.standard_normal((e, k, n)) * 0.3)
    want = jax_gmm(xj, wj, bc=bc, bn=bn, bk=bk, interpret=True)
    got = tgmm.moe_gmm(xt, wt)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _one_ulp(got, want)


# -- B5: the SSD chunk scan and its backward ------------------------------

SCAN = [(1, 2, 8, 2, 8, 8), (2, 3, 16, 4, 16, 8), (2, 4, 32, 2, 32, 16)]


def _scan_pairs(shape, seed):
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    return [_pair(a) for a in (
        rng.standard_normal((b, nc, l, h, p)) * 0.3,
        -np.abs(rng.standard_normal((b, nc, l, h))) * 0.1,
        rng.standard_normal((b, nc, l, n)) * 0.3,
        rng.standard_normal((b, nc, l, n)) * 0.3)]


@pytest.mark.parametrize("shape", SCAN, ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_bf16_matches_pallas(shape):
    """y in xdt's dtype (one ulp), the state fp32 within the fp32 suite's
    1e-4 (the Pallas kernel returns it (B, H, N, P))."""
    pairs = _scan_pairs(shape, seed=5)
    yj, sj = jax_scan(*(p[0] for p in pairs), interpret=True)
    yt, st = tscan.mamba_chunk_scan(*(p[1] for p in pairs))
    assert yt.dtype == BF16 and yj.dtype == jnp.bfloat16
    assert st.dtype == torch.float32
    _one_ulp(yt, yj)
    np.testing.assert_allclose(st.numpy(), np.moveaxis(np.asarray(sj), -2, -1),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SCAN, ids=lambda s: "x".join(map(str, s)))
def test_mamba_chunk_scan_backward_bf16_matches_jax_vjp(shape):
    """The gradients through ``mamba_chunk_scan_op`` (fp32 y, as the model
    asks) against ``jax.vjp`` of ``ssd_chunked`` on the same inputs, at
    the dtypes the model gives B5 and the only ones its backward takes:
    fp32 xdt and a_dt with bf16 b and c. Each gradient in its input's
    dtype (the VJP of ``.astype(f32)`` rounds the cotangent once): one
    bf16 ulp, 1e-4 of the max for the fp32 sums' order (the fp32 suite's
    bar), and fp32 gradients within that 1e-4 alone."""
    b, nc, l, h, p, n = shape
    pairs = _scan_pairs(shape, seed=6)
    pairs[:2] = [(j.astype(jnp.float32), t.float()) for j, t in pairs[:2]]
    dy = np.random.default_rng(7).standard_normal(
        (b, nc, l, h, p)).astype(np.float32)

    def jax_y(x, a, bm, cm):
        return ssd_chunked(x.reshape(b, nc * l, h, p), a.reshape(b, nc * l, h),
                           bm.reshape(b, nc * l, n), cm.reshape(b, nc * l, n),
                           l)[0].reshape(b, nc, l, h, p)

    y, vjp = jax.vjp(jax_y, *(pr[0] for pr in pairs))
    want = vjp(jnp.asarray(dy))
    ins = [pr[1].clone().requires_grad_() for pr in pairs]
    yt, _ = mamba_chunk_scan_op(*ins, None, torch.float32)
    assert yt.dtype == torch.float32
    got = torch.autograd.grad(yt, ins, torch.from_numpy(dy))
    for name, g, w, t in zip("xabc", got, want, ins):
        assert g.dtype == t.dtype and str(w.dtype) == str(t.dtype)[6:]
        g = g.float().numpy().astype(np.float64)
        w = np.asarray(w.astype(jnp.float32), np.float64)
        ulp = 2.0 ** -7 if t.dtype == BF16 else 0.0
        bar = ulp * np.abs(w) + 1e-4 * np.abs(w).max()
        assert np.all(np.abs(g - w) <= bar), (name,
                                              float(np.abs(g - w).max()))


# -- the dtypes taken and refused -----------------------------------------

def test_wrappers_take_bf16_and_refuse_fp16():
    (qj, qt), pools, meta = _ragged(*RAGGED[0][:-1])
    k, v = (torch.from_numpy(a).float() for a in pools)
    m = {n: t[1] for n, t in zip(("context_lens", "q_starts", "q_lens",
                                  "pos0"), meta[1:])}
    tpa._check(qt, k.to(BF16), v.to(BF16), meta[0][1], m)   # bf16 taken
    with pytest.raises(TypeError):
        tpa._check(qt.half(), k.half(), v.half(), meta[0][1], m)
    with pytest.raises(TypeError):                           # pools != q
        tpa._check(qt, k, v, meta[0][1], m)
    x = torch.zeros((2, 4, 8), dtype=BF16)
    tgmm._check(x, torch.zeros((2, 8, 12), dtype=BF16))
    with pytest.raises(TypeError):
        tgmm._check(x.half(), torch.zeros((2, 8, 12), dtype=torch.half))
    xs = [t.contiguous() for _, t in _scan_pairs(SCAN[1], seed=8)]
    tscan._check(*xs, None)
    tscan._check(xs[0].float(), xs[1].float(), *xs[2:], None)
    with pytest.raises(TypeError):
        tscan._check(*(t.half() for t in xs), None)


def test_model_opts_take_fp32_and_bf16_only():
    for name in ("param_dtype", "compute_dtype", "cache_dtype"):
        for dt in (torch.float32, BF16):
            assert getattr(ModelOpts(**{name: dt}), name) == dt
        for dt in (torch.float16, torch.float64):
            with pytest.raises(TypeError, match="fp16: ROADMAP B6"):
                ModelOpts(**{name: dt})


def test_weight_bridge_carries_bf16_exactly():
    rng = np.random.default_rng(9)
    tree = {"a": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "b": [jnp.asarray(rng.standard_normal(4), jnp.bfloat16)]}
    t = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", BF16)
    assert t["a"].dtype == BF16 and t["b"][0].dtype == BF16
    back = params_to_numpy(t)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(got, np.asarray(want, np.float32))


# -- optimizer steps on bf16 parameters -----------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_step_on_bf16_params_matches_jax(name):
    """fp32 moments, fp32 math, each new parameter rounded once to bf16:
    the new parameters within one bf16 ulp of JAX's (the fp32 updates may
    differ in the last bit and round apart), the moments within 1e-6
    relative."""
    rng = np.random.default_rng(10)
    shapes = {"w": (16, 12), "norm": (12,), "e": (3, 8, 9)}
    pj, pt = {}, {}
    gj, gt = {}, {}
    for k, s in shapes.items():
        pj[k], pt[k] = _pair(rng.standard_normal(s))
        gj[k], gt[k] = _pair(rng.standard_normal(s) * 0.1)
    cfg = OptConfig(name=name)
    jcfg = jax_opt.OptConfig(name=name)
    sj = jax_opt.init_opt_state(pj, jcfg)
    st = init_opt_state(pt, cfg)
    for _ in range(2):
        pj, sj = jax_opt.apply_updates(pj, gj, sj, jcfg)
        pt, st = apply_updates(pt, gt, st, cfg)
    for k in shapes:
        assert pt[k].dtype == BF16
        _one_ulp(pt[k], pj[k], k)
    for key in [k for k in st if k != "step"]:
        for k in shapes:
            np.testing.assert_allclose(st[key][k].numpy(),
                                       np.asarray(sj[key][k]), rtol=1e-6,
                                       atol=1e-12)


# -- checkpoints ------------------------------------------------------------

def test_bf16_checkpoint_round_trip_and_jax_file(tmp_path):
    """The port writes a bf16 leaf as JAX does (``|V2``, its raw bytes),
    reads it back bit for bit, and reads a JAX-written bf16 ``.npz``."""
    rng = np.random.default_rng(11)
    tree = {"p": torch.from_numpy(rng.standard_normal((4, 6)).astype(
        np.float32)).to(BF16), "m": torch.ones(3), "step": torch.tensor(
        2, dtype=torch.int32), "l": [torch.arange(5).to(BF16)]}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tree)
    with np.load(path) as z:
        assert z["p"].dtype == np.dtype("V2") and z["m"].dtype == np.float32
    back = load_checkpoint(path, device="cpu")
    for k in ("p", "m", "step"):
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k].view(torch.uint8) if k == "p" else back[k],
                           tree[k].view(torch.uint8) if k == "p" else tree[k])
    assert torch.equal(back["l"][0], tree["l"][0])
    jtree = {"w": jnp.asarray(rng.standard_normal((3, 7)), jnp.bfloat16),
             "s": jnp.int32(4)}
    jpath = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jpath, jtree)
    got = load_checkpoint(jpath, device="cpu")
    assert got["w"].dtype == BF16 and int(got["s"]) == 4
    assert np.array_equal(got["w"].float().numpy(),
                          np.asarray(jtree["w"], np.float32))
