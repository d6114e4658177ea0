"""The port's MoE FFN and kernel B4's plain version against the JAX package.

The same numpy inputs go through the port (``repro_torch.models.moe``,
``repro_torch.kernels``) and the JAX package (``repro.models.moe``,
``repro.kernels``: the oracle, the Pallas ``moe_gmm`` in interpret mode and
its 128-padding op), in fp32, on the CPU. Pinned:

* ``moe_gmm_ref`` at the JAX suite's shapes and bar (2e-4·√K,
  tests/test_kernels.py::test_moe_gmm_sweep) and at edge shapes that are
  not tile multiples; the op on CPU tensors takes the plain version and
  counts no launch; the wrapper's checks refuse what kernel B4 does not
  take;
* ``_capacity`` equal as integers for T in 1..9000, both archs;
* ``_route``: experts equal, gates within 1e-6;
* ``moe_dense_exact`` and ``moe_capacity`` within 1e-5 (fp32 through two
  BLAS libraries), on the reduced mixtral-8x7b and kimi-k2-1t-a32b
  ``MoEConfig``s, below and above ``router_chunk``, with
  ``capacity_factor=1.0`` so that slots drop, and a ``valid`` mask; the
  dispatch arrays (``slot_token``, ``keep``) equal a transcription of the
  JAX chunk body's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import get_reduced
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm
from repro.kernels.ops import moe_gmm_op as jax_moe_gmm_op
from repro.kernels.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import moe as jm
from repro_torch.configs import get as torch_get
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels.ops import moe_gmm_op
from repro_torch.kernels.ref import moe_gmm_ref
from repro_torch.models import moe as tm

ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
ATOL_MOE = 1e-5


def _tol(k: int) -> float:
    return 2e-4 * k ** 0.5     # tests/test_kernels.py::_tol, fp32


def _gmm_inputs(e, c, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((e, c, k)) * 0.3).astype(np.float32),
            (rng.standard_normal((e, k, n)) * 0.3).astype(np.float32))


# (E, C, K, N, bc, bn, bk): tests/test_kernels.py::test_moe_gmm_sweep
SWEEP = [(2, 32, 32, 32, 32, 32, 32), (4, 64, 96, 128, 32, 64, 32),
         (1, 128, 128, 128, 128, 128, 128), (8, 16, 48, 64, 16, 64, 16)]
# not tile multiples: the CUDA kernel masks these edges (BC 8/32/64, 128
# columns, K slabs of 16); the JAX op pads them to 128
EDGES = [(3, 20, 96, 72), (5, 1, 33, 5), (2, 4, 17, 130), (1, 40, 130, 260),
         (384, 4, 16, 8)]


@pytest.mark.parametrize("shape", SWEEP,
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_moe_gmm_ref_matches_jax_kernel_and_oracle(shape):
    e, c, k, n, bc, bn, bk = shape
    x, w = _gmm_inputs(e, c, k, n)
    got = moe_gmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    kern = np.asarray(jax_moe_gmm(jnp.asarray(x), jnp.asarray(w), bc=bc,
                                  bn=bn, bk=bk, interpret=True))
    oracle = np.asarray(jax_moe_gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == (e, c, n) and got.dtype == np.float32
    assert np.abs(got - kern).max() < _tol(k)
    assert np.abs(got - oracle).max() < _tol(k)


@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
def test_moe_gmm_op_matches_jax_padded_op_at_edges(shape):
    e, c, k, n = shape
    x, w = _gmm_inputs(e, c, k, n, seed=1)
    before = tmg.moe_gmm.launches
    got = moe_gmm_op(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_moe_gmm_op(jnp.asarray(x), jnp.asarray(w),
                                     impl="interpret"))
    assert got.shape == want.shape == (e, c, n)
    assert np.abs(got - want).max() < _tol(k)
    assert np.array_equal(got, moe_gmm_ref(torch.from_numpy(x),
                                           torch.from_numpy(w)).numpy())
    assert tmg.moe_gmm.launches == before      # the CPU: plain version


def _bad(**kw):
    spec = {"x": ((2, 4, 8), torch.float32), "w": ((2, 8, 12), torch.float32)}
    spec.update(kw)
    return [torch.zeros(s, dtype=d) for s, d in spec.values()]


@pytest.mark.parametrize("bad, err", [
    (dict(x=((2, 4, 8), torch.float64)), TypeError),
    (dict(w=((2, 8, 12), torch.bfloat16)), TypeError),
    (dict(x=((8, 4), torch.float32)), ValueError),            # not 3-D
    (dict(w=((3, 8, 12), torch.float32)), ValueError),        # E differs
    (dict(w=((2, 9, 12), torch.float32)), ValueError),        # K differs
    (dict(x=((65536, 0, 8), torch.float32),
          w=((65536, 8, 0), torch.float32)), ValueError),     # E > grid z
])
def test_moe_gmm_check_rejects_what_the_kernel_does_not_take(bad, err):
    x, w = _bad(**bad)
    with pytest.raises(err):
        tmg._check(x, w)


def test_moe_gmm_check_takes_the_valid_baseline_and_rejects_layouts():
    x, w = _bad()
    tmg._check(x, w)
    with pytest.raises(ValueError, match="contiguous"):
        tmg._check(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="on"):
        tmg._check(x, w.to("meta"))
    with pytest.raises(ValueError):
        tmg.moe_gmm(x.to("meta"), w.to("meta"))   # neither CPU nor CUDA


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equal_as_integers(arch):
    for full in (True, False):
        jcfg = (jax_get(arch) if full else get_reduced(arch)).moe
        tcfg = (torch_get(arch) if full else torch_get_reduced(arch)).moe
        for cf in (tcfg.capacity_factor, 1.0):
            jc = dataclasses.replace(jcfg, capacity_factor=cf)
            tc = dataclasses.replace(tcfg, capacity_factor=cf)
            got = [tm._capacity(t, tc) for t in range(1, 9001)]
            want = [jm._capacity(t, jc) for t in range(1, 9001)]
            assert got == want
            assert all(isinstance(c, int) for c in got)


@pytest.fixture(scope="module")
def moe_setups():
    """Reduced MoEConfigs with capacity factor 1.0, so that slots drop, and
    the JAX package's MoE weights as numpy arrays."""
    out = {}
    for i, arch in enumerate(ARCHS):
        red = get_reduced(arch)
        cfg = dataclasses.replace(red.moe, capacity_factor=1.0)
        params = jm.init_moe_params(jax.random.PRNGKey(i), red.d_model, cfg)
        out[arch] = (cfg, red.d_model,
                     {k: np.asarray(v) for k, v in params.items()})
    return out


def _tokens(t, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    valid = rng.random(t) > 0.15
    return x, valid


def _torch_params(np_params):
    return {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_route_gates_and_experts_equal(moe_setups, arch):
    cfg, d, p = moe_setups[arch]
    x, _ = _tokens(50, d, 3)
    gj, ej = jm._route(jnp.asarray(x), jnp.asarray(p["router"]), cfg.top_k)
    gt, et = tm._route(torch.from_numpy(x),
                       torch.from_numpy(p["router"].copy()), cfg.top_k)
    assert np.array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6, rtol=0)


def test_route_breaks_exact_ties_toward_the_lower_expert():
    """A zero token scores every expert 0: the top-k are experts 0..k-1,
    as lax.top_k gives them."""
    router = np.random.default_rng(0).standard_normal((8, 6)).astype(
        np.float32)
    x = np.zeros((3, 8), np.float32)
    _, ej = jm._route(jnp.asarray(x), jnp.asarray(router), 4)
    _, et = tm._route(torch.from_numpy(x), torch.from_numpy(router), 4)
    assert np.array_equal(et.numpy(), np.asarray(ej))
    assert np.array_equal(et.numpy(), np.tile(np.arange(4), (3, 1)))


# T below router_chunk (64 in both reduced configs), at it, and above it
# (2 and 3 chunks, the last zero-padded)
TOKENS = [7, 48, 64, 100, 150]


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_exact_matches_jax(moe_setups, arch, t):
    cfg, d, p = moe_setups[arch]
    x, _ = _tokens(t, d, t)
    want = np.asarray(jm.moe_dense_exact(jnp.asarray(x), p, cfg))
    got = tm.moe_dense_exact(torch.from_numpy(x), _torch_params(p),
                             cfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_MOE, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked"])
@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches_jax(moe_setups, arch, t, masked):
    cfg, d, p = moe_setups[arch]
    x, valid = _tokens(t, d, 100 + t)
    if not masked:
        valid[:] = True
    want = np.asarray(jm.moe_capacity(jnp.asarray(x), p, cfg,
                                      jnp.asarray(valid)))
    before = tmg.moe_gmm.launches
    got = tm.moe_capacity(torch.from_numpy(x), _torch_params(p), cfg,
                          torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_MOE, rtol=0)
    # an invalid token contributes nothing and receives nothing
    assert np.all(got[~valid] == 0.0)
    assert tmg.moe_gmm.launches == before


def _jax_dispatch(x, valid, router, cfg, capacity):
    """The dispatch arrays of src/repro/models/moe.py::_moe_chunk, line for
    line (the JAX function computes them internally)."""
    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, tope = jm._route(x, router, k)
    gates = gates * valid[:, None]
    flat_e = tope.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k
    sg = gates.reshape(-1)[order]
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(t * k, dtype=jnp.int32) - starts[se]
    keep = (pos < capacity) & (sg > 0)
    slot = jnp.where(keep, se * capacity + pos, e * capacity)
    slot_token = jnp.full((e * capacity + 1,), t, jnp.int32).at[slot].set(
        st, mode="drop")[:-1]
    return np.asarray(slot_token), np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("t", [7, 48, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_arrays_equal(moe_setups, arch, t):
    cfg, d, p = moe_setups[arch]
    x, valid = _tokens(t, d, 200 + t)
    cap = tm._capacity(t, cfg)
    want_st, want_keep, want_slot = _jax_dispatch(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(p["router"]), cfg,
        cap)
    dp = tm.dispatch(torch.from_numpy(x), torch.from_numpy(valid),
                     torch.from_numpy(p["router"].copy()), cfg, cap)
    assert np.array_equal(dp.slot_token.numpy(), want_st)
    assert np.array_equal(dp.keep.numpy(), want_keep)
    assert np.array_equal(dp.slot.numpy(), want_slot)
    # capacity factor 1.0 drops valid slots once t·k outgrows it
    n_valid_slots = int(valid.sum()) * cfg.top_k
    if t >= 48:
        assert 0 < int(dp.keep.sum()) < n_valid_slots
    assert tm.router_chunks(t, cfg) == 1
    assert tm.router_chunks(150, cfg) == 3


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_capacity_gives_the_rows_of_every_expert_gemm(
        moe_setups, arch, t, monkeypatch):
    """``chunk_capacity`` and ``router_chunks`` predict the (E, C, K) × (E,
    K, N) products ``moe_capacity`` hands to the op: three per chunk, each
    with C rows per expert."""
    cfg, d, p = moe_setups[arch]
    x, valid = _tokens(t, d, 300 + t)
    shapes = []

    def recorded(xg, w):
        shapes.append((tuple(xg.shape), tuple(w.shape)))
        return moe_gmm_op(xg, w)

    monkeypatch.setattr(tm, "moe_gmm_op", recorded)
    tm.moe_capacity(torch.from_numpy(x), _torch_params(p), cfg,
                    torch.from_numpy(valid))
    c, e = tm.chunk_capacity(t, cfg), cfg.n_experts
    f = cfg.d_ff_expert
    assert shapes == [((e, c, d), (e, d, f)), ((e, c, d), (e, d, f)),
                      ((e, c, f), (e, f, d))] * tm.router_chunks(t, cfg)
