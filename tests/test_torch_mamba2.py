"""The port's Mamba2 block and the plain version of kernel B5 against the
JAX package, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages:

* ``ref.mamba_chunk_scan_ref`` (B5's plain version, which the wrapper runs
  for CPU tensors) against the JAX Pallas kernel in interpret mode and the
  JAX ``ref.mamba_chunk_scan_ref`` at the JAX suite's shapes
  (tests/test_kernels.py::test_mamba_chunk_scan_sweep) and at ragged and
  P != N shapes, and with an initial state against the JAX oracle (the
  Pallas kernel starts from zeros): y and the final state within 1e-4,
  the JAX suite's bar;
* ``segsum``, ``softplus`` and ``ssd_step`` against the JAX module's;
* ``ssd_chunked`` with and without an initial state, ``mamba_seq`` with
  and without a cache and ``mamba_step`` on reduced mamba2-1.3b and on a
  variant with head_dim != d_state, at prompts of 24, 16 and 40 tokens
  (shorter than a chunk, one chunk, ragged with a pad), on the JAX
  package's parameters: outputs and caches within 1e-4;
* the port's own step-equals-seq (tests/test_models.py::
  test_mamba_step_equals_seq: S=33, chunk 16, padded) and
  continue-from-cache checks;
* the wrapper refuses, by its checks, what kernel B5 does not take.

Kernel B5 itself runs only on the card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import SSMConfig
from repro.kernels.mamba2_scan import mamba_chunk_scan as jax_scan_kernel
from repro.kernels.ref import mamba_chunk_scan_ref as jax_scan_ref
from repro.models import mamba2 as JM
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import mamba2_scan as tscan
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as TM
from repro_torch.models.module import softplus

ATOL = 1e-4
# (B, NC, L, H, P, N): the JAX suite's sweep, then a ragged chunk with
# P < N and one with P > N (a transposed state would pass at P == N)
SWEEP = [(1, 2, 8, 2, 8, 8), (2, 3, 16, 4, 16, 8), (2, 4, 32, 2, 32, 16)]
SCAN_SHAPES = SWEEP + [(1, 3, 12, 3, 8, 16), (2, 2, 5, 2, 12, 4)]
VARIANTS = {"reduced": None,
            "p8_n16": SSMConfig(d_state=16, head_dim=8, chunk=16)}


def _scan_inputs(b, nc, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, nc, l, h, p) * 0.3, -np.abs(f(b, nc, l, h)) * 0.1,
            f(b, nc, l, n) * 0.3, f(b, nc, l, n) * 0.3, f(b, h, p, n) * 0.3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ids(s):
    return "x".join(map(str, s))


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=_ids)
def test_plain_scan_matches_pallas_kernel_and_jax_oracle(shape):
    x, a, b, c, _ = _scan_inputs(*shape)
    y_k, st_k = jax_scan_kernel(x, a, b, c, interpret=True)   # state (N, P)
    y_r, st_r = jax_scan_ref(x, a, b, c)                      # state (P, N)
    y_t, st_t = ref.mamba_chunk_scan_ref(*_t(x, a, b, c))
    assert y_t.shape == shape[:5]
    assert st_t.shape == (shape[0], shape[3], shape[4], shape[5])
    for y_j, st_j in ((y_k, np.moveaxis(np.asarray(st_k), -2, -1)),
                      (y_r, st_r)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=_ids)
def test_plain_scan_with_initial_state_matches_jax(shape):
    x, a, b, c, s0 = _scan_inputs(*shape, seed=1)
    y_j, st_j = jax_scan_ref(x, a, b, c, s0)
    y_t, st_t = ref.mamba_chunk_scan_ref(*_t(x, a, b, c, s0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=ATOL,
                               rtol=0)


def test_plain_scan_in_fp64_is_the_exact_answer():
    """fp64 inputs keep fp64 (the card checks hold both versions to it)."""
    x, a, b, c, s0 = (t.double() for t in _t(*_scan_inputs(2, 3, 16, 4, 16,
                                                            8, seed=8)))
    y64, st64 = ref.mamba_chunk_scan_ref(x, a, b, c, s0)
    y32, st32 = ref.mamba_chunk_scan_ref(x.float(), a.float(), b.float(),
                                         c.float(), s0.float())
    assert y64.dtype == torch.float64 and y32.dtype == torch.float32
    assert float((y64 - y32.double()).abs().max()) < 1e-5
    assert float((st64 - st32.double()).abs().max()) < 1e-5


def test_wrapper_and_op_take_the_plain_version_on_the_cpu():
    x, a, b, c, s0 = _t(*_scan_inputs(2, 3, 16, 4, 16, 8, seed=2))
    before = tscan.mamba_chunk_scan.launches
    want = ref.mamba_chunk_scan_ref(x, a, b, c, s0)
    bc = torch.cat([b, c], -1)                 # split views, as the model's
    for got in (tscan.mamba_chunk_scan(x, a, b, c, s0),
                ops.mamba_chunk_scan_op(x, a, bc[..., :8], bc[..., 8:], s0)):
        for g, w in zip(got, want):      # BLAS may block the sums anew
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    assert tscan.mamba_chunk_scan.launches == before     # CPU: no launch


@pytest.mark.parametrize("shape,init,error", [
    ((1, 2, 129, 2, 16, 16), False, "L=129"),      # a chunk over 128 steps
    ((1, 2, 16, 2, 16, 132), False, "N=132"),      # a state over 128 wide
    ((1, 2, 16, 2, 72, 16), False, "P=72"),        # a head over 64 wide
    ((1, 2, 16, 2, 6, 16), False, "P=6"),          # not a multiple of 4
    ((1, 2, 16, 2, 16, 16), True, "init_state"),   # a state of another shape
])
def test_wrapper_checks_refuse_what_b5_does_not_take(shape, init, error):
    x, a, b, c, s0 = _t(*_scan_inputs(*shape))
    if init:
        s0 = s0[..., :8].contiguous()
    with pytest.raises(ValueError, match=error):
        tscan._check(x, a, b, c, s0 if init else None)


def test_wrapper_checks_accept_the_model_shapes():
    """mamba2-1.3b at full width (L 128 and a 100-step prompt, N 128,
    P 64) and its reduced config (N 16, P 16): no error."""
    for shape in [(1, 2, 128, 3, 64, 128), (1, 1, 100, 3, 64, 128),
                  (2, 2, 16, 8, 16, 16)]:
        x, a, b, c, s0 = _t(*_scan_inputs(*shape))
        tscan._check(x, a, b, c, None)
        tscan._check(x, a, b, c, s0)
    with pytest.raises(TypeError):
        tscan._check(x.double(), a, b, c, None)
    with pytest.raises(ValueError, match="contiguous"):
        tscan._check(x.transpose(3, 4), a, b, c, None)


def test_segsum_and_softplus_match_jax():
    a = -np.abs(np.random.default_rng(3).standard_normal(
        (2, 3, 10, 4))).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(a)))
    got = ref.segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=0)
    v = np.linspace(-60, 60, 241, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(v)), rtol=1e-6,
                               atol=1e-7)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, a, b, c, st = (f(3, 4, 8) * 0.3, -np.abs(f(3, 4)) * 0.1, f(3, 16),
                      f(3, 16), f(3, 4, 8, 16) * 0.3)
    y_j, st_j = JM.ssd_step(x, a, b, c, st)
    y_t, st_t = TM.ssd_step(*_t(x, a, b, c, st))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=1e-6)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_jax(chunk, init):
    x, a, b, c, s0 = _scan_inputs(2, 1, 32, 8, 16, 16, seed=9)
    x, a, b, c = (v[:, 0] for v in (x, a, b, c))     # (B, S, ...)
    s0 = s0 if init else None
    y_j, st_j = JM.ssd_chunked(x, a, b, c, chunk, s0)
    y_t, st_t = TM.ssd_chunked(*_t(x, a, b, c), chunk,
                               None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), atol=ATOL,
                               rtol=0)


def _configs(variant):
    cfg = get_reduced("mamba2-1.3b")
    tcfg = torch_get_reduced("mamba2-1.3b")
    if VARIANTS[variant] is not None:
        cfg = dataclasses.replace(cfg, ssm=VARIANTS[variant])
        tcfg = dataclasses.replace(tcfg, ssm=VARIANTS[variant])
    params = JM.init_mamba_params(jax.random.PRNGKey(0), cfg)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return cfg, tcfg, params, tparams


def _close(got: dict, want: dict, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("slen", [24, 16, 40])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mamba_seq_and_step_match_jax(variant, slen):
    cfg, tcfg, params, tparams = _configs(variant)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, slen, cfg.d_model)).astype(np.float32) * 0.5
    y_j, c_j = JM.mamba_seq(params, jnp.asarray(x), cfg)
    y_t, c_t = TM.mamba_seq(tparams, torch.from_numpy(x), tcfg)
    assert c_t["ssm"].shape == TM.mamba_cache_shape(tcfg, 2)["ssm"]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    _close(c_t, c_j)
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y_j, c_j = JM.mamba_step(params, jnp.asarray(x1), cfg, c_j)
        y_t, c_t = TM.mamba_step(tparams, torch.from_numpy(x1), tcfg, c_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                                   rtol=0)
        _close(c_t, c_j)
    # a second prompt from that cache: the scan seeded with a state
    x2 = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32) * 0.5
    y_j, c_j = JM.mamba_seq(params, jnp.asarray(x2), cfg, c_j)
    y_t, c_t = TM.mamba_seq(tparams, torch.from_numpy(x2), tcfg, c_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    _close(c_t, c_j)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mamba_step_equals_seq(variant):
    """tests/test_models.py's check on the port: 33 single steps from the
    zero cache give the full pass's outputs and state (chunk 16, the last
    chunk padded)."""
    _, tcfg, _, tparams = _configs(variant)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 33, tcfg.d_model)).astype(np.float32) * 0.5)
    y_full, c_full = TM.mamba_seq(tparams, x, tcfg)
    cache = TM.init_mamba_cache(tcfg, 2)
    ys = []
    for t in range(x.shape[1]):
        yt, cache = TM.mamba_step(tparams, x[:, t:t + 1], tcfg, cache)
        ys.append(yt)
    assert float((torch.cat(ys, 1) - y_full).abs().max()) < 1e-4
    assert float((cache["ssm"] - c_full["ssm"]).abs().max()) < 1e-6


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mamba_seq_continues_from_its_cache(variant):
    """A prompt split at 21 (a ragged chunk, then a second pass starting
    from the first's state and conv tail: B5's initial-state path) gives
    the one-pass outputs and cache."""
    _, tcfg, _, tparams = _configs(variant)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 40, tcfg.d_model)).astype(np.float32) * 0.5)
    y_full, c_full = TM.mamba_seq(tparams, x, tcfg)
    y1, c1 = TM.mamba_seq(tparams, x[:, :21], tcfg)
    y2, c2 = TM.mamba_seq(tparams, x[:, 21:], tcfg, c1)
    assert float((torch.cat([y1, y2], 1) - y_full).abs().max()) < 1e-4
    assert float((c2["ssm"] - c_full["ssm"]).abs().max()) < 1e-5
    assert torch.allclose(c2["conv"], c_full["conv"], atol=1e-6, rtol=0)


def test_init_mamba_params_draws_the_jax_distributions():
    """The port's own initializer: the JAX tree's keys and shapes, the
    deterministic per-head rows exactly, the normal weights' std within
    25 %; stacked over a leading dim."""
    cfg, tcfg, params, _ = _configs("reduced")
    mine = TM.init_mamba_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    stacked = TM.init_mamba_params(tcfg, torch.Generator().manual_seed(0),
                                   "cpu", lead=(3,))
    assert mine.keys() == params.keys() == stacked.keys()
    for k, want in params.items():
        want = np.asarray(want)
        assert tuple(mine[k].shape) == want.shape, k
        assert tuple(stacked[k].shape) == (3,) + want.shape, k
        if k in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
            np.testing.assert_allclose(mine[k].numpy(), want, rtol=1e-6,
                                       err_msg=k)
        else:
            assert float(mine[k].std()) == pytest.approx(
                float(want.std()), rel=0.25), k
