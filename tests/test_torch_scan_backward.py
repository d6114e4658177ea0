"""B5's backward on the CPU: ``ref.mamba_chunk_scan_backward_ref`` (the
plain backward the wrappers take for CPU tensors),
``ref.mamba_chunk_scan_backward_split_ref`` (the kernel's five launches
in plain PyTorch) and the ``MambaChunkScan`` Function.

Pinned:

* the plain backward against ``jax.vjp`` of the JAX package's
  ``repro.models.mamba2.ssd_chunked`` (the einsum the JAX training
  differentiates), fp32 both, with and without an initial state and a
  final-state cotangent: every gradient within 1e-5·max|g| (fp32 sums
  over at most 128 steps, states and heads in another order);
* the plain backward against autograd through ``mamba_chunk_scan_ref``,
  fp64, within 1e-10·max|g|;
* the split reference against the plain backward, fp64, at chunk
  lengths 16, 33 and 128 (inside one 32-deep slab, one past the slab,
  four slabs), one chunk and several, with and without an initial state
  and a final-state gradient, within 1e-10·max|g|;
* ``torch.autograd.gradcheck`` of ``MambaChunkScan`` in fp64 on the CPU
  (its forward the plain forward, its backward the plain backward), with
  an initial state, without one, and of the final state alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.mamba2_scan import (MambaChunkScan,
                                             mamba_chunk_scan_backward)
from repro_torch.kernels.ref import (mamba_chunk_scan_backward_ref,
                                     mamba_chunk_scan_backward_split_ref,
                                     mamba_chunk_scan_ref)


def _inputs(shape, seed, dtype=np.float32):
    """xdt, a_dt, b, c ~ the chip phase's distributions, an initial state,
    y's and the final state's cotangents, as numpy arrays."""
    b_, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(dtype)
    return {"x": f(b_, nc, l, h, p) * 0.3, "a": -np.abs(f(b_, nc, l, h)) * 0.1,
            "b": f(b_, nc, l, n) * 0.3, "c": f(b_, nc, l, n) * 0.3,
            "s0": f(b_, h, p, n) * 0.3, "dy": f(b_, nc, l, h, p),
            "dfin": f(b_, h, p, n)}


def _close(got, want, rel):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * float(np.abs(w).max()))


# (B, NC, L, H, P, N), initial state, final-state cotangent
VJP_CASES = [((2, 3, 16, 4, 8, 16), False, False),
             ((2, 3, 16, 4, 8, 16), True, True),
             ((1, 2, 33, 3, 16, 8), True, False),
             ((1, 2, 33, 3, 16, 8), False, True),
             ((1, 1, 128, 2, 16, 32), True, True),
             ((2, 4, 8, 8, 16, 16), True, True)]


@pytest.mark.parametrize("shape, init, dfinal", VJP_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{i:d}{d:d}"
                              for s, i, d in VJP_CASES])
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(shape, init, dfinal):
    bsz, nc, l, h, p, n = shape
    d = _inputs(shape, seed=sum(shape) + 2 * init + dfinal)
    flat = lambda t, *tail: t.reshape(bsz, nc * l, *tail)
    primals = [jnp.asarray(flat(d["x"], h, p)), jnp.asarray(flat(d["a"], h)),
               jnp.asarray(flat(d["b"], n)), jnp.asarray(flat(d["c"], n))]
    if init:
        primals.append(jnp.asarray(d["s0"]))
    fn = lambda *t: ssd_chunked(*t[:4], l, t[4] if init else None)
    _, vjp = jax.vjp(fn, *primals)
    dfin = d["dfin"] if dfinal else np.zeros_like(d["dfin"])
    want = vjp((jnp.asarray(flat(d["dy"], h, p)), jnp.asarray(dfin)))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = mamba_chunk_scan_backward_ref(
        t["x"], t["a"], t["b"], t["c"], t["s0"] if init else None, t["dy"],
        t["dfin"] if dfinal else None)
    got = [g.reshape(w.shape).numpy() for g, w in zip(got, want)]
    _close(got, want, 1e-5)


AUTOGRAD_CASES = [(1, 1, 5, 2, 4, 4), (2, 3, 16, 3, 8, 12),
                  (1, 2, 33, 4, 16, 8), (1, 2, 128, 2, 8, 16)]


@pytest.mark.parametrize("shape", AUTOGRAD_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd_through_plain_forward(shape):
    d = {k: torch.from_numpy(v) for k, v in
         _inputs(shape, seed=7, dtype=np.float64).items()}
    ins = [d[k].clone().requires_grad_() for k in ("x", "a", "b", "c", "s0")]
    y, fin = mamba_chunk_scan_ref(*ins)
    want = torch.autograd.grad((y, fin), ins, (d["dy"], d["dfin"]))
    got = mamba_chunk_scan_backward_ref(d["x"], d["a"], d["b"], d["c"],
                                        d["s0"], d["dy"], d["dfin"])
    _close(got, want, 1e-10)


@pytest.mark.parametrize("dfinal", [False, True], ids=["dy", "dy+dfinal"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("l", [16, 33, 128])
def test_split_reference_matches_plain_backward(l, nc, init, dfinal):
    shape = (2, nc, l, 3, 8, 12)
    d = {k: torch.from_numpy(v) for k, v in
         _inputs(shape, seed=l + nc, dtype=np.float64).items()}
    args = (d["x"], d["a"], d["b"], d["c"], d["s0"] if init else None,
            d["dy"], d["dfin"] if dfinal else None)
    want = mamba_chunk_scan_backward_ref(*args)
    got = mamba_chunk_scan_backward_split_ref(*args)
    _close(got, want, 1e-10)


@pytest.mark.parametrize("case", ["state", "zero", "final_only"])
def test_function_gradcheck_fp64(case):
    d = {k: torch.from_numpy(v) for k, v in
         _inputs((1, 2, 5, 2, 4, 4), seed=9, dtype=np.float64).items()}
    ins = [d[k].clone().requires_grad_() for k in ("x", "a", "b", "c")]
    if case == "zero":
        fn = lambda *t: MambaChunkScan.apply(*t, None)
    elif case == "state":
        ins.append(d["s0"].clone().requires_grad_())
        fn = lambda *t: MambaChunkScan.apply(*t)
    else:
        ins.append(d["s0"].clone().requires_grad_())
        fn = lambda *t: MambaChunkScan.apply(*t)[1]
    assert torch.autograd.gradcheck(fn, tuple(ins))


def test_backward_wrapper_honours_needs_on_the_cpu():
    """A gradient not needed comes back as None; a missing ``dy`` counts
    as zeros; nothing launches on the CPU."""
    d = {k: torch.from_numpy(v) for k, v in
         _inputs((1, 2, 8, 2, 4, 4), seed=11).items()}
    before = mamba_chunk_scan_backward.launches
    got = mamba_chunk_scan_backward(d["x"], d["a"], d["b"], d["c"], None,
                                    None, d["dfin"], None,
                                    (True, False, False, True, False))
    want = mamba_chunk_scan_backward_ref(d["x"], d["a"], d["b"], d["c"],
                                         None, torch.zeros_like(d["x"]),
                                         d["dfin"])
    assert got[1] is None and got[2] is None and got[4] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert mamba_chunk_scan_backward.launches == before
