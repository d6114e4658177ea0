"""Kernel B5's host-side plan and its decomposition, on the CPU.

B5 (``csrc/mamba2_scan.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3e); what it
launches is decided here, in plain Python, from host-known sizes, and
the arithmetic it splits the scan into is held here in plain PyTorch.
Pinned:

* ``mamba2_scan.scan_plan`` at phase 3e's shapes (8 x 2048 tokens, one
  32768-token prompt, 8 x 100 at mamba2-1.3b's heads) and at the edges (L
  1, 5, 64, 100, 127, 128; N 4, 16, 128; P 4, 16, 64; H 1, 5, 9, 64): the
  launch-1 grid covers the chunk's rows in 32-row quarters, the head
  groups of launches 2 and 4 cover every head with the last one
  non-empty, launch 3 has a thread per 4 state elements, and the scratch
  shapes follow LP = L rounded up to 4.
* Shared memory: launches 2 and 4 hold four blocks of 4 warps an SM (16
  resident warps, the design's floor) within the SM's shared memory and
  registers, launch 1 fits a block, and the plan states the sizes that
  the source asserts (the launcher refuses any other).
* ``ref.mamba_chunk_scan_split_ref`` — causal G once per chunk on 32 x 32
  tiles, the chunk states, the carried states, y — against the plain
  version (``ref.mamba_chunk_scan_ref``), the JAX Pallas kernel in
  interpret mode (zero initial state: the TPU kernel takes none) and the
  JAX oracle (with an initial state), on numpy inputs from a seed, at
  1e-4, over chunks of one to four 32-step slabs and ragged ones.
* ``tools/profile_torch_serve.py`` files every kernel of B5 under ``ssm``.
"""
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import mamba_chunk_scan as jax_scan_kernel
from repro.kernels.ref import mamba_chunk_scan_ref as jax_scan_ref
from repro_torch.configs import get
from repro_torch.kernels import _build
from repro_torch.kernels import mamba2_scan as tms
from repro_torch.kernels import ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ATOL = 1e-4
SM_SMEM = 233472          # bytes of shared memory an H100 SM holds
BLOCK_SMEM = 232448       # what one block may opt in to
REGS = 65536              # 32-bit registers an SM holds


def _kernels(src: str) -> list:
    return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(",
                      src)


def _phase_3e_shapes():
    cfg = get("mamba2-1.3b")
    return [cs.scan_shape(cfg, b, s) for _, b, s in cs.SSM_STEPS]


@pytest.mark.parametrize("shape, heads", list(zip(_phase_3e_shapes(),
                                                  (4, 8, 1))),
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_scan_plan_at_phase_3e_steps(shape, heads):
    """(l) 128 chunks take 4 heads a block (8 would make 1024 blocks,
    under two waves of 528), (m) 256 chunks 8, (n) 8 chunks 1."""
    b, nc, l, h, p, n = shape
    plan = tms.scan_plan(*shape)
    assert plan.state.heads == plan.scan.heads == heads
    assert plan.scan.grid == plan.state.grid == (h // heads, nc, b)
    assert plan.prep.grid == (-(-plan.lp // 32), nc, b)
    blocks = h // heads * nc * b
    assert blocks >= tms.WAVES * tms.H100_SMS * tms.BLOCKS_PER_SM or heads == 1
    assert plan.scratch["states"] == (b, nc, h, n, p)
    assert plan.scratch["gt"] == (b, nc, l, plan.lp)


@pytest.mark.parametrize("h", [1, 5, 9, 64])
@pytest.mark.parametrize("l", [1, 5, 64, 100, 127, 128])
def test_scan_plan_covers_every_row_head_and_state_element(l, h):
    for n in (4, 16, 128):
        for p in (4, 16, 64):
            for b, nc in ((1, 1), (2, 3), (1, 300), (8, 16)):
                plan = tms.scan_plan(b, nc, l, h, p, n)
                lp = plan.lp
                assert lp % 4 == 0 and l <= lp < l + 4
                gx = plan.prep.grid[0]
                assert (gx - 1) * 32 < lp <= gx * 32
                assert plan.prep.grid[1:] == (nc, b)
                hb = plan.scan.heads
                assert hb in (1, 2, 4, 8) and plan.state.heads == hb
                groups = plan.scan.grid[0]
                assert (groups - 1) * hb < h <= groups * hb
                assert plan.scan.grid[1:] == plan.state.grid[1:] == (nc, b)
                quads = b * h * n * p // 4
                (px,) = plan.state_pass.grid
                assert (px - 1) * plan.state_pass.threads < quads <= (
                    px * plan.state_pass.threads)
                assert plan.scratch == {
                    "states": (b, nc, h, n, p), "decay": (b, nc, h),
                    "acum": (b, nc, h, lp), "ct": (b, nc, n, lp),
                    "gt": (b, nc, l, lp)}
                for launch in plan.launches.values():
                    assert all(1 <= g <= 2 ** 31 - 1 for g in launch.grid)
                    assert all(g <= 65535 for g in launch.grid[1:])


def test_launches_2_and_4_keep_16_warps_on_an_sm():
    """Four blocks of 128 threads: 16 warps within the SM's shared memory
    (each block also reserves 1 KB) and, at 128 registers a thread, its
    registers; launch 1 fits one block."""
    plan = tms.scan_plan(8, 16, 128, 64, 64, 128)
    for launch in (plan.state, plan.scan):
        assert launch.threads == 128 and launch.smem == tms.PIPE_SMEM
        assert tms.BLOCKS_PER_SM * (launch.smem + 1024) <= SM_SMEM
        assert tms.BLOCKS_PER_SM * launch.threads * 128 <= REGS
        blocks = min(SM_SMEM // (launch.smem + 1024),
                     REGS // (launch.threads * 128))
        assert blocks * launch.threads // 32 >= 16
    assert plan.prep.smem == tms.PREP_SMEM <= BLOCK_SMEM
    assert plan.state_pass.smem == 0


def test_plan_states_the_sources_shared_memory():
    """The launcher refuses a plan whose shared memory is not the source's:
    the sizes the source asserts are the plan's, and so are its slab,
    stages, slots and threads."""
    src = (_build.CSRC / _build.SOURCES["mamba2_scan"]).read_text()
    asserted = dict(re.findall(r"static_assert\((k\w+Bytes) == (\d+)", src))
    assert int(asserted["kPipeBytes"]) == tms.PIPE_SMEM == 50688
    assert int(asserted["kPrepBytes"]) == tms.PREP_SMEM == 84480
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["KS"]) == tms.SLAB
    assert int(consts["kThreads"]) == tms.THREADS
    assert int(consts["kBlocksPerSM"]) == tms.BLOCKS_PER_SM
    assert int(consts["kAcumSlots"]) == tms.ACUM_SLOTS
    assert int(consts["kPrepThreads"]) == tms.PREP_THREADS
    assert int(consts["kPassThreads"]) == tms.PASS_THREADS
    assert _kernels(src) == list(tms.KERNELS)


def _scan_inputs(b, nc, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, nc, l, h, p) * 0.3, -np.abs(f(b, nc, l, h)) * 0.1,
            f(b, nc, l, n) * 0.3, f(b, nc, l, n) * 0.3, f(b, h, p, n) * 0.3)


# (B, NC, L, H, P, N): the JAX suite's sweep, then one slab exactly, one
# step past it, a ragged chunk over three slabs with P < N, four slabs
SPLIT_SHAPES = [(1, 2, 8, 2, 8, 8), (2, 3, 16, 4, 16, 8), (2, 4, 32, 2, 32, 16),
                (1, 2, 33, 3, 8, 16), (2, 2, 70, 2, 12, 16),
                (1, 2, 128, 2, 8, 4)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_reference_matches_plain_pallas_and_jax(shape, init):
    x, a, b, c, s0 = _scan_inputs(*shape, seed=3)
    t = [torch.from_numpy(v) for v in (x, a, b, c, s0)]
    s0_t = t[4] if init else None
    y_s, st_s = tref.mamba_chunk_scan_split_ref(*t[:4], s0_t)
    y_p, st_p = tref.mamba_chunk_scan_ref(*t[:4], s0_t)
    assert y_s.shape == shape[:5]
    assert st_s.shape == (shape[0], shape[3], shape[4], shape[5])
    for got, want in ((y_s, y_p), (st_s, st_p)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
    if init:
        y_j, st_j = jax_scan_ref(x, a, b, c, s0)
    else:
        y_j, st_k = jax_scan_kernel(x, a, b, c, interpret=True)
        st_j = np.moveaxis(np.asarray(st_k), -2, -1)   # (N, P) → (P, N)
    np.testing.assert_allclose(y_s.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(st_s.numpy(), np.asarray(st_j), atol=ATOL,
                               rtol=0)


def test_split_reference_forms_only_the_causal_tiles(monkeypatch):
    """C Bᵀ is formed on the 32 x 32 tiles at or below the diagonal only:
    at L = 96, 6 of the 9 tiles; and fp32 stays within 1e-5 of fp64."""
    shape = (1, 1, 96, 2, 8, 16)
    x, a, b, c, _ = (torch.from_numpy(v) for v in _scan_inputs(*shape))
    y, _ = tref.mamba_chunk_scan_split_ref(x, a, b, c)
    y64, _ = tref.mamba_chunk_scan_split_ref(x.double(), a.double(),
                                             b.double(), c.double())
    assert y.dtype == torch.float32 and y64.dtype == torch.float64
    assert float((y.double() - y64).abs().max()) < 1e-5
    tiles, einsum = [], torch.einsum

    def recorded(eq, *ops):
        if eq == "bcin,bcjn->bcij":
            tiles.append((ops[0].shape[2], ops[1].shape[2]))
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, "einsum", recorded)
    tref.mamba_chunk_scan_split_ref(x, a, b, c)
    assert tiles == [(32, 32)] * 6


def test_profile_classes_every_b5_kernel():
    """tools/profile_torch_serve.py files each of B5's kernels under
    ``ssm``, demangled as the profiler prints it or mangled."""
    sys.path.insert(0, str(ROOT / "tools"))
    import profile_torch_serve as prof
    src = (_build.CSRC / _build.SOURCES["mamba2_scan"]).read_text()
    names = _kernels(src)
    assert names == list(tms.KERNELS)
    for name in names:
        assert prof.classify(f"(anonymous namespace)::{name}(float const*)",
                             "kernel") == "ssm", name
        assert prof.classify(f"_ZN12_GLOBAL__N_1{len(name)}{name}Ev",
                             "kernel") == "ssm", name
