"""Meshes over ``torch.distributed`` process groups, and the helper that
starts one process per rank. Port of ``src/repro/launch/mesh.py``.

A ``Mesh`` names its axes and their sizes (``shape``, a dict, as the rule
tables of ``distributed.sharding`` read it), this rank's coordinates and
one process group per axis: the ranks that differ only along it. Ranks are
laid out row-major over the axes, the last fastest, as ``jax.make_mesh``
lays out devices. ``Mesh.abstract`` has no process group; it serves the
rule tables only (``make_production_mesh``'s 16 × 16 and 2 × 16 × 16).

Functions, not module constants: importing this module starts no process
and opens no process group.

``spawn(fn, world, backend, *args)`` runs ``fn(rank, world, *args)`` in
``world`` fresh processes (the ``spawn`` start method) after
``torch.distributed.init_process_group(backend, ...)``, and returns the
ranks' results in rank order. The ranks rendezvous through a file store
in a fresh temporary directory, removed afterwards: no port is taken, so
no other process can take it first. The caller names
the backend (``"nccl"`` for one card a rank, ``"gloo"`` for ranks that
share a card or run on the CPU); nothing switches backend when one fails.
A rank that raises fails the run: ``spawn`` stops every other rank and
raises with that rank's traceback.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch.distributed as dist


class Mesh:
    """Named mesh axes over the ranks of the default process group."""

    def __init__(self, shape: dict, *, coords: Optional[dict] = None,
                 groups: Optional[dict] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = coords
        self.groups = groups

    @classmethod
    def abstract(cls, shape: tuple, names: tuple) -> "Mesh":
        """A mesh of this shape with no process group: for the rule
        tables, which read only ``shape`` and ``axis_names``."""
        return cls(dict(zip(names, shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        if self.groups is None:
            raise ValueError("an abstract mesh has no process group")
        return self.groups[axis]

    def __repr__(self) -> str:
        kind = "abstract " if self.groups is None else ""
        return f"Mesh({kind}{self.shape}, coords={self.coords})"


def _coords(rank: int, sizes: tuple) -> tuple:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _rank_of(coords: tuple, sizes: tuple) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_mesh(shape: tuple, names: tuple) -> Mesh:
    """A mesh of ``shape`` over the ranks of the initialized default group,
    which must hold exactly ``prod(shape)`` ranks. Every rank must call it
    (it creates every axis's groups, a collective call)."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs {need} processes in an "
            f"initialized torch.distributed group; start them with "
            f"repro_torch.launch.mesh.spawn(fn, world={need}, backend=...) "
            f"or torch.distributed.init_process_group(world_size={need})")
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs {need} ranks but "
            f"torch.distributed was started with world_size={have}; start "
            f"{need} processes (launch.mesh.spawn(fn, world={need}, "
            f"backend=...))")
    rank = dist.get_rank()
    mine = _coords(rank, shape)
    groups = {}
    for i, name in enumerate(names):
        # every rank creates every group of the axis, in the same order
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for fixed in itertools.product(*others):
            members = [_rank_of(fixed[:i] + (k,) + fixed[i:], shape)
                       for k in range(shape[i])]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return Mesh(dict(zip(names, shape)), coords=dict(zip(names, mine)),
                groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips/pod; multi-pod = 2 pods = 512 chips (abstract:
    for the rule tables)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.abstract(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """Reduced mesh over the running ranks. Fails loudly, naming the
    processes to start, when ``torch.distributed`` runs fewer (or more)
    ranks than the shape needs."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


# --------------------------------------------------------------------------
# one process per rank
# --------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, init_method: str,
               inbox, results) -> None:
    """A rank's process: take ``fn``'s arguments from ``inbox``, join the
    group, run ``fn``, report its result or its traceback (then exit
    non-zero), leave the group."""
    try:
        args = inbox.get()
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        out = fn(rank, world, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, *args,
          timeout: float = 900.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` new processes joined in one
    ``torch.distributed`` group of ``backend``; returns their results in
    rank order. ``fn`` and ``args`` are pickled (``fn`` by import path).
    Raises, after stopping every rank, when a rank raises or dies or the
    run outlasts ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    # the arguments travel by queue, not with the process object: a child
    # that dies before reading its start-up pipe would block the parent's
    # write of a large one forever
    inbox, results = ctx.Queue(), ctx.Queue()
    store = tempfile.mkdtemp(prefix="spawn-")
    init = "file://" + os.path.join(store, "rendezvous")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world, backend, init, inbox, results))
             for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(args)
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} of {world} died (exit code "
                            f"{p.exitcode}) before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks ran past {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (inbox, results):
            q.cancel_join_thread()      # a dead rank left its copy unread
            q.close()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(world)]
