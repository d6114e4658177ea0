"""The port's dry run (``src/repro_torch/launch/dryrun.py``): the records of
``run_cell`` on the production meshes (an ok cell, the skipped
``long_500k`` cell, a failing cell, the sharded-mesh wording in place of
zeros), ``measure`` on a one-device cell (its peak, temp bytes and
``fits_device``) and ``main``'s flags. No card: every step runs on
``meta`` tensors."""
import json

import pytest

import repro_torch.configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
from repro_torch.launch.cost_analysis import tree_bytes
from repro_torch.launch.mesh import Mesh

JAX_KEYS = {"status", "arch", "shape", "mesh", "n_devices", "notes",
            "memory", "flops", "bytes", "model_params",
            "model_params_active"}


@pytest.mark.parametrize("multi_pod,mesh,n", [(False, "pod_16x16", 256),
                                              (True, "multipod_2x16x16",
                                               512)])
def test_run_cell_record(tmp_path, multi_pod, mesh, n):
    rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", multi_pod,
                          str(tmp_path), device_bytes=80 * 10 ** 9)
    assert rec["status"] == "ok", rec.get("traceback")
    assert JAX_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_devices"]) == (mesh, n)
    assert json.loads((tmp_path / mesh / "h2o-danube-1.8b__decode_32k.json")
                      .read_text()) == rec
    m = rec["memory"]
    cell = steps.build_cell("h2o-danube-1.8b", "decode_32k",
                            Mesh.abstract((1, 1), ("data", "model")))
    # a rank holds its share: the rings split over data (batch) and the
    # model axis (KV heads); the weights over the model axis
    assert 0 < m["argument_bytes"] < tree_bytes(cell.args) / 8
    assert 0 < m["alias_bytes"] <= m["output_bytes"]
    assert rec["flops"] > 0 and rec["bytes"] > 0
    # sharded: words, no zeros, for what one device cannot say
    assert "A13b (iv)" in rec["sharded"]
    assert not {"temp_bytes", "peak_bytes"} & set(m)
    assert not {"per_device_hbm_bytes", "collectives", "fits_device",
                "fits_16g"} & set(rec)


def test_skipped_long_context_record(tmp_path):
    rec = dryrun.run_cell("deepseek-67b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skipped"
    assert "pure full attention" in rec["reason"]
    assert (tmp_path / "pod_16x16" / "deepseek-67b__long_500k.json").exists()


def test_error_record(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no such cell")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", False,
                          str(tmp_path))
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: no such cell"
    assert "broken" in rec["traceback"]


@pytest.mark.parametrize("arch,kind", [("h2o-danube-1.8b", "decode"),
                                       ("mamba2-1.3b", "train"),
                                       ("mixtral-8x7b", "prefill")])
def test_measure_one_device(monkeypatch, arch, kind):
    """On one device the record has the peak: arguments + outputs -
    aliases + temp bytes, held against the device's bytes."""
    monkeypatch.setitem(tconfigs.SHAPES, "small",
                        ShapeConfig("small", 512, 2, kind))
    cell = steps.build_cell(arch, "small",
                            Mesh.abstract((1, 1), ("data", "model")),
                            reduced=True)
    rec = dryrun.measure(cell, device_bytes=10 ** 12, device_name="x")
    m = rec["memory"]
    assert m["argument_bytes"] == tree_bytes(cell.args)
    assert rec["per_device_hbm_bytes"] == m["peak_bytes"] == (
        m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
        + m["temp_bytes"])
    assert m["temp_bytes"] > 0
    assert rec["collectives"] == {}
    assert rec["fits_device"] and rec["device"] == "x"
    assert not dryrun.measure(cell, device_bytes=m["peak_bytes"] - 1)[
        "fits_device"]
    if cell.mode == "train":   # the train step updates both in place
        assert m["alias_bytes"] == tree_bytes(cell.args[:2])
    if cell.mode == "decode":  # the rings are written in place
        assert m["alias_bytes"] >= tree_bytes(
            [v for k, v in cell.args[2]["kv"].items()])


def test_main_prints_one_line_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("OK    mamba2-1.3b")
    assert (tmp_path / "pod_16x16" / "mamba2-1.3b__decode_32k.json").exists()
