"""The PyTorch/CUDA port stands alone.

* No module of ``src/repro_torch/`` — nor ``chip_smoke.py`` — imports
  ``jax``, ``jaxlib`` or the JAX package ``repro``, at the top of a file
  or nested in a function (an AST scan, one case per file).
* The serving and training entry points default to the card and refuse
  to carry on without one; the kernel wrappers never fall back to their plain
  versions off the CPU.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.formats import HostCSR, bcc_from_host, tiled_csr_from_host
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels import _build, ops
from repro_torch.kernels.cluster_spgemm import cluster_spgemm_windows
from repro_torch.kernels.cluster_spmm import cluster_spmm_compact
from repro_torch.launch.train import run_training
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.planner.service import Planner
from repro_torch.serve.engine import SpGEMMServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.append(str(node.args[0].value))
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_nothing_of_jax_or_the_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_port_tree_is_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"formats.py", "ops.py", "service.py", "engine.py",
            "calibration.py", "queue.py", "estimator.py", "batcher.py",
            "frontend.py", "benchlib.py", "pipeline.py",
            "chip_smoke.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/benchlib.py",
            "src/repro_torch/distributed/__init__.py",
            "src/repro_torch/distributed/pipeline.py",
            "src/repro_torch/distributed/compression.py",
            "src/repro_torch/distributed/elastic.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/launch/presets.py",
            "src/repro_torch/launch/train.py"} <= rel


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Planner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpGEMMServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpGEMMServer(device="cuda:0")
    assert Planner(device="cpu").device.type == "cpu"
    assert SpGEMMServer(device="cpu").planner.device.type == "cpu"
    # the training path
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("mamba2-370m", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(DataConfig(vocab_size=8, seq_len=4, global_batch=1), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_opt_state({"w": torch.zeros(2)}, AdamWConfig())
    assert init_opt_state({"w": torch.zeros(2)}, AdamWConfig(),
                          device="cpu").mu["w"].device.type == "cpu"


def test_unknown_device_type_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        Planner(device="meta")


def _small_operands():
    rng = np.random.default_rng(0)
    dense = ((rng.random((24, 24)) < 0.2)
             * rng.integers(1, 4, (24, 24))).astype(np.float32)
    h = HostCSR.from_dense(dense)
    bcc = bcc_from_host(h, block_k=16, device="cpu")
    tiled = tiled_csr_from_host(h, block_k=16, bn=16, device="cpu")
    return bcc, tiled


def test_window_wrapper_off_the_cpu_launches_or_raises():
    """A tensor that is not on the CPU never takes the plain version: on
    a device the kernel cannot run on, the wrapper raises."""
    bcc, tiled = _small_operands()
    pack = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    w = pack.launch
    w_meta = dataclasses.replace(
        w, win_ptr=w.win_ptr.to("meta"), win_out=w.win_out.to("meta"),
        slots=w.slots.to("meta"), a_idx=w.a_idx.to("meta"))
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        cluster_spgemm_windows(w_meta, pack.stream[2].to("meta"),
                               tiled.tiles.to("meta"))


def test_spmm_wrapper_off_the_cpu_launches_or_raises():
    bcc, _ = _small_operands()
    block_ids, tile_ids, vals = ops.bcc_compact_stream(
        bcc, cover_all_blocks=True)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        cluster_spmm_compact(block_ids, tile_ids, vals.to("meta"),
                             torch.zeros((24, 8), device="meta"),
                             block_r=8, block_k=16, nblocks=bcc.nblocks)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The CUDA path builds its kernels from source and raises when it
    cannot — there is no prebuilt fallback and no plain-version retreat."""
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("cluster_spgemm")
    assert list(tmp_path.iterdir()) == []


def test_kernel_library_names_carry_the_source_hash():
    paths = {name: _build._lib_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, path in paths.items():
        assert pathlib.Path(path).name.startswith(name + "-")
        assert pathlib.Path(path).parent == pathlib.Path(_build.build_dir())
