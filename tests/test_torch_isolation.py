"""Guards of the PyTorch port's boundary and device policy.

* No file of ``src/repro_torch/`` or ``tools/``, and not ``chip_smoke.py``,
  imports ``jax`` or the reference package ``repro`` (an AST scan).
* Importing the port and planning leaves neither in ``sys.modules``.
* Entry points default to the card and raise where CUDA is absent.
* The CUDA kernel's wrapper refuses what the kernel does not take.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import (
    OpticalFabric,
    PlannerOptions,
    PlanRequest,
    batch_evaluate,
    get_pattern,
    plan,
    strawman_instance,
    swot_greedy_grid,
)
from repro_torch.core.convert import packed_from_numpy
from repro_torch.core.ir import TorchBackend, pack_instances
from repro_torch.device import resolve_device
from repro_torch.kernels.timing_scan import timing_scan, timing_scan_cuda

PACKAGE = Path(repro_torch.__file__).resolve().parent
REPO = PACKAGE.parents[1]
FORBIDDEN = ("jax", "repro")


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + sorted((REPO / "tools").glob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    return files


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", ""))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_reference_or_jax_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_planning_loads_neither_jax_nor_reference():
    code = """
import json, sys
import repro_torch
from repro_torch.core import (
    OpticalFabric, PlanRequest, PlannerOptions, get_pattern, plan,
    prestage_for,
)
pattern = get_pattern("pairwise_alltoall", 6, 4e6)
fabric = prestage_for(OpticalFabric(6, 3, t_recfg=2e-4), pattern)
result = plan(PlanRequest.grid(
    [(fabric, pattern)] * 2, options=PlannerOptions(device="cpu")
))
result.schedule(1).validate()
print(json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
)))
"""
    env = dict(os.environ, PYTHONPATH=str(PACKAGE.parent))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _cells():
    pattern = get_pattern("ring_allreduce", 4, 1e6)
    return [(OpticalFabric(4, 2), pattern)] * 2


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan(PlanRequest.grid(_cells()))
    with pytest.raises(RuntimeError, match="CUDA"):
        plan(PlanRequest.single(
            *_cells()[0], options=PlannerOptions(method="strawman")
        ))
    with pytest.raises(RuntimeError, match="CUDA"):
        swot_greedy_grid(_cells())
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_evaluate([strawman_instance(*_cells()[0])])
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("single", [False, True], ids=["grid", "single"])
def test_backend_on_another_device_is_refused(single, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    options = PlannerOptions(
        method="strawman" if single else "auto",
        device="cuda",
        backend=TorchBackend(device="cpu"),
    )
    request = (
        PlanRequest.single(*_cells()[0], options=options)
        if single
        else PlanRequest.grid(_cells(), options=options)
    )
    with pytest.raises(ValueError, match="backend runs on cpu"):
        plan(request)


def _cpu_packed():
    return packed_from_numpy(
        pack_instances([strawman_instance(*c) for c in _cells()], None), "cpu"
    )


def test_cuda_wrapper_refuses_cpu_tensors():
    before = timing_scan.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        timing_scan_cuda(_cpu_packed())
    assert timing_scan.launches == before


@pytest.mark.parametrize(
    "corrupt",
    ["float32_vol", "int32_cfg", "missing_key", "bad_shape", "strided"],
)
def test_wrapper_rejects_malformed_batches(corrupt):
    packed = _cpu_packed()
    if corrupt == "float32_vol":
        packed["vol"] = packed["vol"].float()
    elif corrupt == "int32_cfg":
        packed["step_cfg"] = packed["step_cfg"].int()
    elif corrupt == "missing_key":
        del packed["ready"]
    elif corrupt == "bad_shape":
        packed["bw"] = packed["bw"][:1]
    else:
        packed["vol"] = packed["vol"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        timing_scan(packed)
