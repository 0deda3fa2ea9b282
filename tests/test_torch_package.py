"""Boundaries of the PyTorch port: what it imports, where it runs, and that
CPU tensors never reach the CUDA kernels."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import anemoi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(anemoi_tpu_torch.__path__, "anemoi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
FORBIDDEN = ("jax", "flax", "sklearn", "yaml", "msgpack", "pydantic", "orbax", "optax",
             "matplotlib", "mlflow", "wandb", "boto3", "anemoi_tpu")
bad = sorted(
    m for m in sys.modules
    if m in FORBIDDEN or m.startswith(tuple(f + "." for f in FORBIDDEN))
)
print(len(names), bad)
"""


def test_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port imports; none of jax, flax, sklearn, yaml,
    msgpack, pydantic, orbax, optax, matplotlib, mlflow, wandb, boto3 or
    anemoi_tpu / anemoi_tpu.* is loaded (``anemoi_tpu_torch`` itself starts with the string
    ``anemoi_tpu``, so the check is on the module name and the
    ``anemoi_tpu.`` prefix)."""
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 93
    assert bad.strip() == "[]", bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    from anemoi_tpu_torch.flagship import (
        flagship_config, flagship_indices, flagship_recipe, flagship_statistics,
    )
    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    graph = GraphCreator(flagship_recipe("o8", 1)).create()
    with pytest.raises(RuntimeError, match="CUDA"):
        AnemoiModelInterface(
            config=flagship_config(16, 1, 2), graph=graph, data_indices=flagship_indices(),
            statistics=flagship_statistics(),
        )


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel modules import without a CUDA toolkit; building fails
    loudly when nvcc cannot be found."""
    from anemoi_tpu_torch.kernels import build
    from anemoi_tpu_torch.kernels import gt_attention as kern  # noqa: F401  (imports)

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()


def test_cpu_tensors_take_the_plain_path():
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe

    rng = np.random.default_rng(0)
    ei = torch.tensor([[0, 1, 2, 1], [0, 0, 1, 2]], dtype=torch.int32)
    ptr = torch.tensor([0, 2, 3, 4], dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32)) for _ in range(3))
    before = (kern.gt_attention_fused_edge.launches, kern.gt_attention_edge.launches)
    gt_attention(q, k, v, torch.ones(4, 8), ei, ptr, 2)
    gt_attention_fe(q, k, v, torch.ones(4, 3), torch.ones(3, 8), torch.zeros(8), ei, ptr, 2)
    assert (kern.gt_attention_fused_edge.launches, kern.gt_attention_edge.launches) == before
    assert before == (0, 0)
