"""The port stands alone: it imports without JAX, without the JAX package,
without a CUDA compiler and without a GPU, and it does not quietly run on
the CPU when asked for the default device."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import reductive_tpu_torch
from reductive_tpu_torch import Pq, convert, io

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "reductive_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_every_module_is_listed():
    for name in ("errors", "io", "convert", "search", "pq.model", "pq.primitives",
                 "ops.assign", "ops.decode", "ops.adc", "ops._build",
                 "linalg", "kmeans", "pq.train", "pq.opq", "pq.traits", "ops.stats",
                 "parallel", "parallel.launch", "parallel.mesh", "parallel.sharded",
                 "utils", "utils.profiling", "_collectives",
                 "examples", "examples.pipeline", "examples.serving"):
        assert f"reductive_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'reductive_tpu' or m.startswith('reductive_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", [ROOT / "chip_smoke.py", *sorted(PKG.rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_neither_jax_nor_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "reductive_tpu", "triton"}, roots


def test_package_imports_without_a_compiler_or_a_gpu():
    # This process has neither; the import at the top of this file is the test.
    assert reductive_tpu_torch.__version__
    from reductive_tpu_torch.ops import launch_counts

    assert all(v >= 0 for v in launch_counts().values())


def test_allow_tf32_is_left_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for path in PKG.rglob("*.py"):
        assert "allow_tf32 = True" not in path.read_text()


def test_default_device_is_cuda_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    cb = np.zeros((2, 4, 4), dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pq.from_numpy(cb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_params(cb, None)
    io.save(tmp_path / "pq.npz", Pq.from_numpy(cb, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.load(tmp_path / "pq.npz")
    assert io.load(tmp_path / "pq.npz", device="cpu").codebooks.device.type == "cpu"


def test_trainers_are_exported_under_the_jax_packages_names():
    import reductive_tpu

    for name in ("linalg", "kmeans", "train_pq", "train_pq_chunked", "train_opq",
                 "train_opq_chunked", "train_gaussian_opq", "train_gaussian_opq_chunked",
                 "bucket_eigenvalues", "create_projection_matrix"):
        assert name in reductive_tpu_torch.__all__ and name in reductive_tpu.__all__
        assert getattr(reductive_tpu_torch, name) is not getattr(reductive_tpu, name)
    for name in ("PqTrainer", "Opq", "GaussianOpq"):
        assert name in reductive_tpu_torch.__all__ and name in reductive_tpu_torch.pq.__all__
        assert name in reductive_tpu.pq.__all__
    from reductive_tpu_torch import ops

    assert callable(ops.pq_assign_stats) and callable(ops.pq_assign_stats_reference)
    assert reductive_tpu_torch.kmeans.__all__[:4] == reductive_tpu.kmeans.__all__[:4]


def test_trainers_raise_without_a_cuda_device_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    x = np.random.default_rng(0).random((64, 8), dtype=np.float32)
    gen = torch.Generator().manual_seed(0)
    for trainer in ("train_pq", "train_pq_chunked", "train_opq", "train_opq_chunked",
                    "train_gaussian_opq", "train_gaussian_opq_chunked"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(reductive_tpu_torch, trainer)(gen, x, 2, 3, 2)
        pq = getattr(reductive_tpu_torch, trainer)(gen, x, 2, 3, 2, device="cpu")
        assert pq.codebooks.device.type == "cpu"
    with pytest.raises(ValueError, match="instances lie on cpu"):
        reductive_tpu_torch.train_pq(gen, torch.from_numpy(x), 2, 3, 2, device="cuda")


def test_a_cuda_tensor_never_takes_the_plain_version():
    # On a CUDA tensor the wrapper launches its kernel or raises: the only
    # branch to the plain version is on ``not x.is_cuda``.
    src = (PKG / "ops" / "stats.py").read_text()
    body = src.split("def pq_assign_stats(")[1]
    assert body.count("pq_assign_stats_reference(") == 1
    assert "if not x.is_cuda:\n        return pq_assign_stats_reference(" in body
    assert "try:" not in body


def test_errors_mirror_the_jax_package():
    from reductive_tpu import errors as jerrors
    from reductive_tpu_torch import errors as terrors

    assert terrors.__all__ == jerrors.__all__
    for name in terrors.__all__:
        assert getattr(terrors, name) is not getattr(jerrors, name)
    with pytest.raises(terrors.ReductiveError) as terr:
        terrors.check_quantizer_invariants(3, 8, 10, 1, 100, 10)
    with pytest.raises(jerrors.ReductiveError) as jerr:
        jerrors.check_quantizer_invariants(3, 8, 10, 1, 100, 10)
    assert str(terr.value) == str(jerr.value)
    assert type(terr.value).__name__ == type(jerr.value).__name__


def test_parallel_and_utils_are_exported_under_the_jax_packages_names():
    import reductive_tpu
    import reductive_tpu.parallel
    import reductive_tpu.utils
    from reductive_tpu_torch import ivf, parallel, search, utils

    assert parallel.__all__ == reductive_tpu.parallel.__all__
    spans = {"span", "recorded_spans"}  # the port's own spans
    assert set(utils.__all__) == (set(reductive_tpu.utils.__all__)
                                  - {"host_callbacks_supported"}) | spans
    for name in parallel.__all__:
        assert getattr(parallel, name) is not getattr(reductive_tpu.parallel, name)
    assert "search_sharded" in search.__all__ and "ivf_search_sharded" in ivf.__all__
    assert {"parallel", "utils"} <= set(reductive_tpu_torch.__all__)
