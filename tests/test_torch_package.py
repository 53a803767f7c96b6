"""Package rules of the PyTorch port.

- it imports without JAX and names nothing of the JAX package;
- its entry points default to the card and raise, rather than falling back
  to the CPU, when there is none;
- the selection wrapper never falls back to its plain version for a CUDA
  tensor: a kernel it cannot build is an error;
- ``chip_smoke.py`` fails, printing no result, where there is no card.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparsespatialsampling_torch as tpkg  # noqa: E402
from sparsespatialsampling_torch import _build  # noqa: E402
from sparsespatialsampling_torch.ops import topk  # noqa: E402
from sparsespatialsampling_torch.ops.knn import KNNIndex  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sparsespatialsampling_torch"


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; "
            "import sparsespatialsampling_torch, "
            "sparsespatialsampling_torch.engine.tree, "
            "sparsespatialsampling_torch.export, "
            "sparsespatialsampling_torch.ops.knn, "
            "sparsespatialsampling_torch.parallel; "
            "assert 'sparsespatialsampling_tpu' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("pattern", ["import jax", "from jax",
                                     "sparsespatialsampling_tpu"])
def test_no_file_names_jax(pattern):
    files = [p for p in PACKAGE.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts]
    assert files
    hits = [str(p) for p in files if pattern in p.read_text()]
    assert not hits, hits


def test_smoke_script_names_nothing_of_jax():
    text = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "import sparsespatialsampling_tpu" not in text
    assert "from sparsespatialsampling_tpu" not in text


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    rng = np.random.default_rng(0)
    xy = rng.uniform(size=(200, 2))
    geoms = [tpkg.CubeGeometry("domain", True, [0, 0], [1, 1])]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.SparseSpatialSampling(xy, xy[:, 0], geoms, save_path="unused",
                                   save_name="x")
    with pytest.raises(RuntimeError, match="CUDA"):
        KNNIndex(xy)
    s3 = tpkg.SparseSpatialSampling(xy, xy[:, 0], geoms, save_path="unused",
                                    save_name="x", uniform_levels=1,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.ExportData(s3, write_times=["0"])


def test_cpu_path_takes_no_mesh(tmp_path):
    """With ``VIRTUAL_SHARDS`` and ``DISABLE_SHARDING`` at their defaults
    the CPU takes the single-device path: no mesh in the engine or the
    export, the single-device index, a single-device epoch core."""
    from sparsespatialsampling_torch.parallel import mesh
    assert mesh.VIRTUAL_SHARDS is None and not mesh.DISABLE_SHARDING
    rng = np.random.default_rng(0)
    xy = rng.uniform(size=(500, 2))
    geoms = [tpkg.CubeGeometry("domain", True, [0, 0], [1, 1])]
    s3 = tpkg.SparseSpatialSampling(xy, xy[:, 0], geoms,
                                    save_path=str(tmp_path), save_name="x",
                                    uniform_levels=2, min_metric=0.5,
                                    device="cpu")
    assert s3._sampling._mesh is None
    s3.execute_grid_generation()
    assert type(s3._knn_index) is KNNIndex
    assert s3.data_final_mesh["epoch_stats"]["core"] == "full"
    exp = tpkg.ExportData(s3, write_times=["0"], device="cpu")
    exp.interpolate(xy, xy[:, :1, None])
    assert exp._mesh is None and exp._knn is s3._knn_index


class _CudaStandIn:
    """Quacks like a contiguous f32 CUDA matrix without needing a card."""
    shape = (8, 64)
    dtype = torch.float32
    device = torch.device("cuda")

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    def plain_called(*_):
        raise AssertionError("plain version used for a CUDA tensor")
    monkeypatch.setattr(topk, "topk_smallest_plain", plain_called)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_library_path",
                        lambda src: Path("/nonexistent") / src.name)
    before = topk.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        topk.topk_smallest(_CudaStandIn(), 4)
    assert topk.launches == before


def test_wrapper_rejects_other_devices():
    with pytest.raises(RuntimeError, match="no kernel"):
        topk.topk_smallest(torch.zeros(4, 8, device="meta"), 2)


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "topk_smallest.cu" in {
        p.name for p in _build.SOURCE_DIR.glob("*.cu")}


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the smoke run would pass")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
