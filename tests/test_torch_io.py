"""The port's HDF5/XDMF layer (``sparsespatialsampling_torch.io``) on files
it did not write: the committed golden file and the reference's own test
dataset.  Every ``Dataloader`` property must equal what the JAX package's
loader reads, the grid must copy through ``Datawriter`` unchanged, and the
XDMF written from the foreign file must parse and match the JAX writer's
output byte for byte."""
import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest

pytest.importorskip("torch")

import sparsespatialsampling_tpu.io as jio  # noqa: E402
import sparsespatialsampling_torch.io as tio  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures")
FILES = ["s_cube_golden.h5", "s_cube_ref_dataset.h5"]


@pytest.mark.parametrize("name", FILES)
def test_dataloader_matches_jax(name):
    a = jio.Dataloader(FIXTURE_DIR, name)
    b = tio.Dataloader(FIXTURE_DIR, name)
    assert (b.n_cells, b.n_dimensions) == (a.n_cells, a.n_dimensions)
    assert b.write_times == a.write_times
    assert b.field_names == a.field_names
    for prop in ("vertices", "nodes", "faces", "levels", "weights",
                 "metric"):
        np.testing.assert_array_equal(getattr(b, prop), getattr(a, prop),
                                      err_msg=prop)
    np.testing.assert_array_equal(b.load_snapshot("p"), a.load_snapshot("p"))


@pytest.mark.parametrize("name", FILES)
def test_grid_copy_and_xdmf_match_jax(name, tmp_path):
    src = tio.Dataloader(FIXTURE_DIR, name)
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        out.mkdir()
        io = jio if pkg == "jax" else tio
        w = io.Datawriter(str(out), "copy.h5")
        w.write_grid(src)
        w.write_data("p", group=io.DATA, time_step="0.4",
                     data=src.load_snapshot("p")[:, 0])
        w.close()
        w = io.Datawriter(str(out), "copy.h5", mode="a")
        w.write_xdmf_file()
    copy = tio.Dataloader(str(tmp_path / "torch"), "copy.h5")
    np.testing.assert_array_equal(copy.faces, src.faces)
    np.testing.assert_array_equal(copy.nodes, src.nodes)
    xa = (tmp_path / "jax" / "copy.xdmf").read_text()
    xb = (tmp_path / "torch" / "copy.xdmf").read_text()
    assert xb == xa
    times = [t.get("Value") for t in ET.parse(
        str(tmp_path / "torch" / "copy.xdmf")).findall(".//Time")]
    assert times == ["0.4"]


def test_xdmf_from_foreign_file(tmp_path):
    shutil.copy(os.path.join(FIXTURE_DIR, FILES[1]), tmp_path / FILES[1])
    w = tio.Datawriter(str(tmp_path), FILES[1], mode="a")
    w.close()
    w.write_xdmf_file()
    root = ET.parse(str(tmp_path / FILES[1].replace(".h5", ".xdmf")))
    refs = [d.text.strip() for d in root.findall(".//DataItem")
            if d.text and ".h5:" in d.text]
    assert any("p_center" in r for r in refs)
