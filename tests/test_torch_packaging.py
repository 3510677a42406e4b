"""pyproject.toml names every package of the port, ships its native and
CUDA sources, and installs its command line."""
from __future__ import annotations

import fnmatch
import tomllib
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kiri_tpu_torch"


def _project():
    return tomllib.loads((REPO / "pyproject.toml").read_text())


def test_every_port_package_is_listed():
    listed = set(_project()["tool"]["setuptools"]["packages"])
    found = {".".join(p.parent.relative_to(REPO).parts)
             for p in PORT.rglob("__init__.py")}
    assert found <= listed, sorted(found - listed)
    assert "kiri_tpu_torch.detect.craft" in listed


def test_sources_and_assets_are_package_data():
    data = _project()["tool"]["setuptools"]["package-data"]
    for path in PORT.rglob("*"):
        if path.suffix not in (".cpp", ".cu", ".h", ".cuh", ".npz"):
            continue
        owners = [pkg for pkg in data
                  if path.is_relative_to(REPO / Path(*pkg.split(".")))]
        assert any(fnmatch.fnmatch(
            str(path.relative_to(REPO / Path(*pkg.split(".")))), pattern)
            for pkg in owners for pattern in data[pkg]), path


def test_console_script():
    scripts = _project()["project"]["scripts"]
    assert scripts["kiri-tpu-torch"] == "kiri_tpu_torch.cli:main"
    assert scripts["kiri-tpu"] == scripts["kiri-ocr"] == "kiri_tpu.cli:main"


def test_model_files_fixture_is_package_data():
    data = _project()["tool"]["setuptools"]["package-data"]
    asset = PORT / "assets" / "smoke_models.npz"
    assert asset.exists()
    assert any(fnmatch.fnmatch(str(asset.relative_to(PORT)), pattern)
               for pattern in data["kiri_tpu_torch"])
