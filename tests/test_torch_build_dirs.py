"""Where the port builds its native libraries (utils/build_dirs.py): the
checkout's build/ for a package that sits in a source checkout, a per-user
cache directory for an installed copy; the CUDA kernels (ops/kernels/
_build.py) and the C++ host library (native/bindings.py) follow the one
rule."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cooperativeimagecaptioning_tpu_torch.native import bindings
from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
from cooperativeimagecaptioning_tpu_torch.utils import build_dirs

REPO = Path(__file__).resolve().parents[1]


def test_a_checkout_builds_under_its_build_dir():
    assert build_dirs.PACKAGE == REPO / "cooperativeimagecaptioning_tpu_torch"
    assert build_dirs.checkout() == REPO
    assert build_dirs.build_root() == REPO / "build"
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    assert bindings.BUILD_DIR == REPO / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("xdg", [True, False])
def test_an_installed_layout_builds_under_the_user_cache(tmp_path,
                                                         monkeypatch, xdg):
    """site-packages/<package> (no pyproject.toml beside it, or one of
    another project): the cache directory, never beside or above
    site-packages."""
    site = tmp_path / "lib" / "python3" / "site-packages"
    pkg = site / build_dirs.PACKAGE.name
    pkg.mkdir(parents=True)
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        cache = tmp_path / "xdg"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        cache = tmp_path / "home" / ".cache"
    want = cache / pkg.name / "build"
    assert build_dirs.checkout(pkg) is None
    assert build_dirs.build_root(pkg) == want
    (site / "pyproject.toml").write_text('[project]\nname = "other"\n')
    assert build_dirs.checkout(pkg) is None
    assert build_dirs.build_root(pkg) == want
    assert not site.is_relative_to(want) and not want.is_relative_to(
        tmp_path / "lib")


def test_an_installed_copy_resolves_both_build_dirs(tmp_path):
    """A copy of the package in a site-packages layout, imported in a fresh
    interpreter from another directory: both libraries resolve under the
    user cache."""
    site = tmp_path / "site-packages"
    shutil.copytree(build_dirs.PACKAGE, site / build_dirs.PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": str(site),
           "XDG_CACHE_HOME": str(tmp_path / "cache")}
    code = ("from cooperativeimagecaptioning_tpu_torch.ops.kernels import "
            "_build\nfrom cooperativeimagecaptioning_tpu_torch.native import "
            "bindings\nprint(_build.__file__)\nprint(_build.BUILD_DIR)\n"
            "print(bindings.BUILD_DIR)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         check=True).stdout.split("\n")
    cache = tmp_path / "cache" / build_dirs.PACKAGE.name / "build"
    assert Path(out[0]).is_relative_to(site)
    assert Path(out[1]) == cache / "kernels"
    assert Path(out[2]) == cache / "native"
    assert not (tmp_path / "build").exists()
