"""Where the port builds its native libraries (the CUDA kernels of
ops/kernels/_build.py, the C++ host library of native/bindings.py).

One rule for both: the `build/` directory of the source checkout when the
package sits in one (its parent holds the repository's pyproject.toml,
which names the package), else a per-user cache directory
(`$XDG_CACHE_HOME`, by default `~/.cache`, then the package's name).  So a
checkout builds beside its sources, in a directory its .gitignore lists,
and an installed copy never writes next to or above site-packages.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]


def checkout(package: Path = PACKAGE):
    """The source checkout holding `package`, or None for an installed
    copy."""
    project = package.parent / "pyproject.toml"
    if project.is_file() and package.name in project.read_text():
        return package.parent
    return None


def build_root(package: Path = PACKAGE) -> Path:
    """The directory the package's libraries are built under."""
    root = checkout(package)
    if root is not None:
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / package.name / "build"
