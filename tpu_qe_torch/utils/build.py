"""Shared-library builds at first use, into the package's build directory.

The directory is listed in .gitignore. A library is rebuilt when any of its
sources is newer than it. Each build writes to a private temporary name and
renames it into place, so processes that build at the same time never load
a half-written file.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def build_library(name: str, sources: list[str],
                  command: list[str]) -> str:
    """Path of lib`name`.so, compiled first if missing or stale.

    `command` is the compiler invocation without the output and sources;
    `-o <tmp> <sources...>` are appended. Raises RuntimeError with the
    compiler's output when it fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(path) and os.path.getmtime(path) >= max(
            os.path.getmtime(s) for s in sources):
        return path
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(command + ["-o", tmp] + sources,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building lib{name}.so failed ({' '.join(command)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
