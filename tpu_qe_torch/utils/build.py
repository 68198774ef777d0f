"""Shared-library builds at first use, into the package's build directory.

The directory is listed in .gitignore. A library is rebuilt when any of its
sources is newer than it. Several sources are compiled at the same time, one
compiler process each, and then linked. Each build writes to private
temporary names and renames the library into place, so processes that build
at the same time never load a half-written file.
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
    `-o <tmp> <sources...>` are appended, for several sources after each
    was compiled with `-c` into an object of its own. Raises RuntimeError
    with the compiler's output when it fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(path) and os.path.getmtime(path) >= max(
            os.path.getmtime(s) for s in sources):
        return path
    with tempfile.TemporaryDirectory(prefix=f"lib{name}.", dir=BUILD_DIR) as d:
        inputs = sources
        if len(sources) > 1:
            inputs = [os.path.join(d, f"{i}.o") for i in range(len(sources))]
            procs = [subprocess.Popen(command + ["-c", "-o", obj, src],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for obj, src in zip(inputs, sources)]
            outs = [p.communicate()[0] for p in procs]
            if any(p.returncode for p in procs):
                raise RuntimeError(
                    f"building lib{name}.so failed ({' '.join(command)}):\n"
                    + "".join(outs))
        tmp = os.path.join(d, "lib.so")
        r = subprocess.run(command + ["-o", tmp] + inputs,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building lib{name}.so failed ({' '.join(command)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    return path
