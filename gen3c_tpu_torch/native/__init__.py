"""Host-side C++ of the serving path and the native viewer.

Each library is built from its source beside this file with ``g++`` at
first use, into ``_build/`` here, and built again when a source is newer
than the output: the ctypes libraries (``load_library``), the CPython
extension over the same three cores (``ext``) and the viewer's binary
(``viewer``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")


def build(sources: Sequence[str], output: str, flags: Sequence[str] = (),
          deps: Sequence[str] = ()) -> str:
    """``_build/<output>`` compiled by g++ from ``sources`` (files of this
    directory) with ``flags``, unless it is newer than every source and
    every file of ``deps`` (sources it includes). The build writes a
    temporary file and renames it, so that processes building at once
    never load a partial output. Returns the output's path."""
    srcs = [os.path.join(_DIR, s) for s in sources]
    out = os.path.join(BUILD_DIR, output)
    newest = max(os.path.getmtime(p) for p in srcs + [os.path.join(_DIR, d) for d in deps])
    if not (os.path.exists(out) and os.path.getmtime(out) >= newest):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(output)[1], dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", *flags, *srcs, "-o", tmp], check=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load_library(source: str, std: str = None) -> ctypes.CDLL:
    """``lib<stem>.so`` built from ``source`` (a file of this directory),
    loaded."""
    so = build([source], "lib" + os.path.splitext(source)[0] + ".so",
               ([f"-std={std}"] if std else []) + ["-shared", "-fPIC"])
    return ctypes.CDLL(so)
