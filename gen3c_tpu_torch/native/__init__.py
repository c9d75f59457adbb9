"""Host-side C++ libraries of the serving path, bound with ctypes.

Each library is built from its source beside this file with ``g++`` at
first use, into ``_build/`` here, and built again when its source is newer
than the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")


def load_library(source: str, std: str = None) -> ctypes.CDLL:
    """``lib<stem>.so`` built from ``source`` (a file of this directory),
    loaded. The build writes a temporary file and renames it, so that
    processes building at once never load a partial library."""
    src = os.path.join(_DIR, source)
    so = os.path.join(BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")
    if not (os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2"] + ([f"-std={std}"] if std else [])
                           + ["-shared", "-fPIC", src, "-o", tmp], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(so)
