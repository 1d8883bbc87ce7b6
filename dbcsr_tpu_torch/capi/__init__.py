"""The C API shim over dbcsr_tpu_torch.

``build_capi()`` compiles ``capi.c`` (the CPython-embedding C bindings of
``dbcsr_tpu.h``; it ``#include``s ``capi2.c`` and ``capi3.c``) into a shared
library in the port's git-ignored build directory, lazily and named by a
hash of the sources and of the Python it embeds. A C or Fortran program
includes ``dbcsr_tpu.h`` from :func:`header_path` and links the library: its
calls run in ``dbcsr_tpu_torch`` (``helpers.py``, ``himpl.py``) on the device
that ``DBCSR_CAPI_DEVICE`` names. Everything compiled is in this directory.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
from typing import List, Optional

__all__ = ["build_capi", "header_path", "capi_build_command"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "capi.c")
_HDR = os.path.join(_HERE, "dbcsr_tpu.h")
#: every file the library is compiled from (capi.c includes the others)
_PARTS = ("capi.c", "capi2.c", "capi3.c", "dbcsr_tpu.h")


def header_path() -> str:
    return _HDR


def _python_link() -> Optional[tuple]:
    """(include dir, lib dir, ABI version) of the running Python, or None
    without a shared libpython to link."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    if not (libdir and ver):
        return None
    return sysconfig.get_paths()["include"], libdir, ver


def capi_build_command(cc: str, out: str) -> Optional[List[str]]:
    """The compiler command that builds the shim into ``out`` (None without
    a shared libpython)."""
    link = _python_link()
    if link is None:
        return None
    inc, libdir, ver = link
    return [
        cc, "-O2", "-shared", "-fPIC", f"-I{inc}", f"-I{_HERE}", _SRC,
        "-o", out, f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}",
    ]


def build_capi(cc: str = "gcc") -> Optional[str]:
    """Compile the shim; returns the .so path (built once per source hash)
    or None if there is no compiler or no shared libpython."""
    from .._build import build_dir

    link = _python_link()
    if link is None:
        return None
    h = hashlib.sha256()
    for part in _PARTS:
        with open(os.path.join(_HERE, part), "rb") as f:
            h.update(f.read())
    h.update(f"|{link[2]}|{link[1]}".encode())
    so = os.path.join(build_dir(), f"_capi_{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    # several test workers may build at once: each into its own name, then
    # an atomic rename
    tmp = so + f".tmp{os.getpid()}"
    try:
        subprocess.run(capi_build_command(cc, tmp), check=True, capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return so
