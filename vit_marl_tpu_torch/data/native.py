"""The native (C++) LOBSTER CSV parser, built at first use.

``native/lobster_parser.cpp`` (a CPython extension with the raw C API)
fuses CSV parsing with the LOBSTER preprocessing rules of
``data/lobster.py::_preprocess_day``.  It is compiled as it is with
``g++`` into the package's ``_build/`` directory (listed in
``.gitignore``) and loaded with ``importlib``.  Where the build or the
import fails, :func:`get_native_module` says so on stderr and returns
None, and the loader takes the numpy path (``np.loadtxt`` +
``_preprocess_day``), whose output is the same.  This is host-side CSV
parsing, not a device kernel.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "lobster_parser.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_module = None
_tried = False


def _build_and_import():
    """Compile the extension if it is missing or older than its source,
    and import it; None on a failed build."""
    so_path = os.path.join(
        BUILD_DIR, f"_lobster_native{sysconfig.get_config_var('EXT_SUFFIX')}")
    if not os.path.exists(so_path) or (
            os.path.getmtime(SOURCE) > os.path.getmtime(so_path)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               f"-I{sysconfig.get_path('include')}", SOURCE, "-o", tmp]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            print("native lobster parser build failed (falling back to "
                  f"numpy loader): {r.stderr.strip().splitlines()[-1:]}",
                  file=sys.stderr)
            return None
        os.replace(tmp, so_path)
    spec = importlib.util.spec_from_file_location("_lobster_native", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_native_module():
    """The compiled extension module, or None if it is unavailable."""
    global _module, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _module = _build_and_import()
            except Exception as e:  # no toolchain, no source, ...
                print(f"native lobster parser unavailable ({e}); using "
                      "numpy loader", file=sys.stderr)
                _module = None
    return _module


def parse_day_native(msg_path: str, book_path: str, day_start: int,
                     day_end: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(msgs ``(N, 8)`` int32, book ``(N, 4*levels)`` int64), or None if
    the native parser is unavailable.  Raises ``OSError`` on unreadable
    files."""
    mod = get_native_module()
    if mod is None:
        return None
    msgs_b, n, book_b, book_cols = mod.parse_day(
        msg_path, book_path, int(day_start), int(day_end))
    msgs = np.frombuffer(msgs_b, dtype=np.int32).reshape(n, 8).copy()
    book = np.frombuffer(book_b, dtype=np.int64).reshape(n, book_cols).copy()
    return msgs, book
