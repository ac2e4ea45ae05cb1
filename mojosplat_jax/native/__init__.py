"""Native (C) IO runtime: built on demand, with graceful fallback.

``get_native()`` returns the compiled ``_io_native`` extension module,
building it with the system C compiler on first use (a few hundred ms). If
no toolchain is available it returns None and callers fall back to the
pure-Python implementations (utils/ply.py, utils/image.py).
"""

from __future__ import annotations

import importlib
import logging
import os
import subprocess
import sys
import sysconfig
import threading

logger = logging.getLogger("mojosplat_jax")

_lock = threading.Lock()
_native = None
_tried = False


def _build() -> bool:
    here = os.path.dirname(__file__)
    src = os.path.join(here, "io_native.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(here, "_io_native" + suffix)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return True
    cc = os.environ.get("CC", "cc")
    cmd = [
        cc, "-O2", "-shared", "-fPIC",
        "-I", sysconfig.get_paths()["include"],
        src, "-o", out,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.info("native IO build unavailable (%s); using Python IO", e)
        return False
    if proc.returncode != 0:
        logger.warning("native IO build failed:\n%s", proc.stderr[-2000:])
        return False
    return True


def get_native():
    """The compiled _io_native module, or None if unavailable."""
    global _native, _tried
    with _lock:
        if _tried:
            return _native
        _tried = True
        try:
            _native = importlib.import_module(
                "mojosplat_jax.native._io_native"
            )
            return _native
        except ImportError:
            pass
        if _build():
            try:
                _native = importlib.import_module(
                    "mojosplat_jax.native._io_native"
                )
            except ImportError as e:  # pragma: no cover
                logger.warning("built native IO but import failed: %s", e)
                _native = None
        return _native
