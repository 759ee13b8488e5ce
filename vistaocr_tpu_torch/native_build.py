"""Build a C++ source of the package into a shared library, safely.

The library is named by a hash of the source and the flags, so an edit
or another flag set never loads a stale build. It is compiled with g++
into a temporary file named for the building process and thread, then
``os.replace``d onto its final name, so that concurrent builders (test
workers, handler threads) never read or replace each other's half-written
files. Each failure is reported with its own cause: g++ missing, the
compiler's error, a timeout, or the rename.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(src: str, build_dir: str, stem: str,
                 flags: Sequence[str] = FLAGS) -> str:
    """Where the library built from ``src`` with ``flags`` lives."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}.so")


def build(src: str, so: str, flags: Sequence[str] = FLAGS) -> Optional[str]:
    """Compile ``src`` to ``so``; None, or why it failed."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([gxx, *flags, src, "-o", tmp], check=True,
                       capture_output=True, timeout=240)
        os.replace(tmp, so)
        return None
    except subprocess.CalledProcessError as e:
        return "g++ failed: " + e.stderr.decode(errors="replace")[-2000:]
    except subprocess.TimeoutExpired:
        return "g++ timed out"
    except OSError as e:
        return f"installing the built library failed: {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
