"""Build the native PNG decoder once, before any test process loads it.

``native/liblcvo_native.so`` is git-ignored and built on first use. The JAX package's
binding runs ``make -C native`` in place from whichever process imports it first, and
keeps a failed load for the life of that process; under pytest-xdist several workers
import it at once, and a worker that opens the file while another worker's linker is
still writing it skips every test of the decoder. This hook builds the library in the
pytest process that starts the run, before xdist starts its workers: ``make`` runs in a
private copy of ``native/`` and one ``os.replace`` moves its library into place, all
under an exclusive lock on ``native/.build.lock``. The Makefile stays the one place that
says how the library is built. A reader sees either no library or the whole one. A
failed build leaves no file, and the bindings then behave as they would without this
hook.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
LIB_NAME = "liblcvo_native.so"


def build_native_library(native_dir: str = NATIVE_DIR) -> bool:
    """Build ``native_dir/liblcvo_native.so`` if it is absent; True if it exists after.

    ``make`` runs in a copy of the directory's files (a hidden directory inside it, so
    that the rename stays on one file system), and its library is renamed onto the
    target. Concurrent callers wait on the lock; the first builds, the rest find the
    file and return."""
    lib = os.path.join(native_dir, LIB_NAME)
    if os.path.exists(lib):
        return True
    if not os.path.exists(os.path.join(native_dir, "Makefile")):
        return False
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return True
            work = tempfile.mkdtemp(prefix=".build.", dir=native_dir)
            try:
                for name in os.listdir(native_dir):
                    path = os.path.join(native_dir, name)
                    if os.path.isfile(path) and not name.startswith(".") and name != LIB_NAME:
                        shutil.copy2(path, work)
                subprocess.run(["make", "-C", work, LIB_NAME], capture_output=True, timeout=120,
                               check=True)
                os.replace(os.path.join(work, LIB_NAME), lib)
            except (OSError, subprocess.SubprocessError):
                return False
            finally:
                shutil.rmtree(work, ignore_errors=True)
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def pytest_configure(config):
    build_native_library()
