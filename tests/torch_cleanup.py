"""A fixture for the port's test modules: when a module ends, delete the
temporary directories it made and give its freed heap back to the OS.

Under xdist each worker keeps, to the end of the session, every
temporary directory its modules made (a detector checkpoint with its Adam
state is ~490 MB at any image size) and the heap peak of every module it
ran (glibc keeps freed pages: a module of the port retains up to ~8 GB,
~1 GB after a trim). Six workers then come near the disk and the memory
of one machine. Each test_torch_*.py imports `clean_up_module`; being
autouse and module-scoped, it runs after the module's last test and its
other fixtures. A module with a failed test keeps its directories.
"""

import ctypes
import gc
import shutil

import pytest


@pytest.fixture(autouse=True, scope="module")
def clean_up_module(request, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        for path in set(base.iterdir()) - before:
            if path.is_symlink():
                path.unlink()
            else:
                shutil.rmtree(path, ignore_errors=True)
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass
