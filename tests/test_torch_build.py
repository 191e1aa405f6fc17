"""The kernel build on the CPU, with ``nvcc`` replaced by a stub script:
threads that load one library at once build it once and load it once
(a background solver build may be the first to load a library while the
serving thread asks for it too)."""
import stat
import sys
import threading
import types

from repro_torch.kernels import build

STUB = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)            # a compile long enough for the threads to race
with open(out, "wb") as f:
    f.write(b"library")
"""


def test_threads_loading_one_library_build_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, calls=str(calls)))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    loaded = []
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: loaded.append(path) or object()))

    start = threading.Barrier(4)
    libs, errors = [], []

    def worker():
        try:
            start.wait(timeout=30)
            libs.append(build.load("spmv_ell"))
        except Exception as err:  # noqa: BLE001 — reported below
            errors.append(err)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    built = calls.read_text().splitlines()
    assert len(built) == 1, built
    assert len(loaded) == 1 and len(libs) == 4
    assert all(lib is libs[0] for lib in libs)
    lib = build.library_path("spmv_ell")
    assert lib.read_bytes() == b"library" and str(lib) == loaded[0]
    # the compiler wrote to a name of this process and thread, then the
    # library was moved into place; nothing temporary is left
    assert ".tmp" in built[0] and str(lib) != built[0]
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_temporary_names_differ_per_thread(tmp_path, monkeypatch):
    """Two threads building the same library (without the lock, as two
    processes would) write to two temporary names."""
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, calls=str(calls)))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    start = threading.Barrier(2)

    def worker():
        start.wait(timeout=30)
        build._build_all(["trsm_block"])

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    built = calls.read_text().splitlines()
    assert len(built) == 2 and built[0] != built[1]
    assert build.library_path("trsm_block").read_bytes() == b"library"
