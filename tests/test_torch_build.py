"""The kernel build (``repro_torch/kernels/_build.py``) under threads.

The streaming service makes CUDA calls from its executor thread and from
the main thread, so the first kernel call may come from either.  Held here,
on the CPU: threads asking for the sources and the build directory get
the same answer, and threads that build at once run the compiler once per
source, through a stand-in ``nvcc`` that records each call (the real
build runs only where the CUDA toolkit is).
"""
import os
import stat
import sys
import threading

from repro_torch.kernels import _build


def _in_threads(fn, n=16):
    """``fn()`` in ``n`` threads released together (more threads than
    cores, a short switch interval); returns their results."""
    out, errs = [None] * n, []
    start = threading.Barrier(n)

    def run(i):
        try:
            start.wait()
            out[i] = fn()
        except Exception as e:       # surfaced below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def test_sources_and_build_dir_agree_across_threads():
    a, *rest = _in_threads(_build.sources)
    assert all(r == a for r in rest)
    assert set(a) >= {"radix_partition", "segscan", "megakernel",
                      "hash_probe"}
    a, *rest = _in_threads(_build.build_dir)
    assert all(r == a for r in rest) and a.parent == _build.BUILD_ROOT


def test_concurrent_builds_compile_each_source_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(calls)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.2)\n"
        "open(out, 'wb').write(b'lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    a, *rest = _in_threads(_build.build_all)
    assert all(r == a for r in rest) and set(a) == set(_build.sources())
    for lib in a.values():
        assert lib.read_bytes() == b"lib"
    lines = calls.read_text().split()
    assert len(lines) == len(a)          # one compile per source
    assert all(f".{os.getpid()}." in p and p.endswith(".tmp.so")
               for p in lines)           # temp names carry pid and thread
    assert not [p for p in os.listdir(tmp_path / "build" / a[
        "segscan"].parent.name) if p.endswith(".tmp.so")]
