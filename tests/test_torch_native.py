"""The port's host library loader and its numpy fallbacks.

* several processes that import the native package at once, from a tree with
  no built library, all end up with the library loaded (the build goes to a
  temporary name under a lock and is renamed into place, so no importer can
  load a half-written file);
* the port's counterpart of tests/test_paf.py's malformed-row test, with the
  native library on and forced off (``HERRO_TPU_NATIVE=0``): an overflowing
  CIGAR run length is a bad CIGAR in both, never an exception.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "herro_tpu_torch", "native")


def _copy_native_sources(dst):
    os.makedirs(dst)
    for name in ("__init__.py", "Makefile", "haec_native.cpp"):
        shutil.copy(os.path.join(NATIVE, name), dst)


def test_concurrent_first_imports_all_load_the_library(tmp_path, n_procs=6):
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("needs g++ and make to build the library")
    pkg = tmp_path / "natcopy"
    _copy_native_sources(str(pkg))
    code = "import natcopy, sys; sys.exit(0 if natcopy.available() else 3)"
    env = {k: v for k, v in os.environ.items() if k != "HERRO_TPU_NATIVE"}
    env["PYTHONPATH"] = str(tmp_path)
    procs = [
        subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         stderr=subprocess.PIPE)
        for _ in range(n_procs)
    ]
    results = [(p.wait(timeout=300), p.stderr.read().decode()) for p in procs]
    assert [rc for rc, _ in results] == [0] * n_procs, results
    left = sorted(os.listdir(pkg))
    assert "libherro_native.so" in left
    assert not [f for f in left if ".tmp" in f], left


def test_stale_library_is_rebuilt_and_replaced(tmp_path):
    """A library older than its source is rebuilt; a failed build leaves no
    temporary file and falls back."""
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("needs g++ and make to build the library")
    pkg = tmp_path / "natcopy2"
    _copy_native_sources(str(pkg))
    env = {k: v for k, v in os.environ.items() if k != "HERRO_TPU_NATIVE"}
    env["PYTHONPATH"] = str(tmp_path)
    code = "import natcopy2, sys; sys.exit(0 if natcopy2.available() else 3)"
    run = lambda: subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                                 capture_output=True, timeout=300)
    # a broken source: the build fails, nothing is loaded, nothing is left
    src = pkg / "haec_native.cpp"
    good = src.read_bytes()
    src.write_bytes(b"this is not C++\n")
    assert run().returncode == 3
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    src.write_bytes(good)
    assert run().returncode == 0
    lib = pkg / "libherro_native.so"
    first = lib.stat().st_mtime_ns
    os.utime(src, ns=(first + 10**9, first + 10**9))  # source newer than library
    assert run().returncode == 0
    assert lib.stat().st_mtime_ns > first


MALFORMED = textwrap.dedent(
    """
    import sys
    from herro_tpu_torch import native
    from herro_tpu_torch.overlaps.paf import ParseStats, parse_paf

    assert native.available() == (sys.argv[1] == "1"), native.available()

    def _row(q, t, cigar=b"10M", strand=b"+"):
        return b"\\t".join([q, b"100", b"0", b"50", strand, t, b"120", b"10", b"60",
                           b"40", b"50", b"60", b"cg:Z:" + cigar])

    names = {b"a": 0, b"b": 1, b"c": 2, b"d": 3, b"e": 4}
    good = _row(b"a", b"b")
    bad = [
        _row(b"a", b"c")[:30],                      # truncated mid-field
        b"a\\tnotanint\\t0\\t50\\t+\\td\\t120\\t10\\t60\\t40\\t50\\t60\\tcg:Z:10M",
        _row(b"a", b"e").replace(b"cg:Z:10M", b"xx:Z:10M"),  # tag missing
        _row(b"b", b"a", cigar=b"10M5S10M"),        # unsupported S op
        _row(b"b", b"c", cigar=b"MM10"),            # garbled CIGAR
        _row(b"b", b"d", cigar=b"99999999999999M"), # overflowing run length
        b"\\x00\\xff\\xfe garbage line",
        b"",
    ]
    stats = ParseStats()
    out = parse_paf([good] + bad + [_row(b"c", b"b", cigar=b"20M")], names, stats=stats)
    assert sorted(a.qid for a in out[1]) == [0, 2]
    assert stats.n_kept == 2
    assert stats.n_bad_cigar == 3, stats
    assert stats.n_no_cigar == 2
    assert stats.n_malformed == 2
    assert "skipped" in stats.summary()
    """
)


@pytest.mark.parametrize("native_on", ["1", "0"], ids=["native", "numpy"])
def test_malformed_rows_skipped_and_counted(native_on):
    env = dict(os.environ, PYTHONPATH=ROOT, HERRO_TPU_NATIVE=native_on)
    res = subprocess.run([sys.executable, "-c", MALFORMED, native_on], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("cigar", [b"2147483648M", b"99999999999999M", b"5M4294967296D"])
def test_numpy_cigar_fallback_rejects_int32_overflow(cigar, monkeypatch):
    from herro_tpu_torch import native
    from herro_tpu_torch.cigar import ops

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="Invalid CIGAR"):
        ops.parse_cigar(cigar)
    ok = ops.parse_cigar(b"2147483647M")
    assert ok.lens.tolist() == [2**31 - 1]
