"""The port's copies of the host scripts that imported herro_tpu.

``scripts/batch_alignments_torch.py`` (and ``create_batched_alignments_torch.sh``,
which pipes minimap2 into it), ``tools/make_paf_fixture_torch.py`` and
``tools/bench_featgen_torch.py`` import ``herro_tpu_torch`` alone. Each runs
here in a subprocess in which importing ``herro_tpu``, ``jax`` or ``flax``
raises (a finder first on ``sys.meta_path``, installed by a
``sitecustomize``), and gives the reference script's output on the same
input: the alignment batches' ids, rows and file bytes; the PAF fixture's
decompressed bytes and ``truth.txt`` against the reference tool's (each
written into a temporary directory, never into ``tests/data/``); the
featgen benchmark's window counts at a reduced size (times are not compared).
"""

import gzip
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "herro_tpu")
BLOCKER = f"""import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"{{name}} is blocked: the port's scripts stand alone")
        return None


sys.meta_path.insert(0, _Blocked())
"""
NEW_SCRIPTS = ("scripts/batch_alignments_torch.py", "tools/make_paf_fixture_torch.py",
               "tools/bench_featgen_torch.py")


@pytest.fixture
def ref_env(tmp_path):
    """This environment with ``python`` on PATH running this interpreter."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bin_dir / "python").chmod(0o755)
    return dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")


@pytest.fixture
def port_env(tmp_path, ref_env):
    """``ref_env`` in which Python cannot import herro_tpu, JAX or flax."""
    block = tmp_path / "blocked"
    block.mkdir()
    (block / "sitecustomize.py").write_text(BLOCKER)
    return dict(ref_env, PYTHONPATH=str(block))


def _run(args, env=None, stdin=None):
    return subprocess.run(args, input=stdin, capture_output=True, env=env, cwd=REPO,
                          check=True, timeout=300)


def test_the_blocker_blocks(port_env):
    res = subprocess.run([sys.executable, "-c", "import herro_tpu"], env=port_env, cwd=REPO,
                         capture_output=True, text=True)
    assert res.returncode != 0 and "is blocked" in res.stderr
    _run([sys.executable, "-c", "import herro_tpu_torch.overlaps.batches"], env=port_env)


@pytest.mark.parametrize("script", NEW_SCRIPTS)
def test_script_imports_without_herro_tpu_or_jax(script, port_env):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('script', {script!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "assert not bad, bad\n"
        "assert 'herro_tpu_torch' in sys.modules\n"
    )
    _run([sys.executable, "-c", code], env=port_env)


def _paf_and_rids(tmp_path):
    """A simulation's PAF rows and read ids, and a hand-made row whose target
    is no read (dropped)."""
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(genome_len=6000, n_reads=14, read_len=(900, 1600), seed=3)
    rows = [r if r.endswith(b"\n") else r + b"\n" for r in paf_rows(ds, min_overlap=300)]
    rows.append(b"a\t100\t0\t50\t+\tzz\t100\t0\t50\t50\t50\t60\tcg:Z:50M\n")
    rids = tmp_path / "rids.txt"
    rids.write_bytes(b"".join(n + b"\n" for n in sorted({r.split(b"\t")[5] for r in rows[:-1]})))
    fastq = tmp_path / "reads.fastq"
    ds.write_fastq(str(fastq))
    return b"".join(rows), rids, fastq


def _batches(out):
    """Each batch file: (name, ids, rows, bytes), read with the port's reader."""
    from herro_tpu_torch.overlaps.batches import list_batches, read_batch

    got = []
    for path in list_batches(str(out)):
        ids, lines = read_batch(path)
        got.append((os.path.basename(path), ids, list(lines), open(path, "rb").read()))
    return got


def test_batch_alignments_torch_equals_reference(tmp_path, port_env):
    paf, rids, _ = _paf_and_rids(tmp_path)
    outs, logs = {}, {}
    for name, env in (("batch_alignments.py", None), ("batch_alignments_torch.py", port_env)):
        outs[name] = tmp_path / name
        logs[name] = _run([sys.executable, os.path.join(REPO, "scripts", name), str(rids), "-",
                           str(outs[name]), "--batch-size", "4"], env=env, stdin=paf).stderr
    want, got = (_batches(outs[n]) for n in ("batch_alignments.py", "batch_alignments_torch.py"))
    assert len(want) >= 3 and sum(len(b[2]) for b in want) > 0
    assert got == want
    assert logs["batch_alignments_torch.py"] == logs["batch_alignments.py"]


def test_create_batched_alignments_torch_sh_equals_reference(tmp_path, ref_env, port_env):
    """The shell pipeline with a stand-in minimap2 (``MINIMAP2``) that
    writes a fixed PAF whatever its flags."""
    paf, rids, fastq = _paf_and_rids(tmp_path)
    (tmp_path / "rows.paf").write_bytes(paf)
    mm2 = tmp_path / "minimap2"
    mm2.write_text(f"#!/bin/sh\ncat {tmp_path / 'rows.paf'}\n")
    mm2.chmod(0o755)
    outs = {}
    for name, env in (("create_batched_alignments.sh", ref_env),
                      ("create_batched_alignments_torch.sh", port_env)):
        outs[name] = tmp_path / name
        _run(["bash", os.path.join(REPO, "scripts", name), str(fastq), str(rids), "2",
              str(outs[name])], env=dict(env, MINIMAP2=str(mm2)))
    want = _batches(outs["create_batched_alignments.sh"])
    assert want and _batches(outs["create_batched_alignments_torch.sh"]) == want


def test_make_paf_fixture_torch_equals_reference_tool(tmp_path, port_env):
    """The port's fixture against the reference tool's, each written into a
    directory of its own under ``tmp_path`` (the reference's ``OUT_DIR``
    pointed there). Both differ from the committed ``tests/data/real_like.*``
    (292 clean rows against 258): the simulator changed after the fixture
    was frozen, and the committed files stay as ``tests/test_real_paf.py``
    pins them."""
    import zstandard as zstd

    ref = _module("tools/make_paf_fixture.py", "make_paf_fixture")
    ref.OUT_DIR = str(tmp_path / "reference")
    ref.main()
    out = tmp_path / "port"
    _run([sys.executable, os.path.join(REPO, "tools", "make_paf_fixture_torch.py"),
          "--out-dir", str(out)], env=port_env)
    names = ["real_like.fastq.gz", "real_like.paf.zst", "real_like.truth.txt"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref.OUT_DIR)) == names

    def paf(path):
        with open(path, "rb") as fh:
            return zstd.ZstdDecompressor().stream_reader(fh).read()

    want = [os.path.join(ref.OUT_DIR, n) for n in names]
    assert len(paf(want[1])) > 0 and paf(out / names[1]) == paf(want[1])
    assert gzip.open(out / names[0]).read() == gzip.open(want[0]).read()
    truth = (out / names[2]).read_text()
    assert truth.startswith("clean_rows=") and truth == open(want[2]).read()


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_featgen_torch_counts_the_reference_windows(capsys):
    counts = {}
    for path in ("tools/bench_featgen.py", "tools/bench_featgen_torch.py"):
        mod = _module(path, os.path.basename(path)[:-3])
        ws = mod.bench("small", n_reads=10, genome_len=40_000, reps=1)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert ws > 0 and line.startswith("small: ")
        counts[path] = int(line.split()[1])
    assert counts["tools/bench_featgen.py"] > 0
    assert counts["tools/bench_featgen_torch.py"] == counts["tools/bench_featgen.py"]
