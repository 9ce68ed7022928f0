"""The port's ``features`` subcommand held against herro_tpu's.

Both CLIs dump the same simulated reads and PAF (one ``.oec.zst`` batch);
the per-read npy trees must be byte-identical, file for file, and round-trip
through ``load_window_features`` to what direct extraction gives.
"""

import os

import numpy as np
import pytest

from herro_tpu.cli import main as jax_cli_main
from herro_tpu.training.simulate import paf_rows, simulate
from herro_tpu_torch.cli import main as port_cli_main
from herro_tpu_torch.features.extract import extract_read_features
from herro_tpu_torch.features.npy import load_window_features, write_window_features
from herro_tpu_torch.io.fastx import load_reads
from herro_tpu_torch.overlaps.batches import BatchWriter
from herro_tpu_torch.overlaps.paf import parse_paf

WINDOW = 512


def _tree(root):
    return {
        os.path.relpath(os.path.join(r, f), root): open(os.path.join(r, f), "rb").read()
        for r, _, fs in os.walk(root) for f in fs
    }


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tfcli")
    ds = simulate(genome_len=4000, n_reads=20, read_len=(1200, 1900), sub_rate=0.02,
                  ins_rate=0.01, del_rate=0.01, seed=31)
    fastq = tmp / "reads.fastq"
    ds.write_fastq(str(fastq))
    rows = paf_rows(ds, min_overlap=300)
    alns = tmp / "alns"
    with BatchWriter(str(alns), 0, [r.name for r in ds.reads]) as w:
        for line in rows:
            w.write(line)
    outs = {}
    for name, main in (("jax", jax_cli_main), ("port", port_cli_main)):
        outs[name] = str(tmp / name)
        main(["features", "--read-alns", str(alns), "-w", str(WINDOW), str(fastq),
              outs[name]])
    return str(fastq), rows, outs


def test_features_tree_identical_to_jax(dumped):
    _, _, outs = dumped
    want, got = _tree(outs["jax"]), _tree(outs["port"])
    assert want and sorted(got) == sorted(want)
    for rel, data in want.items():
        assert got[rel] == data, rel


def test_layout(dumped):
    _, _, outs = dumped
    read_dirs = sorted(os.listdir(outs["port"]))
    assert read_dirs, "no per-read directories written"
    d0 = os.path.join(outs["port"], read_dirs[0])
    files = sorted(os.listdir(d0))
    wids = sorted({f.split(".")[0] for f in files})
    for wid in wids:
        for suffix in ("features.npy", "supported.npy", "ids.txt"):
            assert f"{wid}.{suffix}" in files
    feats = np.load(os.path.join(d0, f"{wids[0]}.features.npy"))
    assert feats.dtype == np.uint8
    assert feats.ndim == 3 and feats.shape[0] == 2 and feats.shape[2] == 31
    sup = np.load(os.path.join(d0, f"{wids[0]}.supported.npy"))
    assert sup.dtype.names == ("pos", "ins")


def test_roundtrip_matches_direct_extraction(dumped):
    fastq, rows, outs = dumped
    reads = load_reads(fastq, min_length=WINDOW)
    grouped = parse_paf(list(rows), reads.name_to_id)
    checked = 0
    for rid, alns in list(grouped.items())[:4]:
        name = reads.ids[rid].decode()
        for wf in extract_read_features(rid, reads, alns, WINDOW):
            bases, quals, sup = load_window_features(os.path.join(outs["port"], name), wf.wid)
            np.testing.assert_array_equal(bases, wf.bases)
            np.testing.assert_array_equal(quals, wf.quals)
            np.testing.assert_array_equal(sup, wf.supported)
            checked += 1
    assert checked > 4


def test_write_window_features_equal_to_jax(dumped, tmp_path):
    """The npy writer alone, on the same windows."""
    from herro_tpu.features.npy import write_window_features as jax_write

    fastq, rows, _ = dumped
    reads = load_reads(fastq, min_length=WINDOW)
    grouped = parse_paf(list(rows), reads.name_to_id)
    rid, alns = next(iter(grouped.items()))
    feats = extract_read_features(rid, reads, alns, WINDOW)
    write_window_features(str(tmp_path / "port"), reads, feats)
    jax_write(str(tmp_path / "jax"), reads, feats)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") != {}
