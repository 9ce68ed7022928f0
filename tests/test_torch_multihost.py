"""The port's multi-process run (tests/test_multihost.py for
``herro_tpu_torch``): two ``inference`` CLI processes on the CPU under a
``127.0.0.1`` coordinator (``torch.distributed``, gloo) correct disjoint
strides of target-partitioned alignment batches; their shard outputs must
combine to exactly the single-process result. Also the CLI's data- and
tensor-parallel layouts over CPU replicas, which must write the
single-device FASTA byte for byte.

The reads carry enough errors that the model scores supported columns in
every layout (17 batches at batch 4), so the meshes run their steps.
"""

import os
import socket
import subprocess
import sys

import pytest

from herro_tpu_torch.overlaps.batches import BatchWriter
from herro_tpu_torch.training.simulate import paf_rows, simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 512


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mh")
    ds = simulate(
        genome_len=4000, n_reads=24, read_len=(1200, 2000), sub_rate=0.03,
        ins_rate=0.02, del_rate=0.02, het_rate=0.005, seed=21,
    )
    fastq = tmp / "reads.fastq"
    ds.write_fastq(str(fastq))
    rows = paf_rows(ds, min_overlap=300)

    # two target-partitioned batches, as tests/test_multihost.py routes them
    names = [r.name for r in ds.reads]
    half = set(names[: len(names) // 2])
    groups: dict[int, list[bytes]] = {0: [], 1: []}
    for line in rows:
        groups[0 if line.split(b"\t")[5] in half else 1].append(line)
    alns = tmp / "alns"
    alns.mkdir()
    for k, ids in ((0, [n for n in names if n in half]),
                   (1, [n for n in names if n not in half])):
        with BatchWriter(str(alns), k, ids) as w:
            for line in groups[k]:
                w.write(line)

    from herro_tpu_torch import cli

    single = tmp / "single.fasta"
    cli.main(_args([], str(fastq), str(alns), str(single)))
    return tmp, str(fastq), str(alns), str(single)


def _args(extra, fastq, alns, out):
    return ["inference", "--device", "cpu", "--read-alns", alns, "-m", "tiny", "-w",
            str(WINDOW), "-b", "4", *extra, fastq, out]


def _cli(extra, fastq, alns, out):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "herro_tpu_torch.cli", *_args(extra, fastq, alns, out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def _fasta_seqs(path: str) -> dict[bytes, bytes]:
    seqs: dict[bytes, bytes] = {}
    name = None
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip()
            if line.startswith(b">"):
                name = line[1:].split(b" ")[0]
                seqs[name] = b""
            elif name is not None:
                seqs[name] += line
    return seqs


def test_two_process_striding_matches_single(dataset):
    tmp, fastq, alns, single = dataset
    port = _free_port()
    sharded = str(tmp / "sharded.fasta")
    procs = [
        _cli(["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
              "--process-id", str(i)], fastq, alns, sharded)
        for i in range(2)
    ]
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for pr, o in zip(procs, outs):
        assert pr.returncode == 0, o.decode()

    combined: dict[bytes, bytes] = {}
    for i in range(2):
        shard = _fasta_seqs(f"{sharded}.shard{i:03d}")
        assert shard, f"shard {i} corrected nothing"
        overlap = set(shard) & set(combined)
        assert not overlap, f"shards overlap on {overlap}"
        combined.update(shard)

    assert combined == _fasta_seqs(single)
    assert not os.path.exists(sharded)  # each process wrote its shard alone


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--devices", "4", "--tp", "2"]])
def test_cli_mesh_matches_single(flags, dataset):
    """Data parallelism over two CPU replicas, and two replicas of two
    tensor-parallel shards: the single-device FASTA, byte for byte."""
    from herro_tpu_torch import cli

    tmp, fastq, alns, single = dataset
    out = tmp / f"mesh_{'_'.join(flags).replace('-', '')}.fasta"
    cli.main(_args(flags, fastq, alns, str(out)))
    assert out.read_bytes() == open(single, "rb").read()
