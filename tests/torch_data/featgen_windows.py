"""The windows of the frozen featurization goldens, built by the port.

``tests/golden/featgen_v3.npz`` and ``featgen_sys_v1.npz`` freeze the bytes of
the full featurization path (windowing -> long-indel filter -> accuracy sort
-> pileup fill -> supported counting -> haplotype re-rank) on two fixed-seed
simulations; ``tests/make_golden.py`` wrote them through herro_tpu. This
module builds the same windows through ``herro_tpu_torch`` alone (its
``training.simulate``, ``io.fastx``, ``overlaps.paf`` and
``features.extract``), with the same simulations, window and read choice,
under the same array names, so that ``tests/test_torch_featgen_golden.py``
holds the port's featgen byte for byte against both files. It imports
nothing of herro_tpu or JAX.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")
W = 1024
SEED = 424242
# the simulation of featgen_v3.npz and the reads it keeps
STANDARD = dict(genome_len=16_000, n_reads=24, read_len=(2500, 5000), sub_rate=0.03,
                ins_rate=0.02, del_rate=0.02, het_rate=0.005, seed=SEED)
# featgen_sys_v1.npz: locus-correlated strand-biased miscall hotspots, adapter
# chimeras and coverage dropouts on top
SYSTEMATIC = dict(STANDARD, n_reads=32, sys_rate=0.004, sys_strength=(0.4, 0.9),
                  sys_strand_frac=0.5, chimera_rate=0.15, n_dropouts=2,
                  dropout_len=(1_500, 3_000), dropout_keep=0.3, seed=SEED + 1)


def _build(sim: dict, n_targets: int) -> dict[str, np.ndarray]:
    """Every window of the first ``n_targets`` targets (by read id) of the
    simulation ``sim``: bases, quals, supported positions and insertions, and
    (n_alns, n_total_wins, query ids), keyed ``{rid}_{wid}_{plane}``."""
    from herro_tpu_torch.features.extract import extract_read_features
    from herro_tpu_torch.io.fastx import load_reads
    from herro_tpu_torch.overlaps.paf import parse_paf
    from herro_tpu_torch.training.simulate import paf_rows, simulate

    ds = simulate(**sim)
    with tempfile.TemporaryDirectory() as tmp:
        fastq = os.path.join(tmp, "r.fastq")
        ds.write_fastq(fastq)
        reads = load_reads(fastq, min_length=W)
        grouped = parse_paf(paf_rows(ds, min_overlap=W), reads.name_to_id)
        out = {}
        for rid in sorted(grouped)[:n_targets]:
            for wf in extract_read_features(rid, reads, grouped[rid], W):
                key = f"{rid}_{wf.wid}"
                out[f"{key}_bases"] = wf.bases
                out[f"{key}_quals"] = wf.quals
                out[f"{key}_sup_pos"] = wf.supported["pos"]
                out[f"{key}_sup_ins"] = wf.supported["ins"]
                out[f"{key}_meta"] = np.array(
                    [wf.n_alns, wf.n_total_wins] + wf.qids, dtype=np.int64
                )
    return out


def build_windows() -> dict[str, np.ndarray]:
    """The windows of ``featgen_v3.npz``: 6 targets of the standard profile."""
    return _build(STANDARD, 6)


def build_windows_sys() -> dict[str, np.ndarray]:
    """The windows of ``featgen_sys_v1.npz``: 8 targets of the systematic
    profile."""
    return _build(SYSTEMATIC, 8)
