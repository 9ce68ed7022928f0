"""Correction-quality evaluation on held-out simulated data.

Runs the full production pipeline (features -> model -> fused consensus ->
stitching) on a fresh simulated dataset and scores corrected reads against
the known truth. The reference publishes quality only as downstream assembly
stats (BASELINE.md); this is the framework-local equivalent gate, with
breakdowns the reference cannot produce:

* full-read and per-base (infix) identity / Q, over *all* corrected
  fragments (truth-mapped via banded fitting alignment with traceback);
* per-base error composition (sub / ins / del);
* het-site allele preservation — the read's own haplotype allele must
  survive correction (pooled majority voting is systematically wrong there;
  the haplotype re-rank + model exist for this case, src/features.rs:461-528);
* homopolymer vs non-homopolymer error rates (ONT indel errors concentrate
  in homopolymer runs; the simulator boosts them accordingly);
* decode modes on matched seeds: ``model`` (production), ``counting``
  (model disabled — the floor), ``oracle`` (truth injected at supported
  columns — the ceiling of what any model could add).
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..io.fastx import load_reads
from ..overlaps.paf import parse_paf
from ..pipeline.batching import BucketSpec
from ..pipeline.engine import run_correction
from ..pipeline.infer import CorrectionRunner
from ..utils.align import align_to_truth
from ..utils.edist import qscore
from .simulate import SimDataset, SimRead, _COMP, paf_rows, simulate, true_sequence


@dataclass
class ScoreAccumulator:
    """Truth-aligned counts over every fragment of every read."""

    n_reads: int = 0
    n_fragments: int = 0
    n_unaligned_fragments: int = 0
    matches: int = 0
    subs: int = 0
    ins: int = 0
    dels: int = 0
    het_covered: int = 0
    het_preserved: int = 0
    het_switched: int = 0
    het_lost: int = 0
    hp_bases: int = 0
    hp_errors: int = 0
    non_hp_bases: int = 0
    non_hp_errors: int = 0
    read_idents: list = field(default_factory=list)
    raw_idents: list = field(default_factory=list)

    @property
    def aligned(self) -> int:
        return self.matches + self.subs + self.ins + self.dels

    def as_dict(self) -> dict:
        al = max(self.aligned, 1)
        infix_ident = self.matches / al
        out = {
            "n_reads": self.n_reads,
            "n_fragments": self.n_fragments,
            "raw_identity": float(np.mean(self.raw_idents)) if self.raw_idents else 0.0,
            "corrected_identity": float(np.mean(self.read_idents)) if self.read_idents else 0.0,
            "corrected_infix_identity": infix_ident,
            "corrected_infix_q": qscore(infix_ident),
            "errors": {
                "sub_rate": self.subs / al,
                "ins_rate": self.ins / al,
                "del_rate": self.dels / al,
            },
        }
        out["raw_q"] = qscore(out["raw_identity"])
        out["corrected_q"] = qscore(out["corrected_identity"])
        if self.het_covered:
            out["het"] = {
                "sites": self.het_covered,
                "preserved": self.het_preserved,
                "switched": self.het_switched,
                "lost": self.het_lost,
                "accuracy": self.het_preserved / self.het_covered,
            }
        if self.hp_bases:
            hp_rate = self.hp_errors / self.hp_bases
            nhp_rate = self.non_hp_errors / max(self.non_hp_bases, 1)
            out["homopolymer"] = {
                "hp_bases": self.hp_bases,
                "hp_err_rate": hp_rate,
                "hp_q": qscore(1.0 - hp_rate),
                "non_hp_err_rate": nhp_rate,
                "non_hp_q": qscore(1.0 - nhp_rate),
            }
        if self.n_unaligned_fragments:
            out["n_unaligned_fragments"] = self.n_unaligned_fragments
        return out


# Named simulator stress profiles (eval --profile NAME). `systematic` is
# the real-data-robustness proxy: locus-correlated confident miscalls
# (half strand-biased), adapter-chimera junction reads, and coverage
# dropouts — the regimes where plain pileup counting fails and where the
# reference's real-minimap2-pileup-trained model earns its assembly QV.
SIM_PROFILES: dict[str, dict] = {
    "systematic": dict(
        sys_rate=0.002,
        sys_strength=(0.3, 0.8),
        sys_strand_frac=0.5,
        chimera_rate=0.05,
        n_dropouts=2,
        dropout_keep=0.25,
    ),
}


# threads aligning reads to their truth in score_fragments
_ALIGN_THREADS = min(8, os.cpu_count() or 1)


def _truth_context(ds: SimDataset, r: SimRead):
    """(truth, other, het_mask, hp_mask) in the read's stored orientation.

    ``other`` is the opposite haplotype's sequence over the same span (None
    when haploid); ``hp_mask`` flags truth positions inside homopolymer runs
    of length >= 3. Chimeric reads concatenate their parts' contexts.
    """
    parts = r.parts if r.parts is not None else [r]
    truths, others = [], []
    for p in parts:
        own = ds.hap_seq(p.hap)[p.start : p.end]
        truths.append(_COMP[own][::-1].copy() if p.rc else own)
        if ds.haplotypes is not None:
            o = ds.hap_seq(1 - p.hap)[p.start : p.end]
            others.append(_COMP[o][::-1].copy() if p.rc else o)
    truth = truths[0] if len(truths) == 1 else np.concatenate(truths)
    other = None
    het = None
    if ds.haplotypes is not None:
        other = others[0] if len(others) == 1 else np.concatenate(others)
        het = truth != other

    n = truth.shape[0]
    hp = np.zeros(n, dtype=bool)
    if n >= 3:
        same_prev = np.concatenate([[False], truth[1:] == truth[:-1]])
        run_id = np.cumsum(~same_prev) - 1
        run_len = np.bincount(run_id)
        hp = run_len[run_id] >= 3
    return truth, other, het, hp


def score_fragments(
    ds: SimDataset,
    reads,
    fasta_path: str,
    acc: ScoreAccumulator,
    min_fragment: int = 64,
) -> None:
    """Score every corrected fragment of ``fasta_path`` into ``acc``."""
    by_name: dict[bytes, list[bytes]] = {}
    name = None
    with open(fasta_path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                name = line[1:].split(b" ")[0].rsplit(b":", 1)[0]
                by_name.setdefault(name, []).append(b"")
            elif line and name is not None:
                by_name[name][-1] += line

    def _align_read(r: SimRead):
        """Every alignment one read needs: its truth context, the raw read's
        and each scored fragment's alignment to the truth. The banded
        fitting alignment (native, outside the GIL) dominates eval's wall
        time, so reads are aligned on a few threads; the counts are summed
        below in read order, which keeps every result what one thread gives."""
        ctx = _truth_context(ds, r)
        truth = ctx[0]
        rid = reads.name_to_id.get(r.name)
        raw_ta = None
        if rid is not None:
            raw_ta = align_to_truth(reads.seq(rid).tobytes(), truth.tobytes())
        frag_tas = [
            align_to_truth(frag, truth)
            for frag in by_name[r.name]
            if len(frag) >= min_fragment
        ]
        return ctx, raw_ta, frag_tas

    scored = [r for r in ds.reads if by_name.get(r.name)]
    with ThreadPoolExecutor(max_workers=_ALIGN_THREADS) as pool:
        aligned = pool.map(_align_read, scored)
        for (truth, other, het, hp), raw_ta, frag_tas in aligned:
            _accumulate_read(acc, truth, other, het, hp, raw_ta, frag_tas)


def _accumulate_read(acc, truth, other, het, hp, raw_ta, frag_tas) -> None:
    """One read's alignments into the accumulator."""
    acc.n_reads += 1
    n_truth = truth.shape[0]
    # raw full-read identity against the full truth: 1 - (fit distance +
    # uncovered-truth charge) / truth_len, charging end trims as errors
    if raw_ta is not None:
        acc.raw_idents.append(
            max(0.0, 1.0 - (raw_ta.distance + n_truth - raw_ta.span_len) / n_truth)
        )

    covered = np.zeros(truth.shape[0], dtype=bool)
    b2a_all = np.full(truth.shape[0], 254, dtype=np.uint8)
    ins_all = np.zeros(truth.shape[0] + 1, dtype=np.int64)
    frag_dist = 0  # summed fitting distance over aligned fragments
    for ta in frag_tas:
        acc.n_fragments += 1
        if ta is None:
            acc.n_unaligned_fragments += 1
            continue
        acc.matches += ta.matches
        acc.subs += ta.subs
        acc.ins += ta.ins
        acc.dels += ta.dels
        sl = slice(ta.j0, ta.j1)
        covered[sl] = True
        b2a_all[sl] = ta.b2a[sl]
        ins_all += ta.ins_after
        frag_dist += ta.distance

    # Corrected full-read identity combines ALL fragments of a split
    # read: summed fragment distances plus a charge for every truth
    # position no fragment covers (end trims and split gaps). Equals the
    # single-fragment definition when the read wasn't split.
    n_uncovered = int((~covered).sum())
    acc.read_idents.append(
        max(0.0, 1.0 - (frag_dist + n_uncovered) / truth.shape[0])
    )

    if het is not None:
        het_cov = het & covered
        acc.het_covered += int(het_cov.sum())
        v = b2a_all[het_cov]
        own_a = truth[het_cov]
        oth_a = other[het_cov]
        preserved = v == own_a
        switched = (~preserved) & (v == oth_a)
        acc.het_preserved += int(preserved.sum())
        acc.het_switched += int(switched.sum())
        acc.het_lost += int((~preserved & ~switched).sum())

    # homopolymer vs non-homopolymer error rates over covered positions:
    # substitutions/deletions charge their position; insertions charge the
    # position they precede.
    err = covered & (b2a_all != truth)
    ins_at = ins_all[: truth.shape[0]]
    hp_cov = hp & covered
    nhp_cov = ~hp & covered
    acc.hp_bases += int(hp_cov.sum())
    acc.non_hp_bases += int(nhp_cov.sum())
    acc.hp_errors += int(err[hp_cov].sum() + ins_at[hp_cov].sum())
    acc.non_hp_errors += int(err[nhp_cov].sum() + ins_at[nhp_cov].sum())


@dataclass
class EvalResult:
    mode: str
    scores: dict
    counting: dict | None = None  # matched-features counting baseline
    model_gain_db: float | None = None

    # flat accessors kept for existing callers/tests
    @property
    def n_reads(self) -> int:
        return self.scores["n_reads"]

    @property
    def raw_q(self) -> float:
        return self.scores["raw_q"]

    @property
    def corrected_q(self) -> float:
        return self.scores["corrected_q"]

    @property
    def corrected_identity(self) -> float:
        return self.scores["corrected_identity"]

    @property
    def raw_identity(self) -> float:
        return self.scores["raw_identity"]

    @property
    def corrected_infix_q(self) -> float:
        return self.scores["corrected_infix_q"]

    @property
    def corrected_infix_identity(self) -> float:
        return self.scores["corrected_infix_identity"]

    def as_dict(self) -> dict:
        out = {"mode": self.mode, **self.scores}
        if self.counting is not None:
            out["counting_baseline"] = self.counting
            out["model_gain_db"] = self.model_gain_db
        return out


def _oracle_correct(
    ds: SimDataset, reads, grouped, window_size: int, out_path: str
) -> int:
    """Decode with truth injected at supported columns (model ceiling)."""
    from ..features.extract import extract_read_features
    from ..io.fasta import write_corrected
    from ..ops.consensus import count_decisions_np, stitch_read
    from ..pipeline.batching import tensorize
    from .labels import read_labels

    by_name = {r.name: r for r in ds.reads}
    n = 0
    with open(out_path, "wb") as out:
        for rid, alns in grouped.items():
            sim_read = by_name[reads.ids[rid]]
            feats = extract_read_features(rid, reads, alns, window_size)
            labels = read_labels(ds, sim_read, feats, window_size)
            windows = []
            for wf, (lab, _info) in zip(feats, labels):
                wt = tensorize(wf)
                dec = count_decisions_np(wt.tokens, wt.n_alns)
                dec[wt.support_flat] = lab
                windows.append((wt.n_alns, dec))
            frags = stitch_read(windows)
            if frags is not None:
                write_corrected(
                    out, reads.ids[rid], reads.descriptions[rid], frags
                )
                n += 1
    return n


def evaluate(
    cfg,
    params,
    window_size: int = 4096,
    genome_len: int = 120_000,
    n_reads: int = 120,
    sub_rate: float = 0.02,
    ins_rate: float = 0.02,
    del_rate: float = 0.02,
    het_rate: float = 0.0,
    seed: int = 12345,
    batch_size: int = 16,
    bucket_spec: BucketSpec | None = None,
    counting_only: bool = False,
    mode: str | None = None,
    with_baseline: bool = False,
    shuffle_quals: bool = False,
    qual_mode: str = "informative",
    int8: bool | None = None,
    sim_extra: dict | None = None,
    device=None,
) -> EvalResult:
    """Evaluate a checkpoint (or a decode mode) on a fresh simulation.

    ``mode``: ``model`` (default), ``counting`` (pure counting floor) or
    ``oracle`` (truth at supported columns — the ceiling). With
    ``with_baseline`` the model run *also* emits the counting decode of the
    identical features, and ``model_gain_db`` reports the matched-seed gap.

    ``shuffle_quals`` permutes each read's quality string (seeded) before
    correction while leaving the bases untouched — the ablation control for
    the quality input channel: the matched-seed gap between a normal run and
    a shuffled run is the quality signal's contribution.
    """
    if mode is None:
        mode = "counting" if counting_only else "model"
    ds = simulate(
        genome_len=genome_len,
        n_reads=n_reads,
        read_len=(3 * window_size, 8 * window_size),
        sub_rate=sub_rate,
        ins_rate=ins_rate,
        del_rate=del_rate,
        het_rate=het_rate,
        seed=seed,
        qual_mode=qual_mode,
        **(sim_extra or {}),
    )
    if shuffle_quals:
        qrng = np.random.default_rng(seed ^ 0x5EED)
        for r in ds.reads:
            if r.quals is not None:
                q = np.frombuffer(r.quals, dtype=np.uint8).copy()
                qrng.shuffle(q)
                r.quals = q.tobytes()
    with tempfile.TemporaryDirectory() as tmp:
        fastq = os.path.join(tmp, "reads.fastq")
        ds.write_fastq(fastq)
        reads = load_reads(fastq, min_length=window_size)
        grouped = parse_paf(
            paf_rows(ds, min_overlap=window_size), reads.name_to_id
        )

        out = os.path.join(tmp, "corrected.fasta")
        cnt_out = os.path.join(tmp, "counting.fasta") if with_baseline else None
        if mode == "oracle":
            _oracle_correct(ds, reads, grouped, window_size, out)
        else:
            runner = CorrectionRunner(
                cfg,
                params,
                counting_only=(mode == "counting"),
                collect_counting=with_baseline,
                int8=int8,
                device=device,
            )
            run_correction(
                reads,
                iter(grouped.items()),
                runner,
                out,
                window_size,
                batch_size,
                bucket_spec=bucket_spec,
                counting_output_path=cnt_out,
            )

        acc = ScoreAccumulator()
        score_fragments(ds, reads, out, acc)
        scores = acc.as_dict()

        counting_scores = None
        gain = None
        if cnt_out is not None:
            cacc = ScoreAccumulator()
            score_fragments(ds, reads, cnt_out, cacc)
            counting_scores = cacc.as_dict()
            gain = scores["corrected_infix_q"] - counting_scores["corrected_infix_q"]

    return EvalResult(
        mode=mode, scores=scores, counting=counting_scores, model_gain_db=gain
    )
