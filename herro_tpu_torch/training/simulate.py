"""Synthetic nanopore-style data simulator.

Generates a random genome, error-laden reads (substitutions / insertions /
deletions at configurable rates), *exact* pairwise PAF rows between
overlapping reads (by composing each read's edit script against the genome),
and per-window ground-truth labels — everything needed to exercise and train
the pipeline without minimap2 or real data.

Per-read edit model: walking the genome positions of its span, each position
is either emitted (possibly substituted) or deleted, and may be followed by
inserted bases. The pairwise CIGAR of reads A (target) and B (query) is the
composition of their scripts over the shared genome interval: genome-emitted
bases pair as M/I/D; co-located inserted runs pair greedily as M.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


@dataclass
class SimRead:
    name: bytes
    start: int  # genome start of the span
    end: int  # genome end (exclusive)
    rc: bool  # stored reverse-complemented
    seq: bytes  # stored (possibly RC'd) sequence
    emitted: np.ndarray  # bool [span]: genome position present in the read
    sub: np.ndarray  # uint8 [span]: emitted base (valid where emitted)
    ins_after: list[bytes]  # inserted bases after each genome position (fwd)
    hap: int = 0  # haplotype the read was sampled from
    quals: bytes | None = None  # stored-orientation phred+33; None = constant
    # Chimeric/junction read (adapter chimera): ``parts`` holds the two+
    # contiguous-span segments whose stored sequences concatenate to ``seq``.
    # When set, the span fields above describe the FIRST part only; truth,
    # labels and PAF generation dispatch per part (real aligners align each
    # segment separately, so junction-spanning windows go uncovered and the
    # corrected read splits there — the reference's <2-alignment split rule,
    # src/consensus.rs:104-110).
    parts: list["SimRead"] | None = None

    @property
    def length(self) -> int:
        return len(self.seq)

    @property
    def ins_lens(self) -> np.ndarray:
        if not hasattr(self, "_ins_lens"):
            self._ins_lens = np.fromiter(
                (len(x) for x in self.ins_after), dtype=np.int64,
                count=len(self.ins_after),
            )
        return self._ins_lens

    @property
    def fwd_cum(self) -> np.ndarray:
        """fwd_cum[j] = forward-sequence offset of genome position start+j."""
        if not hasattr(self, "_fwd_cum"):
            per_pos = self.emitted.astype(np.int64) + self.ins_lens
            cum = np.zeros(per_pos.shape[0] + 1, dtype=np.int64)
            np.cumsum(per_pos, out=cum[1:])
            self._fwd_cum = cum
        return self._fwd_cum


@dataclass
class SimDataset:
    genome: bytes  # haplotype 0
    reads: list[SimRead]
    haplotypes: list[bytes] | None = None  # [hap0, hap1]; None = haploid
    # genome intervals where read sampling was suppressed (coverage dropouts)
    dropouts: list[tuple[int, int]] = field(default_factory=list)
    # systematic-miscall hotspot maps over the genome (diagnostics only;
    # zero-length when the dataset was simulated without sys_rate):
    # wrong base byte (0 = not a hotspot), per-hotspot miscall probability,
    # strand gate (0 both, 1 forward-stored only, 2 reverse-stored only)
    sys_wrong: np.ndarray | None = None
    sys_p: np.ndarray | None = None
    sys_gate: np.ndarray | None = None

    def hap_seq(self, hap: int) -> np.ndarray:
        if self.haplotypes is None:
            return np.frombuffer(self.genome, dtype=np.uint8)
        return np.frombuffer(self.haplotypes[hap], dtype=np.uint8)

    def write_fastq(self, path: str, qual: int = 40) -> None:
        """Write reads with their simulated per-base qualities (informative:
        correlated with the true error events — the signal the reference
        consumes, src/inference.rs:16-21); ``qual`` is the constant fallback
        for datasets simulated with ``qual_mode="constant"``."""
        with open(path, "wb") as fh:
            for r in self.reads:
                q = r.quals if r.quals is not None else bytes([33 + qual]) * r.length
                fh.write(b"@" + r.name + b"\n" + r.seq + b"\n+\n" + q + b"\n")


def _homopolymer_weights(genome: np.ndarray, boost: float) -> np.ndarray:
    """Per-position indel-rate multiplier: `boost` inside homopolymer runs of
    length >= 3 (ONT errors concentrate in homopolymers)."""
    n = genome.shape[0]
    w = np.ones(n, dtype=np.float32)
    if n < 3 or boost <= 1.0:
        return w
    same_prev = np.concatenate([[False], genome[1:] == genome[:-1]])
    # run id per position, then run length via bincount
    run_id = np.cumsum(~same_prev) - 1
    run_len = np.bincount(run_id)
    w[run_len[run_id] >= 3] = boost
    return w


def _informative_quals(
    rng: np.random.Generator,
    emitted: np.ndarray,
    subs: np.ndarray,
    ins_lens: np.ndarray,
    rc: bool,
    q_read_mean: float,
    q_read_sigma: float,
    q_err_mean: float,
    miscal_rate: float,
) -> bytes:
    """Per-base phred+33 string (stored orientation) correlated with the
    read's actual error events, ONT-style:

    * read-level quality drift: each read draws its own baseline quality;
    * erroneous bases (substituted or inserted) draw from a low-Q
      distribution; correct bases from the read baseline + per-base noise;
    * the base preceding a deletion is degraded (local signal loss);
    * ``miscal_rate`` of bases are miscalibrated (quality replaced by a
      uniform draw regardless of correctness) — models basecaller
      calibration error so training can't treat quality as oracle truth.

    Calibration target: per-base qual-vs-error discrimination of AUC ~0.8,
    the realistic basecaller regime — NOT an oracle. The first informative
    parameterisation (err N(10,3) vs correct N(rq,3.5), 3% miscal) gave AUC
    ~0.95; training on it collapsed to hard-column accuracy ~1.0 within 50
    steps, i.e. the model could read the error positions straight off the
    qual plane and would have become qual-dependent in a way real data
    never supports.
    """
    n_span = emitted.shape[0]
    per_pos = emitted.astype(np.int64) + ins_lens
    offsets = np.zeros(n_span + 1, dtype=np.int64)
    np.cumsum(per_pos, out=offsets[1:])
    n = int(offsets[-1])
    if n == 0:
        return b""

    is_err = np.ones(n, dtype=bool)  # insertions default to error
    em = np.nonzero(emitted)[0]
    is_err[offsets[em]] = subs[em]  # emitted bases: error iff substituted

    rq = float(np.clip(rng.normal(q_read_mean, q_read_sigma), 12.0, 32.0))
    q = np.where(
        is_err,
        rng.normal(q_err_mean, 4.0, size=n),
        rq + rng.normal(0.0, 4.5, size=n),
    )
    # degrade the base just before each deleted genome position
    deleted = np.nonzero(~emitted)[0]
    before = offsets[deleted] - 1
    before = before[before >= 0]
    q[before] -= 4.0
    miscal = rng.random(n) < miscal_rate
    if miscal.any():
        q[miscal] = rng.uniform(4.0, 36.0, size=int(miscal.sum()))
    q = np.clip(np.rint(q), 2, 50).astype(np.uint8) + 33
    if rc:
        q = q[::-1]
    return q.tobytes()


def simulate(
    genome_len: int = 20_000,
    n_reads: int = 40,
    read_len: tuple[int, int] = (6_000, 12_000),
    sub_rate: float = 0.02,
    ins_rate: float = 0.01,
    del_rate: float = 0.01,
    rc_prob: float = 0.5,
    seed: int = 0,
    het_rate: float = 0.0,
    hp_indel_boost: float = 3.0,
    qual_mode: str = "informative",
    q_read_mean: float = 20.0,
    q_read_sigma: float = 4.0,
    q_err_mean: float = 13.0,
    miscal_rate: float = 0.06,
    sys_rate: float = 0.0,
    sys_strength: tuple[float, float] = (0.3, 0.8),
    sys_strand_frac: float = 0.5,
    chimera_rate: float = 0.0,
    n_dropouts: int = 0,
    dropout_len: tuple[int, int] = (2_000, 6_000),
    dropout_keep: float = 0.25,
) -> SimDataset:
    """Simulate a (optionally diploid) genome and error-laden reads.

    ``het_rate`` > 0 creates a second haplotype differing by substitution SNPs
    at that rate; each read samples a haplotype uniformly. Correct
    haplotype-aware correction must preserve the read's own allele at het
    sites — pooled majority voting is systematically wrong there, which is
    the hard case the model (and the reference's phase re-rank,
    src/features.rs:461-528) exists for. Indel error probability is boosted
    inside homopolymer runs, ONT-style.

    ``qual_mode="informative"`` (default) gives every read per-base phred
    scores correlated with its actual error events (see
    :func:`_informative_quals`) — base quality is a first-class model input
    in the reference (src/haec_io.rs:57-60, src/inference.rs:16-21), so the
    simulator must make it a real signal. ``"constant"`` restores the flat
    Q40 of earlier rounds.

    Systematic-error knobs (the regimes where real pileup consensus fails —
    the reference's model earns its assembly QV on real minimap2 pileups
    full of them, and per-read-independent errors alone can't reproduce
    that):

    * ``sys_rate`` — fraction of genome positions that are locus-correlated
      miscall hotspots: every read covering the position miscalls it to the
      SAME wrong base with a per-hotspot probability drawn from
      ``sys_strength``, so the wrong base can win a plurality vote.
      Hotspot miscalls carry *confident* base qualities (real systematic
      basecaller errors look confident — that is precisely what makes them
      systematic), unlike the random-error low-Q signal.
    * ``sys_strand_frac`` — fraction of hotspots gated to one strand
      (forward-only or reverse-only, chosen per hotspot): strand-biased
      errors are visible in the pileup through the case/gap encoding of
      reverse rows (src/features.rs:139-163) and are separable from true
      SNVs only by that structure.
    * ``chimera_rate`` — probability a read is an adapter-chimera junction
      of two independent genome spans (stored as ``SimRead.parts``); PAF
      rows are emitted per segment, so junction windows go uncovered and
      the corrected read must split there.
    * ``n_dropouts`` / ``dropout_len`` / ``dropout_keep`` — coverage
      dropout intervals: reads overlapping one are rejected with
      probability ``1 - dropout_keep``, thinning the local pileup.
    """
    rng = np.random.default_rng(seed)
    genome = rng.choice(_BASES, size=genome_len)

    haplotypes = None
    hap_arrays = [genome]
    if het_rate > 0:
        het_sites = rng.random(genome_len) < het_rate
        hap2 = genome.copy()
        shift = rng.integers(1, 4, size=genome_len)
        base_idx = np.searchsorted(_BASES, genome)
        hap2[het_sites] = _BASES[(base_idx[het_sites] + shift[het_sites]) % 4]
        hap_arrays = [genome, hap2]
        haplotypes = [genome.tobytes(), hap2.tobytes()]

    hp_w = [_homopolymer_weights(h, hp_indel_boost) for h in hap_arrays]

    # Locus-correlated miscall hotspots, dense over the genome: wrong base
    # (0 = not a hotspot), per-hotspot strength, strand gate (0 both,
    # 1 forward-stored only, 2 reverse-stored only).
    sys_wrong = np.zeros(genome_len, dtype=np.uint8)
    sys_p = np.zeros(genome_len, dtype=np.float32)
    sys_gate = np.zeros(genome_len, dtype=np.int8)
    if sys_rate > 0:
        hot = np.nonzero(rng.random(genome_len) < sys_rate)[0]
        if hot.size:
            base_idx = np.searchsorted(_BASES, genome[hot])
            shift = rng.integers(1, 4, size=hot.size)
            sys_wrong[hot] = _BASES[(base_idx + shift) % 4]
            sys_p[hot] = rng.uniform(*sys_strength, size=hot.size)
            biased = rng.random(hot.size) < sys_strand_frac
            gates = np.zeros(hot.size, dtype=np.int8)
            gates[biased] = rng.integers(1, 3, size=int(biased.sum()))
            sys_gate[hot] = gates

    dropouts: list[tuple[int, int]] = []
    for _ in range(n_dropouts):
        dl = int(rng.integers(dropout_len[0], dropout_len[1] + 1))
        dl = min(dl, genome_len)
        s = int(rng.integers(0, genome_len - dl + 1))
        dropouts.append((s, s + dl))

    def _make_part(length: int | None = None) -> SimRead:
        """One contiguous-span error-laden segment with informative quals.

        The RNG draw order for default knobs (no hotspots/dropouts/chimeras)
        is frozen: hap, length, start, emitted, subs, shift, ins_mask,
        per-insertion draws, rc, quals — changing it would silently shift
        every seeded dataset (frozen featurization goldens, matched-seed
        eval baselines, training caches). New features only ADD draws, and
        only when enabled.
        """
        hap = int(rng.integers(0, len(hap_arrays)))
        source = hap_arrays[hap]
        if length is None:
            length = int(rng.integers(read_len[0], read_len[1] + 1))
        length = min(length, genome_len)
        for _attempt in range(64):
            start = int(rng.integers(0, genome_len - length + 1))
            end = start + length
            if not dropouts:
                break
            hit = any(start < d1 and end > d0 for d0, d1 in dropouts)
            if not hit or rng.random() < dropout_keep:
                break
        span = source[start:end]
        w = hp_w[hap][start:end]
        emitted = rng.random(length) >= del_rate * w
        sub = span.copy()
        subs = rng.random(length) < sub_rate
        # substitution: shift by 1-3 in base space so it always differs
        shift = rng.integers(1, 4, size=length)
        base_idx = np.searchsorted(_BASES, span)
        sub[subs] = _BASES[(base_idx[subs] + shift[subs]) % 4]

        ins_mask = rng.random(length) < ins_rate * w
        ins_after: list[bytes] = [b""] * length
        for j in np.nonzero(ins_mask)[0]:
            k = int(rng.integers(1, 4))
            ins_after[j] = rng.choice(_BASES, size=k).tobytes()

        rc = bool(rng.random() < rc_prob)

        # systematic hotspot miscalls: same wrong base for every covering
        # read (strand-gated), overriding any random substitution there
        sysm = np.zeros(length, dtype=bool)
        w_g = sys_wrong[start:end]
        if w_g.any():
            # gate semantics: 0 = both strands, 1 = forward-stored reads
            # only, 2 = reverse-stored reads only
            gate = sys_gate[start:end]
            sysm = (w_g != 0) & emitted
            sysm &= (gate == 0) | (gate == (2 if rc else 1))
            sysm &= rng.random(length) < sys_p[start:end]
            sub[sysm] = w_g[sysm]

        chunks = []
        for j in range(length):
            if emitted[j]:
                chunks.append(sub[j : j + 1].tobytes())
            if ins_after[j]:
                chunks.append(ins_after[j])
        fwd = b"".join(chunks)
        seq = _COMP[np.frombuffer(fwd, dtype=np.uint8)][::-1].tobytes() if rc else fwd

        part = SimRead(
            name=b"",
            start=start,
            end=end,
            rc=rc,
            seq=seq,
            emitted=emitted,
            sub=sub,
            ins_after=ins_after,
            hap=hap,
        )
        if qual_mode == "informative":
            # hotspot miscalls are excluded from the error-qual draw: they
            # get confident (correct-looking) qualities on purpose
            part.quals = _informative_quals(
                rng, emitted, subs & emitted & ~sysm, part.ins_lens, rc,
                q_read_mean, q_read_sigma, q_err_mean, miscal_rate,
            )
        return part

    reads = []
    for i in range(n_reads):
        if chimera_rate > 0 and rng.random() < chimera_rate:
            length = int(rng.integers(read_len[0], read_len[1] + 1))
            l1 = max(length // 2, 1)
            p1, p2 = _make_part(l1), _make_part(max(length - l1, 1))
            read = SimRead(
                name=b"read_%d" % i,
                start=p1.start,
                end=p1.end,
                rc=p1.rc,
                seq=p1.seq + p2.seq,
                emitted=p1.emitted,
                sub=p1.sub,
                ins_after=p1.ins_after,
                hap=p1.hap,
                quals=(
                    p1.quals + p2.quals if p1.quals is not None else None
                ),
                parts=[p1, p2],
            )
        else:
            read = _make_part()
            read.name = b"read_%d" % i
        reads.append(read)

    return SimDataset(
        genome.tobytes(), reads, haplotypes, dropouts=dropouts,
        sys_wrong=sys_wrong, sys_p=sys_p, sys_gate=sys_gate,
    )


def _fwd_offset(read: SimRead, g0: int) -> int:
    """Forward-sequence position where genome position ``g0`` lands in the
    read (bases emitted before it, including trailing insertions)."""
    return int(read.fwd_cum[g0 - read.start])


_OP_M, _OP_D, _OP_I, _OP_NONE = 0, 1, 2, 3
_OP_BYTES = (b"M", b"D", b"I", b"?")


def _compose_cigar(a: SimRead, b: SimRead, g0: int, g1: int) -> list[tuple[int, bytes]]:
    """CIGAR of target a vs query b over genome interval [g0, g1), in target
    orientation, as (len, op) runs. M consumes both, I query-only, D
    target-only.

    Vectorised: every genome position contributes up to four op slots
    (emitted-base pairing + greedy M/D/I pairing of co-located insertions);
    the slots are flattened, zero-length slots dropped, and adjacent equal
    ops run-length merged — no per-base Python loop.
    """
    n = g1 - g0
    ae = a.emitted[g0 - a.start : g1 - a.start]
    be = b.emitted[g0 - b.start : g1 - b.start]
    ka = a.ins_lens[g0 - a.start : g1 - a.start]
    kb = b.ins_lens[g0 - b.start : g1 - b.start]

    ops = np.empty((n, 4), dtype=np.int8)
    lens = np.empty((n, 4), dtype=np.int64)
    # slot 0: the emitted-base pairing
    ops[:, 0] = np.where(ae & be, _OP_M, np.where(ae, _OP_D, np.where(be, _OP_I, _OP_NONE)))
    lens[:, 0] = (ae | be).astype(np.int64)
    # slots 1-3: insertion pairing
    m = np.minimum(ka, kb)
    ops[:, 1] = _OP_M
    lens[:, 1] = m
    ops[:, 2] = _OP_D
    lens[:, 2] = ka - m
    ops[:, 3] = _OP_I
    lens[:, 3] = kb - m

    flat_ops = ops.reshape(-1)
    flat_lens = lens.reshape(-1)
    keep = flat_lens > 0
    flat_ops = flat_ops[keep]
    flat_lens = flat_lens[keep]
    if flat_ops.shape[0] == 0:
        return []

    # run-length merge of adjacent equal ops
    boundary = np.empty(flat_ops.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = flat_ops[1:] != flat_ops[:-1]
    starts = np.nonzero(boundary)[0]
    cum = np.concatenate([[0], np.cumsum(flat_lens)])
    ends = np.concatenate([starts[1:], [flat_ops.shape[0]]])
    run_lens = cum[ends] - cum[starts]
    run_ops = flat_ops[starts]
    return [
        (int(l), _OP_BYTES[o]) for l, o in zip(run_lens, run_ops)
    ]


def _trim_to_m(
    runs: list[tuple[int, bytes]]
) -> tuple[list[tuple[int, bytes]], int, int, int, int]:
    """Trim leading/trailing non-M ops (minimap2 alignments are M-anchored).
    Returns (runs, t_trim_front, q_trim_front, t_trim_back, q_trim_back)."""
    tf = qf = tb = qb = 0
    while runs and runs[0][1] != b"M":
        l, op = runs.pop(0)
        if op == b"D":
            tf += l
        else:
            qf += l
    while runs and runs[-1][1] != b"M":
        l, op = runs.pop()
        if op == b"D":
            tb += l
        else:
            qb += l
    return runs, tf, qf, tb, qb


def _alignable_units(ds: SimDataset) -> list[tuple[int, SimRead, SimRead, int]]:
    """(parent index, parent read, contiguous-span segment, stored-seq
    offset of the segment) — one unit per normal read, one per chimera
    part. Real aligners align each chimera segment separately, so PAF
    geometry is per-segment with coordinates offset into the parent."""
    units = []
    for i, r in enumerate(ds.reads):
        if r.parts is None:
            units.append((i, r, r, 0))
        else:
            off = 0
            for p in r.parts:
                units.append((i, r, p, off))
                off += p.length
    return units


def paf_rows(ds: SimDataset, min_overlap: int = 500) -> list[bytes]:
    """Exact PAF rows (with cg:Z: tags) for every overlapping read pair.

    Both orientations are emitted, like minimap2 --dual=yes
    (reference: src/mm2.rs:30)."""
    rows = []
    units = _alignable_units(ds)
    for ti, ta_parent, a, t_off in units:
        for qi, qb_parent, b, q_off in units:
            if ti == qi:
                continue
            g0, g1 = max(a.start, b.start), min(a.end, b.end)
            if g1 - g0 < min_overlap:
                continue

            runs = _compose_cigar(a, b, g0, g1)
            runs, tf, qf, tb, qb = _trim_to_m(runs)
            if not runs:
                continue

            ta_off = _fwd_offset(a, g0)
            qb_off = _fwd_offset(b, g0)
            t_span = sum(l for l, op in runs if op != b"I")
            q_span = sum(l for l, op in runs if op != b"D")

            tstart = ta_off + tf
            tend = tstart + t_span
            q_fwd_start = qb_off + qf
            q_fwd_end = q_fwd_start + q_span

            # Orientation: the cigar is computed with both reads in genome
            # orientation. PAF coordinates are on each read's *stored* strand,
            # so each flips independently; the strand field is '-' when
            # exactly one of the two is stored RC'd. When the target is
            # stored RC'd the cigar reverses so it walks the stored target
            # forward (and hence the oriented query backward, which is what a
            # '-' row's query walk decodes).
            strand = b"-" if a.rc != b.rc else b"+"
            if a.rc:
                tstart, tend = a.length - tend, a.length - tstart
                runs = runs[::-1]
            if b.rc:
                q_fwd_start, q_fwd_end = (
                    b.length - q_fwd_end,
                    b.length - q_fwd_start,
                )

            cigar = b"".join(b"%d%s" % (l, op) for l, op in runs)
            rows.append(
                b"\t".join(
                    [
                        qb_parent.name,
                        b"%d" % qb_parent.length,
                        b"%d" % (q_fwd_start + q_off),
                        b"%d" % (q_fwd_end + q_off),
                        strand,
                        ta_parent.name,
                        b"%d" % ta_parent.length,
                        b"%d" % (tstart + t_off),
                        b"%d" % (tend + t_off),
                        b"0",
                        b"%d" % max(t_span, q_span),
                        b"60",
                        b"cg:Z:" + cigar,
                    ]
                )
                + b"\n"
            )
    return rows


def true_sequence(ds: SimDataset, read: SimRead) -> bytes:
    """The error-free sequence a perfect corrector would output for ``read``:
    its span on its *own haplotype*, in stored orientation. For a chimeric
    read this is the concatenation of its parts' truths (the junction is a
    library artifact, not an error to repair)."""
    if read.parts is not None:
        return b"".join(true_sequence(ds, p) for p in read.parts)
    span = ds.hap_seq(read.hap)[read.start : read.end]
    return _COMP[span][::-1].tobytes() if read.rc else span.tobytes()


def read_truth_arrays(
    ds: SimDataset, read: SimRead
) -> tuple[np.ndarray, dict[int, bytes]]:
    """Ground truth along the read's *stored* orientation.

    Returns (anchor_truth, ins_truth):
      anchor_truth[p]  — true class of read position p: 0-3 = A,C,G,T (the
                         genome base, fixing substitutions), 4 = '*' (the
                         position is a read insertion error);
      ins_truth[p]     — genome bases deleted from the read right after
                         position p (to be restored in insertion columns);
                         sparse dict, missing -> no deleted bases.

    Chimeric reads concatenate their parts' arrays (each part owns a
    contiguous stored-position range; entries per part == part.length).
    """
    if read.parts is not None:
        anchors = []
        ins_all: dict[int, bytes] = {}
        off = 0
        for p in read.parts:
            at, it = read_truth_arrays(ds, p)
            anchors.append(at)
            for k, v in it.items():
                ins_all[k + off] = v
            off += p.length
        return np.concatenate(anchors), ins_all

    lut = np.full(256, 255, dtype=np.uint8)
    for k, c in enumerate(b"ACGT"):
        lut[c] = k

    # truth is the read's own haplotype (haplotype-aware correction)
    genome = ds.hap_seq(read.hap)
    span = genome[read.start : read.end]
    emitted = read.emitted
    ins_lens = read.ins_lens

    # Entry layout per genome position j: (emitted base if any) then
    # ins_lens[j] insertion-error entries (truth '*').
    per_pos = emitted.astype(np.int64) + ins_lens
    offsets = np.concatenate([[0], np.cumsum(per_pos)])
    n_entries = int(offsets[-1])

    anchor_truth = np.full(n_entries, 4, dtype=np.uint8)
    em = np.nonzero(emitted)[0]
    anchor_truth[offsets[em]] = lut[span[em]]

    # Deleted genome bases attach to the entry just before position j.
    ins_runs: dict[int, bytes] = {}
    for j in np.nonzero(~emitted)[0]:
        p = int(offsets[j]) - 1
        if p >= 0:
            ins_runs[p] = ins_runs.get(p, b"") + span[j : j + 1].tobytes()

    if read.rc:
        # flip to stored orientation: complement classes 0-3, reverse order;
        # a deletion run after p (fwd) precedes the complementary position.
        comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
        anchor_truth = comp[anchor_truth][::-1].copy()
        flipped: dict[int, bytes] = {}
        for p, run in ins_runs.items():
            tgt = n_entries - 2 - p
            if tgt >= 0:
                flipped[tgt] = _COMP[np.frombuffer(run, dtype=np.uint8)][
                    ::-1
                ].tobytes()
        ins_runs = flipped
    return anchor_truth, ins_runs
