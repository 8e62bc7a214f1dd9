"""The port's tracer (abyss_tpu_torch/utils/trace.py) on the CPU: off it
records nothing and never synchronises; on, spans nest with their
parents and jobs, spans over a generator leave the consumer out, a
traced `pe` writes the untraced run's artifacts byte for byte and holds
the stage, pass-2, walk, align and scaffold spans inside their parents,
the walk counters count what the lanes did, and the exact engine's
phases are spans."""

import contextlib
import io
import os
import time

import numpy as np
import pytest
import torch

from abyss_tpu_torch import sim
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import bloom_dbg, extend, hash_dbg
from abyss_tpu_torch.dbg.params import AssemblyParams
from abyss_tpu_torch.ops import nthash
from abyss_tpu_torch.ops.sorted_filter import SortedKmerCounter
from abyss_tpu_torch.pipeline import pe
from abyss_tpu_torch.utils import trace

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with tracing off and nothing pending."""
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


@pytest.fixture
def no_sync(monkeypatch):
    """A CUDA runtime that looks started and raises if synchronised."""
    def refuse(*a):
        raise AssertionError("torch.cuda.synchronize called")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def write_pairs(d, genome_len=5000, seed=5, coverage=30):
    genome = sim.random_genome(genome_len, seed=seed)
    pr = sim.simulate_paired_reads(genome, coverage=coverage, read_len=100,
                                   fragment_mean=400, fragment_sd=40,
                                   error_rate=0.003, seed=seed + 1)
    paths = [os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")]
    pr.write_fastq(*paths)
    return paths


def test_off_records_nothing_and_never_synchronises(tmp_path, no_sync):
    with trace.job():
        with trace.span("outer", device=True) as s:
            trace.count("n", 3)
            with trace.span("inner", device=True):
                pass
    assert s.seconds >= 0
    paths = write_pairs(str(tmp_path), genome_len=2000, coverage=20)
    params = AssemblyParams(k=25, min_cov=2, bloom_bytes=1 << 20,
                            batch_size=256, max_read_len=128)
    with open(tmp_path / "u.fa", "w") as out:
        bloom_dbg.assemble(paths, params, out=out, device="cpu")
    assert trace.take() == []


def test_device_spans_synchronise_only_when_on(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    with trace.recording() as records:
        with trace.span("host"):
            pass
        assert calls == []
        with trace.span("dev", device=True):
            assert calls == [0, 1]
    assert calls == [0, 1, 0, 1]
    assert [r.name for r in records] == ["host", "dev"]


def test_spans_nest_with_parents_and_jobs():
    trace.enable(True)
    with trace.job():
        with trace.span("a"):
            with trace.span("b"):
                trace.count("c", 2)
                with trace.job():        # inside a job: the same job
                    with trace.span("d"):
                        pass
        with trace.span("e"):
            pass
    with trace.job():
        with trace.span("f"):
            pass
    with trace.span("g"):
        pass
    records = trace.take()
    assert trace.take() == []
    spans = {r.name: r for r in records if isinstance(r, trace.SpanRecord)}
    (c,) = [r for r in records if isinstance(r, trace.CountRecord)]
    assert [r.name for r in records] == ["c", "d", "b", "a", "e", "f", "g"]
    a, b, d, e, f, g = (spans[n] for n in "abdefg")
    assert a.parent is None and e.parent is None and f.parent is None
    assert b.parent == a.id and d.parent == b.id and c.span == b.id
    assert a.job == b.job == c.job == d.job == e.job > 0
    assert f.job not in (0, a.job) and g.job == 0
    for child, parent in ((b, a), (d, b)):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    assert trace.span_seconds(records)["a"] == pytest.approx(a.seconds)
    assert trace.counter_totals(records) == {"c": 2}


def test_recording_keeps_pending_records_and_state():
    trace.enable(True)
    with trace.span("before"):
        pass
    with trace.recording() as records:
        with trace.span("inside"):
            pass
    assert [r.name for r in records] == ["inside"]
    assert trace.enabled()
    assert [r.name for r in trace.take()] == ["before"]


def test_each_closes_its_span_before_the_consumer_runs():
    def produce():
        for i in range(3):
            time.sleep(0.001)
            yield i

    got = []
    with trace.recording() as records:
        for item in trace.each("io.fastq_batch", produce()):
            got.append((item, time.perf_counter_ns()))
            time.sleep(0.002)
    assert [i for i, _ in got] == [0, 1, 2]
    # one span a produced item, none for the end of the stream, and
    # each closed before its item reached the consumer
    assert len(records) == 3
    for r, (_, handed) in zip(records, got):
        assert r.name == "io.fastq_batch" and r.end_ns <= handed


def _solid_walk_filter(seqs, k):
    ctr = SortedKmerCounter(k, 1)
    for s in seqs:
        canon, valid = nthash.canonical_hashes(
            torch.from_numpy(alphabet.encode(s)[None]), k)
        ctr.add(canon, valid)
    return extend.walk_filter(ctr.finalize())


def test_walk_counters_count_advances_and_stops():
    k = 11
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    # a branch at 150 stops lanes NEED_F; lanes seeded near the end run
    # into a dead end; max_steps 40 leaves some lanes ACTIVE
    wf = _solid_walk_filter([genome, genome[140:151] + "A" * 20], k)
    starts = [0, 100, 145, 200, 280, 289]
    seeds = np.stack([alphabet.encode(genome[s:s + k]) for s in starts])
    st0 = extend.init_state(seeds, k + 64, k, "cpu")
    st0.status[-1] = extend.DEAD_END          # an inert lane
    fields = ("buf", "length", "f", "r", "status", "has_prev")

    def copy():
        return st0._replace(**{n: getattr(st0, n).clone() for n in fields})

    # by hand: one step at a time, each lane's advances plus the step
    # that stopped it
    st = copy()
    rows = torch.arange(len(starts))
    steps = 0
    for _ in range(40):
        active = st.status == extend.ACTIVE
        before = st.length.clone()
        st = extend._step(wf, st, k, rows)
        steps += int((st.length - before).sum())
        steps += int((active & (st.status != extend.ACTIVE)).sum())
    with trace.recording() as records:
        got = extend.fast_extend(wf, copy(), k, 40)
    assert torch.equal(got.length, st.length)
    assert torch.equal(got.status, st.status)
    counts = trace.counter_totals(records)
    bases = int((st.length - st0.length).sum())
    assert counts == {"walk.lanes": len(starts), "walk.lane_steps": steps,
                      "walk.bases": bases}
    assert steps > bases > 0
    assert set(st.status.tolist()) >= {extend.ACTIVE, extend.DEAD_END}
    # off: the same walk counts nothing
    extend.fast_extend(wf, copy(), k, 40)
    assert trace.take() == []


def mapping_library(d, seed=8):
    """(params, contigs FASTA, the two mate files) of 5 kbp: three
    contigs of the genome, the middle one reverse-complemented, and
    pairs whose first reads lose 3 bases at 40-42 one time in five (the
    indels the mapper chains over two diagonals)."""
    genome = sim.random_genome(5000, seed=seed)
    target = os.path.join(d, "t.fa")
    with open(target, "w") as f:
        for i, (a, b) in enumerate(((0, 1800), (1750, 3400), (3350, 5000))):
            seq = genome[a:b] if i != 1 else alphabet.revcomp(genome[a:b])
            f.write(f">{i} {b - a} 0\n{seq}\n")
    pr = sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                                   fragment_mean=400, fragment_sd=40,
                                   error_rate=0.003, seed=seed + 1)
    pr.reads1[::5] = [(n, q[:40] + q[43:], x[3:])
                      for n, q, x in pr.reads1[::5]]
    files = [os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")]
    pr.write_fastq(*files)
    p = pe.PipelineParams(name="m", batch_size=256, max_read_len=128,
                          verbose=0, device="cpu")
    return p, target, files


def test_mapper_counters_count_reads_and_pairs(tmp_path, monkeypatch):
    """`align.mapped`, `align.chained`, `fixmate.pairs` and
    `fixmate.links` count what the mapper's columns and the pairing
    hold with tracing on; off, nothing is counted (no count is asked
    for) and the mapping is the same."""
    from abyss_tpu_torch.align import mapper
    from abyss_tpu_torch.io import read_batches
    p, target, files = mapping_library(str(tmp_path))
    with trace.recording() as records:
        hist, links = pe._map_library(p, target, files, 32)
    al = mapper.KmerAligner(pe._read_contigs(target)[0], k=32, device="cpu")
    cols, qnames = [], []
    for b in read_batches(files, p.batch_size, p.max_read_len, q=p.q):
        cols.append(al.align_columns(b.codes, b.lengths, len(b.ids)))
        qnames += b.ids
    cols = np.concatenate(cols, axis=1)
    mapped = cols[mapper.MAPPED] == 1
    keys = [q[:-2] for q, m in zip(qnames, mapped) if m]
    pairs = sum(n // 2 for n in np.unique(keys, return_counts=True)[1])
    assert trace.counter_totals(records) == {
        "align.mapped": int(mapped.sum()),
        "align.chained": int(cols[mapper.CHAINED].sum()),
        "fixmate.pairs": pairs, "fixmate.links": len(links)}
    assert mapped.sum() > cols[mapper.CHAINED].sum() > 0
    assert pairs > len(links) > 0 and hist.size() > 0

    def refuse(*a):
        raise AssertionError("trace.count called with tracing off")
    monkeypatch.setattr(trace, "count", refuse)
    off = pe._map_library(p, target, files, 32)
    assert trace.take() == []
    assert (off[0].to_text(), off[1]) == (hist.to_text(), links)


def test_exact_engine_phases_are_spans():
    genome = sim.random_genome(3000, seed=11)
    reads = sim.simulate_paired_reads(genome, coverage=20, read_len=80,
                                      error_rate=0.003, seed=12)
    codes = np.full((len(reads.reads1), 80), 4, np.uint8)
    for i, (_, seq, _) in enumerate(reads.reads1):
        codes[i, :len(seq)] = alphabet.encode(seq)
    want, _ = hash_dbg.assemble_reads([codes], 25, device="cpu")
    with trace.recording() as records:
        got, _ = hash_dbg.assemble_reads([codes], 25, device="cpu",
                                         min_mean_cov=2.0)
    assert {s for s, _ in got} == {s for s, _ in want}
    names = set(trace.span_seconds(records))
    assert {"hash.count", "hash.kc_filter", "hash.adjacency", "hash.erode",
            "hash.trim", "hash.lowcov", "hash.bubbles",
            "hash.emit"} <= names


@pytest.fixture(scope="module")
def pe_runs(tmp_path_factory):
    """(untraced outdir, traced outdir, the traced run's records, the
    `[wall]` lines of each run) of one pe run each on the same reads,
    at verbosity 2."""
    base = tmp_path_factory.mktemp("pe_trace")
    reads = write_pairs(str(base))
    dirs = [base / "plain", base / "traced"]

    def run(outdir):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            pe.run(pe.PipelineParams(
                name="t", k=31, in_files=list(reads), bloom_bytes=8 << 20,
                outdir=str(outdir), min_pairs=5, verbose=2,
                batch_size=1024, max_read_len=128, device="cpu"))
        return [line.split("[wall] ")[1].rsplit(":", 1)[0]
                for line in err.getvalue().splitlines() if "[wall]" in line]

    trace.enable(False)
    walls = [run(dirs[0])]
    with trace.recording() as records:
        walls.append(run(dirs[1]))
    return dirs[0], dirs[1], records, walls


def test_traced_pe_writes_the_untraced_artifacts(pe_runs):
    plain, traced, _, walls = pe_runs
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(traced))
    assert "t-8.fa" in names and "t-stats.tab" in names
    for name in names:
        a, b = plain / name, traced / name
        if not a.is_symlink():
            assert a.read_bytes() == b.read_bytes(), name
    # the [wall] lines print traced or not, at pe's verbosity 2
    assert walls[0] == walls[1] == [
        "stage 1 (unitigs)", "stage 2-3 (graph)", "map", "DistanceEst",
        "stage 4-5 (map+dist)", "stage 6 (contigs)", "map",
        "stage 7-8 (scaffolds)", "sealer"]


def test_traced_pe_spans_nest(pe_runs):
    _, _, records, _ = pe_runs
    spans = [r for r in records if isinstance(r, trace.SpanRecord)]
    by_id = {r.id: r for r in spans}
    names = {r.name for r in spans}
    assert {"pe.unitigs", "pe.graph", "pe.dist", "pe.contigs",
            "pe.scaffolds", "pe.stats", "bloom.pass1", "bloom.walk_table",
            "bloom.pass2", "bloom.classify", "bloom.extend", "bloom.emit",
            "walk.resolve", "walk.stitch", "io.fastq_batch", "io.fasta_write",
            "graph.adjacency", "graph.rresolver", "graph.filtergraph",
            "graph.popbubbles", "graph.merge", "align.index", "align.reads",
            "align.vote", "align.fixmate",
            "scaffold.distest", "scaffold.paths", "scaffold.consensus",
            "scaffold.scaffolder", "scaffold.merge"} <= names
    assert "pe.sealer" not in names           # no sealer_ks: no stage
    # one job; every span inside its parent's interval
    assert {r.job for r in records} == {spans[0].job} and spans[0].job > 0
    for r in spans:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    parent = {r.name: by_id[r.parent].name for r in spans
              if r.parent is not None}
    assert parent["bloom.pass2"] == "pe.unitigs"
    assert parent["bloom.classify"] == "bloom.pass2"
    assert parent["walk.resolve"] == "bloom.extend"
    assert parent["align.vote"] == "align.reads"
    assert parent["scaffold.scaffolder"] == "pe.scaffolds"
    assert "pe.unitigs" not in parent
    counts = trace.counter_totals(records)
    assert counts["bloom.seeds"] >= counts["bloom.contigs"] > 0
    assert counts["walk.lane_steps"] >= counts["walk.bases"] > 0
    assert counts["walk.lanes"] > 0
    assert counts["align.mapped"] >= counts["align.chained"] >= 0
    assert counts["fixmate.pairs"] > 0 and "fixmate.links" in counts


def test_stage_unitigs_alone_is_a_job(tmp_path):
    reads = write_pairs(str(tmp_path), genome_len=2000, coverage=20)
    p = pe.PipelineParams(name="u", k=25, in_files=reads, engine="exact",
                          outdir=str(tmp_path), verbose=0, batch_size=512,
                          max_read_len=128, device="cpu")
    with trace.recording() as records:
        pe.stage_unitigs_1(p)
    jobs = {r.job for r in records}
    assert len(jobs) == 1 and jobs != {0}
    names = set(trace.span_seconds(records))
    assert {"io.fastq_batch", "io.fasta_write", "hash.count",
            "hash.emit"} <= names


PACKED_PAIR_SPANS = ["paired.count", "paired.kc_filter", "paired.probe",
                     "paired.trim", "paired.chains", "paired.emission"]


def test_packed_pair_engine_phases_are_spans(tmp_path):
    """pe's paired stage 1 at K <= 16: each phase of the packed engine a
    span, in order, none inside another and all in the job; the row,
    round and contig counters; the same name-1.fa untraced."""
    reads = write_pairs(str(tmp_path), genome_len=4000, coverage=30)

    def run(name):
        p = pe.PipelineParams(name=name, k=60, K=16, in_files=reads,
                              outdir=str(tmp_path), verbose=0,
                              max_read_len=128, device="cpu")
        with open(pe.stage_unitigs_1(p), "rb") as f:
            return f.read()

    plain = run("plain")
    assert trace.take() == []
    with trace.recording() as records:
        traced = run("traced")
    assert traced == plain
    spans = [r for r in records if isinstance(r, trace.SpanRecord)
             and r.name.startswith("paired.")]
    assert [r.name for r in spans] == PACKED_PAIR_SPANS
    jobs = {r.job for r in records}
    assert len(jobs) == 1 and jobs != {0}
    ids = {r.id for r in spans}
    assert all(r.parent not in ids for r in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    counts = trace.counter_totals(records)
    assert counts["paired.rows"] >= counts["paired.rows_kc"] > 0
    assert counts["paired.trim_rounds"] >= 1
    assert counts["paired.contigs"] == plain.count(b">") > 0
