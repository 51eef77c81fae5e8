"""The port's out-of-core sweep on a flat mesh (``parallel/stream_mesh.py``)
against the JAX package's, on the CPU: the JAX side runs on the 8 virtual
CPU devices of ``tests/conftest.py``, the port on D CPU shards
(``make_mesh(D, device="cpu")``, each step's epilogue the plain version of
K2). The problem is the JAX oracle's (``tests/test_stream_mesh.py``):
seeded numpy incidences, threshold 3, tile 16, stream blocks of 16–32
rows.

Tolerance 0: row_stats row by row, tile hits, tiles, pair lists (int32
[M, 3] or packed int64, in canonical (i, j) order), the trace's counts,
the pipeline's parity counters and labels, and the CLI's bytes.

Each JAX result is computed once (module cache), and torch runs on one
thread: at these sizes more threads only contend.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops import stream as jstream
from uniprot_kmer_based_clustering_tpu.parallel import make_mesh as jmesh
from uniprot_kmer_based_clustering_tpu.parallel import stream_mesh as jsm
from uniprot_kmer_based_clustering_tpu.utils.checkpoint import (
    CheckpointStore as JStore,
)
from uniprot_kmer_based_clustering_tpu_torch.ops import stream as tstream
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.parallel import stream_mesh as tsm
from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
    CheckpointStore as TStore,
)

THR = 3
BLOCK = 16
# trace keys both packages keep (the seconds differ by nature)
TRACE_KEYS = ("steps", "uploads", "launches", "bs", "g", "nbk", "d",
              "word_chunk", "vcap", "overflow", "scan_chunk", "balance",
              "pair_format", "groups_skipped")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _problem():
    """(incidence rows, cols, n, n_pad, w_pad, classes): 180 proteins over
    1,200 k-mers at density 0.06, three classes (tests/test_stream_mesh.py)."""
    rng = np.random.default_rng(11)
    n, k = 180, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    bs = pack_bitsets(rows, cols, n, k, row_multiple=16, word_multiple=128)
    classes = rng.integers(0, 3, n).astype(np.int32)
    return rows, cols, n, bs.n_pad, bs.w_pad, classes


def _weights():
    w_pad = _problem()[4]
    return np.random.default_rng(3).integers(1, 5, w_pad * 32).astype(
        np.int8)


def _kw(kw):
    kw = dict(kw)
    if kw.pop("weighted", False):
        kw["weights"] = _weights()
    return kw


@functools.lru_cache(maxsize=None)
def _jax(d, **kw):
    """The JAX mesh engine's result and trace on d virtual devices."""
    rows, cols, n, n_pad, w_pad, classes = _problem()
    out = jsm.sweep_extract_stream_mesh(
        jmesh(d), classes, n, THR, block=BLOCK,
        block_source=jstream.CSRBlockSource(rows, cols, n_pad, w_pad),
        **_kw(kw),
    )
    return out, dict(jsm.last_mesh_trace)


def _torch(d, **kw):
    rows, cols, n, n_pad, w_pad, classes = _problem()
    return tsm.sweep_extract_stream_mesh(
        tmesh.make_mesh(d, device="cpu"), classes, n, THR, block=BLOCK,
        block_source=tstream.CSRBlockSource(rows, cols, n_pad, w_pad),
        **_kw(kw),
    )


def _same(got, want):
    rs, th, (ti, tj, t), pairs = got
    rs_w, th_w, (ti_w, tj_w, t_w), pairs_w = want
    assert rs.dtype == np.int64 and np.array_equal(rs, np.asarray(rs_w))
    assert np.array_equal(th, np.asarray(th_w))
    assert np.array_equal(ti, ti_w) and np.array_equal(tj, tj_w)
    assert t == t_w
    pairs_w = np.asarray(pairs_w)
    assert pairs.dtype == pairs_w.dtype and pairs.shape == pairs_w.shape
    assert np.array_equal(pairs, pairs_w)


def _same_trace(want):
    got = tsm.last_mesh_trace
    for key in TRACE_KEYS:
        assert got.get(key) == want.get(key), key


def _check(d, **kw):
    want, trace = _jax(d, **kw)
    _same(_torch(d, **kw), want)
    _same_trace(trace)
    assert len(want[3]) > 0


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_stream_matches_jax_every_d(d):
    _check(d, bs=32)


@pytest.mark.parametrize("d", [2, 8])
def test_mesh_stream_multigroup_matches_jax(d):
    """max_group=1 under a 1 MiB budget per device: one stationary block a
    group, twelve groups, moving blocks materialized inside the rounds."""
    _check(d, bs=16, max_group=1, hbm_budget_bytes=1 << 20, scan_chunk=3)
    assert tsm.last_mesh_trace["g"] == 1
    assert tsm.last_mesh_trace["nbk"] == 12


@pytest.mark.parametrize("d,kw", [(2, dict(bs=32)), (4, dict(bs=16)),
                                  (3, dict(bs=16, max_group=7))])
def test_cooperative_stack_matches_jax(d, kw):
    """g > D: g rounds down to a multiple of D, and each shard builds
    gpd ≥ 2 blocks of the stack."""
    _check(d, **kw)
    tr = tsm.last_mesh_trace
    assert tr["g"] > d and tr["g"] % d == 0
    assert tr["gpd"] == tr["g"] // d >= 2


@pytest.mark.parametrize("d", [1, 4])
def test_mesh_stream_packed_matches_jax(d):
    _check(d, bs=32, pair_format="packed")
    assert tsm.last_mesh_trace["pair_format"] == "packed"


@pytest.mark.parametrize("d,pair_format", [(2, "arr3"), (4, "arr3"),
                                           (4, "packed")])
def test_capacity_miss_redo_matches_jax(d, pair_format):
    """cap=8 a shard: every shard overflows, and the grouped extractor
    redoes the pair list from the exact tile hits."""
    _check(d, bs=32, cap=8, pair_format=pair_format)
    assert tsm.last_mesh_trace["overflow"]


@pytest.mark.parametrize("d", [2, 4])
def test_weighted_matches_jax(d):
    _check(d, bs=32, weighted=True)


@pytest.mark.parametrize("d", [1, 4])
def test_include_same_matches_jax(d):
    _check(d, bs=32, cross_amr_only=False)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_segment_bounds_is_the_jax_packages(d):
    """Random step weights, as many as 40 blocks and as few as one (fewer
    blocks than devices leaves segments empty)."""
    rng = np.random.default_rng(d)
    for m in list(rng.integers(1, 40, 12)) + [1, d - 1 or 1]:
        w = rng.integers(1, 23, int(m)).astype(np.int64)
        got = tsm._segment_bounds(w, d)
        assert np.array_equal(got, jsm._segment_bounds(w, d))
        assert got[0] == 0 and got[-1] == m and (np.diff(got) >= 0).all()


@pytest.mark.parametrize("d", [1, 3])
def test_mesh_equals_the_single_device_engine(d):
    """The port's mesh engine against its own single-device one-pass
    engine at the same bs: the same tile grid, statistics and pairs."""
    rows, cols, n, n_pad, w_pad, classes = _problem()
    one = tstream.sweep_extract_stream(
        None, classes, n, THR, bs=32, block=BLOCK, device="cpu",
        block_source=tstream.CSRBlockSource(rows, cols, n_pad, w_pad),
    )
    _same(_torch(d, bs=32), one)


def test_refuses_a_mesh_that_is_not_flat():
    rows, cols, n, n_pad, w_pad, classes = _problem()
    src = tstream.CSRBlockSource(rows, cols, n_pad, w_pad)
    for mesh in (tmesh.make_mesh_2d(1, 2, device="cpu"),
                 tmesh.make_mesh(2, axis="k", device="cpu")):
        with pytest.raises(AssertionError, match="flat mesh"):
            tsm.sweep_extract_stream_mesh(mesh, classes, n, THR,
                                          block_source=src, bs=32,
                                          block=BLOCK)


def test_stream_block_must_be_a_tile_multiple():
    rows, cols, n, n_pad, w_pad, classes = _problem()
    with pytest.raises(ValueError, match="multiple of the tile"):
        tsm.sweep_extract_stream_mesh(
            tmesh.make_mesh(2, device="cpu"), classes, n, THR, bs=24,
            block=BLOCK,
            block_source=tstream.CSRBlockSource(rows, cols, n_pad, w_pad))


def test_staging_is_a_fresh_copy_per_shard():
    """Shards that share a device never share a buffer."""
    rows, cols, n, n_pad, w_pad, classes = _problem()
    src = tstream.CSRBlockSource(rows, cols, n_pad, w_pad)
    shards = tsm._stage(tmesh.make_mesh(3, device="cpu"), src,
                        np.resize(classes, n_pad), _weights(), 32,
                        n_pad // 32)
    for field in ("rows", "ranks", "valid", "bit", "wts"):
        ptrs = {getattr(sh, field).data_ptr() for sh in shards}
        assert len(ptrs) == 3, field
    assert len({sh.cls[0].data_ptr() for sh in shards}) == 3
    src.prepare(32, None, "cpu")
    a, b = shards[0].block(2, 32, w_pad), shards[2].block(2, 32, w_pad)
    assert torch.equal(a, b) and torch.equal(a, src.put(2))


def test_all_gather_and_lane_merge():
    mesh = tmesh.make_mesh(3, device="cpu")
    parts = [torch.full((2, 4), v, dtype=torch.int32) for v in range(3)]
    got = tmesh.all_gather(parts, mesh)
    assert len(got) == 3
    for g in got:
        assert torch.equal(g[:, 0], torch.tensor([0, 0, 1, 1, 2, 2],
                                                 dtype=torch.int32))
        assert all(g.data_ptr() != p.data_ptr() for p in parts)
    assert len({g.data_ptr() for g in got}) == 3
    rng = np.random.default_rng(0)
    rs = [torch.from_numpy(rng.integers(-5, 50, (6, 8)).astype(np.int32))
          for _ in range(3)]
    merged = tmesh.lane_merge_to_first(rs, mesh).numpy()
    stack = np.stack([r.numpy() for r in rs])
    want = stack.sum(0)
    want[:, [3, 7]] = stack[:, :, [3, 7]].max(0)
    assert np.array_equal(merged, want)
    assert merged.dtype == np.int32


RESUME = dict(bs=16, max_group=1, scan_chunk=3)


def _single_torch(store, key, **kw):
    rows, cols, n, n_pad, w_pad, classes = _problem()
    return tstream.sweep_extract_stream(
        None, classes, n, THR, bs=16, block=BLOCK, max_group=1,
        block_source=tstream.CSRBlockSource(rows, cols, n_pad, w_pad),
        checkpoint_store=store, checkpoint_key=key, device="cpu", **kw)


def _single_jax(store, key, **kw):
    rows, cols, n, n_pad, w_pad, classes = _problem()
    cls = np.full(n_pad, -1, np.int32)
    cls[:n] = classes
    return jstream.sweep_extract_stream(
        None, cls, n=n, threshold=THR, bs=16, block=BLOCK, max_group=1,
        block_source=jstream.CSRBlockSource(rows, cols, n_pad, w_pad),
        checkpoint_store=store, checkpoint_key=key, **kw)


def _mesh_jax(store, key, **kw):
    rows, cols, n, n_pad, w_pad, classes = _problem()
    return jsm.sweep_extract_stream_mesh(
        jmesh(4), classes, n, THR, block=BLOCK,
        block_source=jstream.CSRBlockSource(rows, cols, n_pad, w_pad),
        checkpoint_store=store, checkpoint_key=key, **RESUME, **kw)


def _mesh_torch(store, key, d=4, **kw):
    return _torch(d, checkpoint_store=store, checkpoint_key=key, **RESUME,
                  **kw)


RUNNERS = {"torch_mesh": _mesh_torch, "torch_single": _single_torch,
           "jax_mesh": _mesh_jax, "jax_single": _single_jax}


@pytest.mark.parametrize("writer,reader", [
    ("torch_mesh", "torch_mesh"),
    ("torch_mesh", "torch_single"),
    ("torch_single", "torch_mesh"),
    ("jax_mesh", "torch_mesh"),
    ("torch_mesh", "jax_mesh"),
    ("jax_single", "torch_mesh"),
    ("torch_mesh", "jax_single"),
])
def test_kill_and_resume(tmp_path, writer, reader):
    """The writer dies after 2 of 12 groups (the fault seam), the reader
    resumes its snapshot — within the mesh engine, across the
    single-device and mesh engines and across the packages, wherever
    (bs, g) agree — skips the 2 groups, equals an uninterrupted run, and
    removes the snapshot."""
    def store(pkg):
        return (JStore if pkg.startswith("jax") else TStore)(str(tmp_path))

    with pytest.raises(RuntimeError, match="fault injection"):
        RUNNERS[writer](store(writer), "k", fail_after_groups=2)
    snap = store(reader).load("k")
    assert snap is not None and len(snap["groups_done"]) == 2
    got = RUNNERS[reader](store(reader), "k")
    skipped = {"torch_mesh": tsm.last_mesh_trace,
               "jax_mesh": jsm.last_mesh_trace,
               "torch_single": tstream.last_onepass_trace,
               "jax_single": jstream.last_onepass_trace}[reader]
    assert skipped["groups_skipped"] == 2
    _same(tuple(np.asarray(x) if i != 2 else x for i, x in enumerate(got)),
          _jax(4, **RESUME)[0])
    assert store(reader).load("k") is None


def test_resume_across_mesh_sizes(tmp_path):
    """A D = 8 run killed after 3 groups resumes on D = 2."""
    store = TStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="fault injection"):
        _mesh_torch(store, "m", d=8, fail_after_groups=3)
    _same(_mesh_torch(store, "m", d=2), _jax(4, **RESUME)[0])
    assert tsm.last_mesh_trace["groups_skipped"] == 3


def _synth_fasta(path, n):
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(n, seed=3)
    with open(path, "w") as f:
        for i in range(n):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.mark.parametrize("corpus,d,extra", [
    ("toy", 2, {}),
    ("toy", 4, dict(weighting="blosum62", threshold=20)),
    ("synth", 2, {}),
    ("synth", 4, dict(cross_amr_only=False, extract_k=64)),
])
def test_run_pipeline_stream_on_a_flat_mesh_matches_jax(corpus, d, extra,
                                                        toy_fasta, tmp_path):
    """run_pipeline(engine="stream", stream_source="csr", mesh=D) against
    the JAX pipeline on its mesh: parity counters, pairs and labels
    (extract_k=64 is each shard's pair capacity: the synthetic corpus
    overflows it and redoes its pairs)."""
    from uniprot_kmer_based_clustering_tpu.config import (
        PipelineConfig as JConfig,
    )
    from uniprot_kmer_based_clustering_tpu.pipeline import (
        run_pipeline as jrun,
    )
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        run_pipeline as trun,
    )

    fasta = toy_fasta if corpus == "toy" else _synth_fasta(
        tmp_path / "s.fasta", 400)
    kw = dict(dict(threshold=3, tile=16, word_block=128, engine="stream",
                   stream_source="csr"), **extra)
    want = jrun(fasta, JConfig(**kw), mesh=jmesh(d))
    got = trun(fasta, PipelineConfig(**kw), None, tmesh.make_mesh(
        d, device="cpu"))
    assert got.parity_report() == want.parity_report()
    assert np.array_equal(got.pairwise.pairs, want.pairwise.pairs)
    assert np.array_equal(got.cluster_labels, want.cluster_labels)
    assert len(got.pairwise.pairs) > 0
    assert tsm.last_mesh_trace["d"] == d
    assert tsm.last_mesh_trace["overflow"] == ("extract_k" in extra)


def _cli_outputs(out):
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(out, "pairs.tsv"), "rb") as f:
        pairs = f.read()
    with open(os.path.join(out, "clusters.tsv"), "rb") as f:
        clusters = f.read()
    return stats, pairs, clusters


@pytest.mark.parametrize("flags", [
    ["--devices", "2"],
    ["--devices", "4", "--all-pairs", "--threshold", "3"],
])
def test_cli_stream_on_a_flat_mesh_matches_jax_cli(toy_fasta, tmp_path,
                                                   capsys, flags):
    """`cli run --devices N --engine stream --stream-source csr --extract
    onepass --device cpu` against the JAX CLI's `--cpu`: pairs.tsv and
    clusters.tsv byte for byte; stats.json's parity, clusters, n_devices
    and stage names."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    stream = ["--engine", "stream", "--stream-source", "csr", "--extract",
              "onepass", *flags]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout, *stream]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout,
                  *stream]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    js, jp, jc = _cli_outputs(jout)
    ts, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts["parity"] == js["parity"] and ts["clusters"] == js["clusters"]
    assert ts["n_devices"] == js["n_devices"] == int(flags[1])
    assert set(ts["timings_s"]) == set(js["timings_s"])
    assert ts["parity"]["pairs_over_threshold"] > 0
    assert tsm.last_mesh_trace["d"] == int(flags[1])
