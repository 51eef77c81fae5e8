"""The port's multi-process mesh (``cli run --distributed``) on the CPU:
``torch.distributed`` worlds over gloo, each rank with its own CPU
shards, held against the JAX package's single-process functions on the
8 virtual CPU devices of ``tests/conftest.py`` with tolerance 0 (row
statistics row by row, tile hits, pair lists in (i, j) order, labels,
CLI files byte for byte), and every rank against every other.

A module fixture starts ONE world of 2 ranks × 2 CPU shards (D = 4)
that runs every scenario in a single launch and saves each rank's
outputs; a second fixture a world of 3 ranks × 1 shard (an odd ring).
The parametrised cases read those outputs, so the file costs two
launches. The worker is this file itself, run as ``python
tests/test_torch_distributed.py RANK WORLD PORT SHARDS OUT FASTA`` with
the repository root on PYTHONPATH; it imports neither JAX nor the JAX
package.

A kernel launch is counted only on a card, so the workers count the
calls of K1's and K2's wrappers instead: summed over the ranks they must
equal the one-process schedule's counts.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

THR = 4
TOY = dict(engine="mxu", tile=16, strip=32, threshold=2)
STREAM_BLOCK = 16
RESUME = dict(bs=16, max_group=1, scan_chunk=3)
WORKER_TIMEOUT = 300  # seconds; a launch takes ~20-40 s on one process
# the CLI flags of each distributed run (port) and its JAX counterpart
CLI_CASES = {
    "flat": (["--devices", "4"], ["--devices", "4"]),
    "rank_cards": ([], ["--devices", "2"]),
    "mesh_2x2": (["--mesh-shape", "2x2"], ["--mesh-shape", "2x2"]),
    "kmers": (["--devices", "4", "--shard-axis", "kmers"],
              ["--devices", "4", "--shard-axis", "kmers"]),
    "stream_csr": (["--devices", "4", "--engine", "stream",
                    "--stream-source", "csr", "--extract", "onepass"],
                   ["--devices", "4", "--engine", "stream",
                    "--stream-source", "csr", "--extract", "onepass"]),
}
CLI_COMMON = ["--engine", "mxu", "--threshold", "2"]


# -- inputs (numpy, seeded; the same in the workers and here) ----------------

def _problem(n_pad, seed=5):
    """The JAX ring tests' problem: 500 proteins over 1,500 k-mers at
    density 0.04, rows padded to ``n_pad``, classes 0..3 and -1 past n."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
        pack_bitsets,
    )

    rng = np.random.default_rng(seed)
    n, k = 500, 1500
    rows, cols = np.nonzero(rng.random((n, k)) < 0.04)
    bs = pack_bitsets(rows.astype(np.int32), cols.astype(np.int32), n, k,
                      row_multiple=n_pad, word_multiple=128)
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:n] = rng.integers(0, 4, n)
    return bs, classes, n


def _weights(bs):
    return np.random.default_rng(17).integers(
        1, 50, size=bs.w_pad * 32).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _stream_problem():
    """180 proteins over 1,200 k-mers at density 0.06, three classes (the
    stream-mesh tests' problem)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
        pack_bitsets,
    )

    rng = np.random.default_rng(11)
    n, k = 180, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    bs = pack_bitsets(rows, cols, n, k, row_multiple=16, word_multiple=128)
    classes = rng.integers(0, 3, n).astype(np.int32)
    return rows, cols, n, bs.n_pad, bs.w_pad, classes


def _edges(seed, n=400, m=250):
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    return np.stack([np.minimum(i, j), np.maximum(i, j),
                     np.ones_like(i)], 1).astype(np.int32), n


def _doc_freq_inputs():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 21 ** 5, (32, 36)).astype(np.int32)
    valid = rng.random((32, 36)) < 0.8
    return codes, valid


def _collective_inputs(d):
    """Per shard: a [4, 3] block, a block of i + 1 rows (unequal
    gathers) and [6, 8] row statistics."""
    rng = np.random.default_rng(31)
    blocks = [torch.from_numpy(rng.integers(-50, 50, (4, 3))
                               .astype(np.int32)) for _ in range(d)]
    ragged = [torch.full((i + 1, 2), i, dtype=torch.int64)
              for i in range(d)]
    stats = [torch.from_numpy(rng.integers(0, 99, (6, 8)).astype(np.int32))
             for _ in range(d)]
    return blocks, ragged, stats


def _collectives(mesh, tmesh, device="cpu"):
    """Every collective on ``mesh`` (inputs on ``device``): {name: [entry
    per shard, None where not this rank's]} or {name: tensor} for a
    replicated result."""
    d = mesh.size
    blocks, ragged, stats = ([t.to(device) for t in ts]
                             for ts in _collective_inputs(d))

    def mine(xs):
        return [x if i in mesh.local else None for i, x in enumerate(xs)]

    out = {}
    for name, axis in (("ring_flat", None), ("ring_h", "h"),
                       ("ring_c", "c")):
        m = mesh if axis is None else tmesh.Mesh(
            mesh.devices, ("h", "c"), (2, d // 2),
            ranks=mesh.ranks if mesh.multiprocess else None)
        before = mine(blocks)
        got = tmesh.ring_shift(list(before), m, axis)
        fresh = all(got[i].data_ptr() not in
                    {b.data_ptr() for b in blocks} for i in m.local)
        out[name] = got
        out[name + "_fresh"] = torch.tensor(fresh)
    out["gather"] = tmesh.gather_to_first(mine(ragged), mesh)
    out["sum"] = tmesh.sum_to_first(mine(blocks), mesh)
    out["min"] = tmesh.min_to_first(mine(blocks), mesh)
    out["lane"] = tmesh.lane_merge_to_first(mine(stats), mesh)
    out["all_gather"] = tmesh.all_gather(mine(blocks), mesh)
    out["broadcast"] = tmesh.broadcast_from_first(
        blocks[0] + 100 * mesh.rank, mesh)
    return out


# -- the worker ---------------------------------------------------------------

class _Count:
    """A wrapper that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _scenarios(rank, world, shards, out_dir, fasta):
    """(name, fn) of every scenario of a world; fn returns a dict of
    arrays, numbers or strings."""
    from uniprot_kmer_based_clustering_tpu_torch import cli, pipeline
    from uniprot_kmer_based_clustering_tpu_torch.config import (
        PipelineConfig,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components_sharded,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops import stream as tstream
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        sharded as tsh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        stream_mesh as tsm,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.query import (
        QueryServer,
    )
    from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
        CheckpointStore,
    )

    d = world * shards
    k1 = tsh.stats_from_counts_into = _Count(tsh.stats_from_counts_into)
    k2 = tstream.stats_from_counts_traced_into = _Count(
        tstream.stats_from_counts_traced_into)

    def flat():
        return tmesh.make_mesh(d, device="cpu")

    def counted(fn):
        k1.calls = k2.calls = 0
        out = fn()
        return out, k1.calls, k2.calls

    def sweep_dict(res, k1_calls):
        rs, th, (ti, tj, t) = res[:3]
        out = dict(row_stats=rs, tile_hits=th, ti=ti, tj=tj, tile=t,
                   k1=k1_calls)
        if len(res) == 4:
            out["pairs"] = res[3]
        return out

    def ring(layout):
        n_pad = 1024 if d % 4 == 0 else d * 256
        bs, classes, n = _problem(n_pad)
        mesh = {"flat": flat,
                "2d": lambda: tmesh.make_mesh_2d(2, d // 2, device="cpu"),
                "kaxis": lambda: tmesh.make_mesh(d, axis="k",
                                                 device="cpu")}[layout]()
        sweep = {"flat": tsh.sharded_pairwise_similarity,
                 "2d": tsh.sharded_pairwise_similarity_2d,
                 "kaxis": tsh.sharded_pairwise_similarity_kaxis}[layout]
        res, c1, _ = counted(lambda: sweep(mesh, bs.words, classes, n, THR,
                                           block_tile=128))
        out = {f"sweep/{k}": v for k, v in sweep_dict(res, c1).items()}
        pairs, c1, _ = counted(lambda: tsh.sharded_extract_pairs(
            mesh, bs.words, classes, n, THR, block_tile=128))
        out.update({"extract/pairs": pairs, "extract/k1": c1})
        res, c1, _ = counted(lambda: tsh.sharded_pairwise_fused(
            mesh, bs.words, classes, n, THR, block_tile=128))
        out.update({f"fused/{k}": v for k, v in sweep_dict(res, c1).items()})
        if layout == "flat" and d == 4:
            res = sweep(mesh, bs.words, classes, n, 40, block_tile=128,
                        weights=_weights(bs))
            out.update({f"weighted/{k}": v
                        for k, v in sweep_dict(res, 0).items()})
            for name, kw in (("overflow", dict(cap=64, threshold=0)),
                             ("shortfall", dict(tile_cap=1,
                                                expected_total=len(pairs)))):
                kw.setdefault("threshold", THR)
                try:
                    tsh.sharded_extract_pairs(mesh, bs.words, classes, n,
                                              block_tile=128, **kw)
                    out[f"{name}/raised"] = ""
                except ValueError as e:
                    out[f"{name}/raised"] = str(e)
            got = tsh.sharded_extract_pairs(
                mesh, bs.words, classes, n, THR,
                tile_cap=int(out["sweep/tile_hits"][:, 0].max()),
                expected_total=len(pairs))
            out["tile_cap/pairs"] = got
        return out

    def stream():
        rows, cols, n, n_pad, w_pad, classes = _stream_problem()
        mesh = flat()

        def run(**kw):
            return tsm.sweep_extract_stream_mesh(
                mesh, classes, n, THR, block=STREAM_BLOCK,
                block_source=tstream.CSRBlockSource(rows, cols, n_pad, w_pad),
                **kw)

        res, _, c2 = counted(lambda: run(bs=32))
        out = {f"onepass/{k}": v for k, v in sweep_dict(res, 0).items()}
        out["onepass/k2"] = c2
        out["onepass/steps"] = tsm.last_mesh_trace["steps"]
        store = CheckpointStore(os.path.join(out_dir, "ckpt"))
        try:
            run(checkpoint_store=store, checkpoint_key="k",
                fail_after_groups=2, **RESUME)
            out["kill/raised"] = ""
        except RuntimeError as e:
            out["kill/raised"] = str(e)
        snap = store.load("k")
        out["kill/groups_done"] = (np.array([-1]) if snap is None
                                   else snap["groups_done"])
        res, _, c2 = counted(lambda: run(checkpoint_store=store,
                                         checkpoint_key="k", **RESUME))
        out.update({f"resume/{k}": v for k, v in sweep_dict(res, 0).items()})
        out["resume/skipped"] = tsm.last_mesh_trace["groups_skipped"]
        out["resume/k2"] = c2
        tmesh.barrier(mesh)
        out["resume/snapshot_left"] = store.load("k") is not None
        return out

    def components():
        pairs, n = _edges(d)
        return {"labels": connected_components_sharded(flat(), pairs, n)}

    def doc_freq():
        codes, valid = _doc_freq_inputs()
        return {"freq": tsh.doc_freq_psum(flat(), codes, valid, 5).numpy()}

    def run_pipeline():
        out = {}
        cfgs = {"flat": (flat(), PipelineConfig(**TOY)),
                "stream_csr": (flat(), PipelineConfig(
                    engine="stream", stream_source="csr", extract="onepass",
                    tile=16, threshold=2))}
        for name, (mesh, cfg) in cfgs.items():
            res = pipeline.run_pipeline(
                fasta, cfg, checkpoint_dir=os.path.join(out_dir,
                                                        "pipe_" + name),
                mesh=mesh)
            out[f"{name}/pairs"] = res.pairwise.pairs
            out[f"{name}/labels"] = res.cluster_labels
            out[f"{name}/parity"] = json.dumps(res.parity_report())
        return out

    def cli_runs():
        out = {}
        cases = CLI_CASES if world == 2 else {"rank_cards": ([], None)}
        for name, (flags, _) in cases.items():
            dst = os.path.join(out_dir, f"cli_{name}_rank{rank}")
            rc = cli.main(["run", fasta, "--distributed", "--device", "cpu",
                           "--out", dst, *CLI_COMMON, *flags])
            out[f"{name}/rc"] = rc
            out[f"{name}/wrote"] = os.path.exists(dst)
            for f in ("pairs.tsv", "clusters.tsv"):
                if os.path.exists(os.path.join(dst, f)):
                    with open(os.path.join(dst, f), "rb") as fh:
                        out[f"{name}/{f}"] = fh.read().decode()
        return out

    def refusals():
        out = {}
        for name, fn in (
            ("mesh_2d_chips", lambda: tmesh.make_mesh_2d(4, 1,
                                                         device="cpu")),
            ("mesh_too_many", lambda: tmesh.make_mesh(
                8, devices=["cpu", "cpu"])),
            ("cpu_shards", lambda: tmesh.make_mesh(2 * world + 1,
                                                   device="cpu")),
            ("query_server", lambda: QueryServer(None, None, mesh=flat())),
            ("rank_without_card", lambda: tmesh.make_mesh(device="cuda")),
        ):
            try:
                fn()
                out[name] = ""
            except (ValueError, RuntimeError) as e:
                out[name] = str(e)
        return out

    def collectives():
        mesh = flat()
        out = {}
        for name, v in _collectives(mesh, tmesh).items():
            if isinstance(v, list):
                for i in mesh.local:
                    out[f"{name}/{i}"] = v[i].numpy()
            else:
                out[name] = v.numpy()
        out["transport_bytes"] = tmesh.reset_transport_stats()["bytes"]
        return out

    common = [("collectives", collectives), ("flat", lambda: ring("flat")),
              ("components", components), ("cli", cli_runs)]
    if world == 3:
        return common
    return common + [
        ("2d", lambda: ring("2d")), ("kaxis", lambda: ring("kaxis")),
        ("stream", stream), ("doc_freq", doc_freq),
        ("pipeline", run_pipeline), ("refusals", refusals),
    ]


def _worker(rank, world, port, shards, out_dir, fasta, scenarios=None):
    """One rank: joins a gloo world, runs every scenario of ``scenarios``
    (this file's by default), records each one's outputs or its
    traceback, and writes them to ``out_dir/rank{rank}.json``."""
    import torch.distributed as dist

    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        init_distributed,
    )

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    init_distributed(backend="gloo")  # a second call keeps the group
    results = {}
    for name, fn in (scenarios or _scenarios)(rank, world, shards, out_dir,
                                              fasta):
        try:
            for key, value in fn().items():
                results[f"{name}/{key}"] = value
        except Exception:
            results[f"{name}/error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({k: _jsonable(v) for k, v in results.items()}, f)
    dist.barrier()
    dist.destroy_process_group()


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return {"dtype": str(v.dtype), "shape": list(v.shape),
                "data": v.reshape(-1).tolist()}
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


def _from_json(v):
    if isinstance(v, dict) and "dtype" in v:
        return np.array(v["data"], dtype=v["dtype"]).reshape(v["shape"])
    return v


# -- the launches ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(tmp_path, world, shards, fasta, script=__file__):
    """Start ``world`` worker processes (``python script``) and wait;
    returns each rank's results. A worker that fails or outlives its
    timeout fails the fixture (every worker is killed)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), str(r),
         str(world), str(port), str(shards), str(tmp_path), fasta],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(
                errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"distributed worker timed out after "
                        f"{WORKER_TIMEOUT} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp_path, f"rank{r}.json")) as f:
            out.append({k: _from_json(v) for k, v in json.load(f).items()})
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory, toy_fasta):
    return _launch(tmp_path_factory.mktemp("world2"), 2, 2, toy_fasta)


@pytest.fixture(scope="module")
def world3(tmp_path_factory, toy_fasta):
    return _launch(tmp_path_factory.mktemp("world3"), 3, 1, toy_fasta)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _get(ranks, scenario, key):
    """``scenario/key`` of every rank, which must all be equal (none may
    have failed); returns rank 0's."""
    for r in ranks:
        assert f"{scenario}/error" not in r, r[f"{scenario}/error"]
    vals = [r[f"{scenario}/{key}"] for r in ranks]
    for v in vals[1:]:
        if isinstance(v, np.ndarray):
            assert v.dtype == vals[0].dtype and np.array_equal(v, vals[0])
        else:
            assert v == vals[0]
    return vals[0]


# -- the JAX package's single-process results ---------------------------------

def _jmesh(layout, d):
    from uniprot_kmer_based_clustering_tpu import parallel as jpar

    if layout == "2d":
        return jpar.make_mesh_2d(2, d // 2)
    return jpar.make_mesh(d, axis="k" if layout == "kaxis" else "p")


@functools.lru_cache(maxsize=None)
def _jax_ring(layout, d, what):
    from uniprot_kmer_based_clustering_tpu import parallel as jpar

    bs, classes, n = _problem(1024 if d % 4 == 0 else d * 256)
    mesh = _jmesh(layout, d)
    if what == "extract":
        return jpar.sharded_extract_pairs(mesh, bs.words, classes, n, THR,
                                          block_tile=128)
    if what == "fused":
        return jpar.sharded_pairwise_fused(mesh, bs.words, classes, n, THR,
                                           block_tile=128)
    sweep = {"flat": jpar.sharded_pairwise_similarity,
             "2d": jpar.sharded_pairwise_similarity_2d,
             "kaxis": jpar.sharded_pairwise_similarity_kaxis}[layout]
    if what == "weighted":
        return sweep(mesh, bs.words, classes, n, 40, block_tile=128,
                     weights=_weights(bs))
    return sweep(mesh, bs.words, classes, n, THR, block_tile=128)


@functools.lru_cache(maxsize=None)
def _jax_stream(**kw):
    from uniprot_kmer_based_clustering_tpu.ops import stream as jstream
    from uniprot_kmer_based_clustering_tpu.parallel import stream_mesh as jsm

    rows, cols, n, n_pad, w_pad, classes = _stream_problem()
    out = jsm.sweep_extract_stream_mesh(
        _jmesh("flat", 4), classes, n, THR, block=STREAM_BLOCK,
        block_source=jstream.CSRBlockSource(rows, cols, n_pad, w_pad), **kw)
    return out, dict(jsm.last_mesh_trace)


def _same_sweep(ranks, scenario, want):
    rs, th, (ti, tj, t) = want[:3]
    got = _get(ranks, scenario, "row_stats")
    assert got.dtype == np.int64 and np.array_equal(got, np.asarray(rs))
    assert np.array_equal(_get(ranks, scenario, "tile_hits"),
                          np.asarray(th))
    assert np.array_equal(_get(ranks, scenario, "ti"), ti)
    assert np.array_equal(_get(ranks, scenario, "tj"), tj)
    assert _get(ranks, scenario, "tile") == t
    assert np.asarray(th)[:, 0].sum() > 0
    if len(want) == 4:
        pairs = _get(ranks, scenario, "pairs")
        assert len(pairs) > 0 and np.array_equal(pairs, np.asarray(want[3]))


def _k1_total(ranks, scenario):
    for r in ranks:
        assert f"{scenario.split('/')[0]}/error" not in r
    return sum(r[f"{scenario}/k1"] for r in ranks)


# -- the cases ---------------------------------------------------------------

COLLECTIVES = ["ring_flat", "ring_h", "ring_c", "gather", "sum", "min",
               "lane", "all_gather", "broadcast"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_one_process(world2, name):
    """Each collective across 2 ranks × 2 shards equals the one-process
    4-shard mesh's result: a shard list entry by entry (each rank holding
    its own), a replicated result on every rank; ring shifts give fresh
    buffers."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh

    want = _collectives(tmesh.make_mesh(4, device="cpu"), tmesh)[name]
    if isinstance(want, list):
        # entry by entry, each rank holding only its own shards' (the
        # broadcast: rank 1 passed a different tensor and holds rank 0's)
        for r, ranks in enumerate(world2):
            assert "collectives/error" not in ranks, ranks["collectives/error"]
            for i in range(4):
                key = f"collectives/{name}/{i}"
                if i // 2 != r:
                    assert key not in ranks
                    continue
                assert np.array_equal(ranks[key], want[i].numpy()), (r, i)
    else:
        assert np.array_equal(_get(world2, "collectives", name),
                              want.numpy())
    if name.startswith("ring"):
        assert _get(world2, "collectives", name + "_fresh")
    assert all(r["collectives/transport_bytes"] > 0 for r in world2)


@pytest.mark.parametrize("layout", ["flat", "2d", "kaxis"])
def test_sweep_matches_jax(world2, layout):
    """The sweep on 2 ranks × 2 shards (flat ring, 2-D 2 × 2 with the host
    axis across ranks, k axis) = the JAX single-process sweep row by row,
    on every rank."""
    _same_sweep(world2, f"{layout}/sweep", _jax_ring(layout, 4, "sweep"))


@pytest.mark.parametrize("layout", ["flat", "2d", "kaxis"])
def test_extract_matches_jax(world2, layout):
    pairs = _get(world2, f"{layout}/extract", "pairs")
    assert pairs.dtype == np.int32 and len(pairs) > 1000
    assert np.array_equal(pairs, _jax_ring(layout, 4, "extract"))


@pytest.mark.parametrize("layout", ["flat", "2d", "kaxis"])
def test_fused_matches_jax(world2, layout):
    _same_sweep(world2, f"{layout}/fused", _jax_ring(layout, 4, "fused"))


@pytest.mark.parametrize("layout", ["flat", "2d", "kaxis"])
def test_k1_calls_summed_over_ranks_are_the_schedules(world2, layout):
    """K1's wrapper runs once a sub-step of each rank's own shards, or
    once a k-axis strip on the first shard's rank: summed over the ranks,
    the one-process schedule's count, in the sweep and the fused pass;
    the extraction runs none."""
    from uniprot_kmer_based_clustering_tpu_torch import parallel as tpar

    want = {"flat": tpar.count_substeps(4, 1024),
            "2d": tpar.count_substeps_2d(2, 2, 1024),
            "kaxis": tpar.count_kaxis_strips(4, 1024)}[layout]
    assert _k1_total(world2, f"{layout}/sweep") == want
    assert _k1_total(world2, f"{layout}/fused") == want
    assert _k1_total(world2, f"{layout}/extract") == 0
    per_rank = [r[f"{layout}/sweep/k1"] for r in world2]
    if layout == "kaxis":
        assert per_rank[1] == 0
    else:
        assert min(per_rank) > 0


def test_weighted_flat_sweep_matches_jax(world2):
    _same_sweep(world2, "flat/weighted", _jax_ring("flat", 4, "weighted"))


def test_extract_raises_on_every_rank(world2):
    """A cap below the survivors (overflow) and a tile_cap below the
    densest tile (shortfall) raise the one-process messages on both
    ranks; the densest tile's tile_cap is exact."""
    assert "overflow" in _get(world2, "flat", "overflow/raised")
    assert "sweep stats promised" in _get(world2, "flat", "shortfall/raised")
    assert np.array_equal(_get(world2, "flat", "tile_cap/pairs"),
                          _jax_ring("flat", 4, "extract"))


def test_stream_mesh_onepass_matches_jax(world2):
    """The out-of-core one pass on 2 ranks × 2 shards = the JAX
    single-process mesh engine; K2's calls summed over the ranks are its
    steps."""
    want, trace = _jax_stream(bs=32)
    _same_sweep(world2, "stream/onepass", want)
    total = sum(r["stream/onepass/k2"] for r in world2)
    assert total == trace["steps"] > 0
    assert sum(r["stream/onepass/steps"] for r in world2) == trace["steps"]


def test_stream_mesh_kill_and_resume(world2):
    """Killed after 2 groups, every rank raises; rank 0's snapshot (2
    groups) is read by both ranks, the resume skips the 2 groups, equals
    an uninterrupted JAX run and removes the snapshot."""
    assert "fault injection" in _get(world2, "stream", "kill/raised")
    assert len(_get(world2, "stream", "kill/groups_done")) == 2
    assert _get(world2, "stream", "resume/skipped") == 2
    _same_sweep(world2, "stream/resume", _jax_stream(**RESUME)[0])
    assert not _get(world2, "stream", "resume/snapshot_left")


@pytest.mark.parametrize("world", ["world2", "world3"])
def test_components_sharded_matches_jax(request, world):
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components_sharded as jcc,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
    )

    ranks = request.getfixturevalue(world)
    d = 4 if world == "world2" else 3
    pairs, n = _edges(d)
    got = _get(ranks, "components", "labels")
    assert got.dtype == np.int32 and len(np.unique(got)) < n
    assert np.array_equal(got, connected_components(n, pairs))
    assert np.array_equal(got, jcc(_jmesh("flat", d), pairs, n))


def test_doc_freq_psum_matches_jax(world2):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uniprot_kmer_based_clustering_tpu import parallel as jpar

    codes, valid = _doc_freq_inputs()
    jm = jpar.make_mesh(4)
    want = np.asarray(jpar.doc_freq_psum(
        jm, jax.device_put(codes, NamedSharding(jm, P("p", None))),
        jax.device_put(valid, NamedSharding(jm, P("p", None))), 5))
    got = _get(world2, "doc_freq", "freq")
    assert want.sum() > 0 and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["flat", "stream_csr"])
def test_run_pipeline_matches_jax(world2, toy_fasta, name):
    """run_pipeline on the toy FASTA over 2 ranks × 2 shards (two-pass
    flat ring; packless out-of-core one pass) = the JAX pipeline on its
    4-device mesh: pairs, parity counters, labels."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    cfg = (PipelineConfig(**TOY) if name == "flat" else PipelineConfig(
        engine="stream", stream_source="csr", extract="onepass", tile=16,
        threshold=2))
    want = run_pipeline(toy_fasta, cfg, mesh=_jmesh("flat", 4))
    pairs = _get(world2, "pipeline", f"{name}/pairs")
    assert len(pairs) > 0 and np.array_equal(pairs, want.pairwise.pairs)
    assert np.array_equal(_get(world2, "pipeline", f"{name}/labels"),
                          want.cluster_labels)
    assert json.loads(_get(world2, "pipeline", f"{name}/parity")) == \
        want.parity_report()


@functools.lru_cache(maxsize=None)
def _jax_cli(fasta, flags, out):
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain

    assert jmain(["run", fasta, "--cpu", "--out", out, *CLI_COMMON,
                  *flags]) == 0
    files = {}
    for f in ("pairs.tsv", "clusters.tsv"):
        with open(os.path.join(out, f), "rb") as fh:
            files[f] = fh.read().decode()
    return files


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_run_distributed_matches_jax_cli(world2, toy_fasta,
                                             tmp_path_factory, name):
    """`cli run --distributed --device cpu` on 2 ranks: every rank exits
    0, rank 0 writes pairs.tsv and clusters.tsv byte-equal to the JAX
    CLI's on the same mesh in one process, and rank 1 writes nothing."""
    jflags = tuple(CLI_CASES[name][1])
    want = _jax_cli(toy_fasta, jflags,
                    str(tmp_path_factory.mktemp("jax_cli") / name))
    assert _get(world2, "cli", f"{name}/rc") == 0
    r0, r1 = world2
    assert r0[f"cli/{name}/wrote"] and not r1[f"cli/{name}/wrote"]
    for f in ("pairs.tsv", "clusters.tsv"):
        assert r0[f"cli/{name}/{f}"] == want[f]
    assert want["pairs.tsv"].count("\n") > 1


def test_cli_run_distributed_odd_world(world3, toy_fasta, tmp_path_factory):
    """Three ranks with one CPU shard each (D = 3) = the JAX CLI's
    ``--devices 3``; only rank 0 writes."""
    want = _jax_cli(toy_fasta, ("--devices", "3"),
                    str(tmp_path_factory.mktemp("jax_cli3")))
    assert _get(world3, "cli", "rank_cards/rc") == 0
    assert [r["cli/rank_cards/wrote"] for r in world3] == [True, False,
                                                            False]
    for f in ("pairs.tsv", "clusters.tsv"):
        assert world3[0][f"cli/rank_cards/{f}"] == want[f]


@pytest.mark.parametrize("what", ["sweep", "extract", "fused"])
def test_odd_ring_matches_jax(world3, what):
    """The flat ring on 3 ranks × 1 shard (D = 3: no split final step)."""
    from uniprot_kmer_based_clustering_tpu_torch import parallel as tpar

    want = _jax_ring("flat", 3, what)
    if what == "extract":
        pairs = _get(world3, "flat/extract", "pairs")
        assert len(pairs) > 1000 and np.array_equal(pairs, want)
        return
    _same_sweep(world3, f"flat/{what}", want)
    assert _k1_total(world3, f"flat/{what}") == tpar.count_substeps(3, 768)


def test_make_mesh_refusals(world2):
    """make_mesh_2d's multi-process check raises the JAX package's
    message (n_chips must be each process's device count); too many
    shards raise JAX's "requested N devices"; CPU shards must divide over
    the ranks."""
    assert _get(world2, "refusals", "mesh_2d_chips") == (
        "n_chips=1 must equal the per-process device count (2) on a "
        "multi-host mesh")
    assert _get(world2, "refusals", "mesh_too_many") == (
        "requested 8 devices, only 4 available")
    assert _get(world2, "refusals", "cpu_shards") == (
        "5 CPU shards do not divide over 2 ranks")


def test_query_server_refuses_a_multi_process_mesh(world2):
    assert ("the JAX package does not serve over a mesh of several "
            "processes") in _get(world2, "refusals", "query_server")


def test_a_rank_without_a_card_raises(world2):
    """A CUDA mesh on a rank that sees no card raises; it never runs on
    the CPU."""
    assert "no CUDA GPU" in _get(world2, "refusals", "rank_without_card")


def test_init_distributed_refuses_without_its_inputs(monkeypatch, tmp_path,
                                                     toy_fasta):
    """With no arguments init_distributed needs the torchrun environment
    (the CLI's --distributed too, before writing anything); NCCL without
    a card raises and never falls back to gloo."""
    import torch.distributed as dist

    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        init_distributed,
    )

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun environment"):
        init_distributed()
    with pytest.raises(ValueError, match="torchrun environment"):
        tmain(["run", toy_fasta, "--device", "cpu", "--distributed",
               "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            init_distributed(f"localhost:{_free_port()}", 1, 0)
    assert not dist.is_initialized()


if __name__ == "__main__":
    r, w, p, s, out, fasta = sys.argv[1:7]
    _worker(int(r), int(w), int(p), int(s), out, fasta)
