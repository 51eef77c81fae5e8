"""The port's serving bench (``benches/query.py``, ``bench_query.py``'s
counterpart) on the CPU against the JAX package.

The bench runs on the CPU (``UKC_BENCH_DEVICE=cpu``) over
``synth_proteins(300, seed=0)``; its servers' answers are held to the
JAX ``QueryServer(mode="host")`` (the rank-CSR walk) on the same seeded
corpus, and its line's keys to the JAX script's record. Tolerance 0.
Torch runs on one thread and each JAX result is computed once.
"""

import ast
import functools
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.kmers import build_index as jbuild_index
from uniprot_kmer_based_clustering_tpu.kmers import encode_kmers as jencode
from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets as jpack
from uniprot_kmer_based_clustering_tpu.similarity import (
    QueryServer as JQueryServer,
)
from uniprot_kmer_based_clustering_tpu_torch.benches import common, query

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("UKC_BENCH_", "UKC_QUERY_")
CPU = torch.device("cpu")
N = 300
PORT_FIELDS = {"power_limit_w", "kernels"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(KNOBS):
            monkeypatch.delenv(k)
    monkeypatch.setenv("UKC_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("UKC_BENCH_N", str(N))
    return monkeypatch


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@functools.lru_cache(maxsize=None)
def _jax_answers(n: int = N):
    """The JAX host server's answers to every corpus protein."""
    corpus = common.Corpus(*common.synth_proteins(n, seed=0), "", None)
    codes, koff = jencode(corpus.seq_buf, corpus.offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=512)
    seqs = [corpus.seq(i) for i in range(n)]
    return JQueryServer(idx, bs, mode="host").query(seqs, threshold=10)


@functools.lru_cache(maxsize=None)
def _servers(mesh_devices: int = 0):
    return query.build_servers(CPU, mesh_devices)


def _all_seqs(table):
    return [table.seq(i) for i in range(table.n)]


@pytest.mark.parametrize("which", ["device", "host", "mesh4"])
def test_servers_answer_as_the_jax_host_walk(bench_env, which):
    """Every corpus protein as a query: the bench's device server, its
    host server and the probe's mesh server (4 CPU shards) answer as the
    JAX host server does."""
    table, _, srv, host = _servers(4 if which == "mesh4" else 0)
    assert table.label == f"synth_proteins({N}, seed=0)" and table.n == N
    server = host if which == "host" else srv
    got = server.query(_all_seqs(table), threshold=10)
    want = _jax_answers()
    assert len(got) == len(want) == N
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_pipelined_and_routed_answers_equal_the_synchronous_ones(bench_env):
    table, _, srv, _ = _servers()
    seqs = _all_seqs(table)[:64]
    sync = srv.query(seqs, threshold=10)
    handles = [srv.query_async(seqs, threshold=10) for _ in range(3)]
    for h in handles:
        assert "host_seqs" not in h
        assert all(np.array_equal(a, s)
                   for a, s in zip(srv.query_wait(h), sync))
    srv.set_host_route_max(query.ROUTE_MAX)
    try:
        h = srv.query_async(seqs[:1], threshold=10)
        assert "host_seqs" in h  # the port's routed handle
        assert np.array_equal(srv.query_wait(h)[0], sync[0])
        assert "host_seqs" not in srv.query_async(seqs[:5], threshold=10)
    finally:
        srv.set_host_route_max(0)


def _jax_record_keys() -> set:
    """The keys of ``bench_query.py``'s record: the ``rec`` literal of its
    ``main`` and the dicts it splices in."""
    with open(os.path.join(REPO, "bench_query.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Dict)):
            dicts.setdefault(node.targets[0].id, []).append(node.value)
    keys = set()
    for d in dicts["rec"]:
        for k, v in zip(d.keys, d.values):
            if k is not None:
                keys.add(k.value)
                continue
            for spliced in dicts[v.id]:
                keys.update(sk.value for sk in spliced.keys)
    return keys


def test_query_bench_on_the_cpu(bench_env, capsys):
    """The whole bench with the stream point and a 4-shard mesh probe:
    exit 0, host-exact everywhere, no kernel, and the JAX record's keys
    plus the port's fields."""
    bench_env.setenv("UKC_QUERY_STREAM", "1")
    bench_env.setenv("UKC_QUERY_MESH_D", "4")
    assert query.main([]) == 0
    line = _line(capsys)
    assert set(line) == _jax_record_keys() | PORT_FIELDS
    assert line["metric"] == "query_serving" and line["unit"] == "queries/s"
    assert line["parity"].startswith("host-exact (256/256")
    assert line["value"] == line["max_sustained_qps"] > 0
    assert set(line["curve"]) == {"1", "16", "64", "256"}
    assert set(line["pipelined"]) == {"64x8", "256x4"}
    assert line["kernels"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    assert line["stream_mode"]["parity"] == "host-exact (256/256)"
    assert line["stream_mode"]["block_source"] == "csr-device-materialized"
    probe = line["mesh_virtual_cpu"]
    assert "error" not in probe, probe
    assert probe["devices"] == 4 and probe["parity"].startswith("host-exact")
    route = line["latency_route"]
    assert route["parity"] == "routed answer == device answer == host answer"
    assert line["corpus"] == f"synth_proteins({N}, seed=0)"
    assert line["device"] == "cpu" and line["power_limit_w"] is None


def test_query_bench_rejects_a_wrong_answer(bench_env, capsys, monkeypatch):
    real = query.build_servers

    def off_by_one(dev, mesh_devices=0):
        table, bitset, srv, host = real(dev, mesh_devices)
        served = srv.query_wait

        def wait(handle, top=None):
            out = served(handle, top)
            out[-1] = out[-1][:-1]
            return out

        srv.query_wait = wait
        return table, bitset, srv, host

    monkeypatch.setattr(query, "build_servers", off_by_one)
    bench_env.setenv("UKC_QUERY_MESH", "0")
    assert query.main([]) == 1
    line = _line(capsys)
    assert line["value"] == 0.0 and "mismatch" in line["error"]


def test_a_failed_mesh_probe_is_recorded(bench_env, monkeypatch):
    monkeypatch.setattr(query, "MODULE", "no_such_module_here")
    got = query._run_mesh_probe()
    assert set(got) == {"error"} and "exit 1" in got["error"]


def test_query_without_cuda_fails_instead_of_running_on_the_cpu(
        bench_env, capsys, monkeypatch):
    bench_env.setenv("UKC_BENCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert query.main([]) == 1
    line = _line(capsys)
    assert line["value"] == 0.0 and line["metric"] == query.METRIC
    assert "no CUDA GPU" in line["error"]


@pytest.mark.parametrize("qn, name", [(0, "torch_query"),
                                      (200, "torch_queryscale0k")])
def test_query_artifact_names_start_with_torch(bench_env, capsys,
                                               monkeypatch, qn, name):
    from uniprot_kmer_based_clustering_tpu_torch.utils import artifact

    names = []
    monkeypatch.setattr(artifact, "write_bench_artifact",
                        lambda name, line, repo_dir=None: names.append(name))
    bench_env.setenv("UKC_BENCH_N", "200")
    bench_env.setenv("UKC_QUERY_MESH", "0")
    if qn:
        bench_env.setenv("UKC_QUERY_N", str(qn))
    assert query.main([]) == 0
    line = _line(capsys)
    assert names == [name]
    assert line["corpus"] == (f"synthetic-{qn}" if qn
                              else "synth_proteins(200, seed=0)")
    assert "mesh_virtual_cpu" not in line
