"""The port's mesh scaling bench (``benches/pod.py``, ``bench_pod.py``'s
counterpart) on the CPU against the JAX package.

The bench runs on D CPU shards (``UKC_BENCH_DEVICE=cpu``) over
``synth_proteins(300, seed=0)``; the JAX ring sweep and extraction run on
the 8 virtual CPU devices of ``tests/conftest.py`` with the same packing.
Inputs are seeded; tolerance 0 (counters, pair lists, tile and padding).
Torch runs on one thread and each JAX result is computed once.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu import parallel as jpar
from uniprot_kmer_based_clustering_tpu.kmers import build_index as jbuild_index
from uniprot_kmer_based_clustering_tpu.kmers import encode_kmers as jencode
from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets as jpack
from uniprot_kmer_based_clustering_tpu_torch.benches import common, pod
from uniprot_kmer_based_clustering_tpu_torch.parallel import count_substeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("UKC_BENCH_", "UKC_POD_", "UKC_1CHIP_")
N = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench_env(monkeypatch):
    """No bench knob of the environment leaks in; the CPU at N proteins."""
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


def jax_tile(n: int, d: int) -> tuple:
    """``bench_pod.py:131-138``'s tile and padding rule, over the JAX
    package's ``pad_for_mesh``."""
    for bt in (512, 256, 128):
        block_tile = bt
        if jpar.pad_for_mesh(n, d, bt) <= n * 1.07:
            break
    return block_tile, jpar.pad_for_mesh(n, d, block_tile)


@functools.lru_cache(maxsize=None)
def _jax_run(h: int, c: int):
    """The JAX ring sweep's counters and the JAX mesh extraction's pairs
    on ``synth_proteins(N)`` packed as ``bench_pod.py`` packs it, on an
    h × c mesh (h = 1: the flat ring of c devices)."""
    seq_buf, offsets, classes = common.synth_proteins(N, seed=0)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    d = h * c
    tile, n_pad = jax_tile(N, d)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, N, idx.n_repeated,
               row_multiple=n_pad, word_multiple=128)
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[:N] = classes
    if h > 1:
        mesh = jpar.make_mesh_2d(h, c)
        rs, _, _ = jpar.sharded_pairwise_similarity_2d(
            mesh, bs.words, cls, N, 10, block_tile=tile)
    else:
        mesh = jpar.make_mesh(d)
        rs, _, _ = jpar.sharded_pairwise_similarity(
            mesh, bs.words, cls, N, 10, block_tile=tile)
    pairs = jpar.sharded_extract_pairs(mesh, bs.words, cls, N, 10,
                                       block_tile=tile)
    return common.counters_of(rs), np.asarray(pairs), (tile, n_pad)


@functools.lru_cache(maxsize=None)
def _oracle():
    seq_buf, offsets, classes = common.synth_proteins(N, seed=0)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    return common.index_oracle(idx, classes, N)


@pytest.mark.parametrize("h, c", [(1, 1), (1, 2), (1, 4), (2, 2)],
                         ids=["D1", "D2", "D4", "2x2"])
def test_pod_bench_matches_jax_ring_and_oracle(bench_env, capsys, h, c):
    """The bench's counters = the JAX ring sweep's = the scipy oracle's;
    its extraction (gated in the bench on the oracle's list) = the JAX
    mesh extraction's list; tile and padding as JAX's."""
    if h > 1:
        bench_env.setenv("UKC_POD_MESH", f"{h}x{c}")
    else:
        bench_env.setenv("UKC_POD_DEVICES", str(c))
    assert pod.main() == 0
    line = _line(capsys)
    counters, pairs, (tile, n_pad) = _jax_run(h, c)
    want, want_pairs = _oracle()
    assert line["counters"] == counters == want
    assert np.array_equal(pairs.astype(np.int64), want_pairs)
    assert (line["extracted_pairs"], line["extracted_max"]) == (
        len(pairs), int(pairs[:, 2].max()))
    assert (line["block_tile"], line["n_pad"]) == (tile, n_pad)
    assert line["devices"] == h * c and line["hosts"] == 1
    assert line["mesh"] == (f"{h}x{c}" if h > 1 else str(c))
    assert line["parity"] == "oracle-exact" and line["device"] == "cpu"
    # the plain epilogue runs on the CPU: no kernel launches here
    assert line["kernels"] == {"K1": 0, "K2": 0}
    assert ("fused_seconds" in line) == (h == 1)
    assert line["one_chip_pairs_per_s"] > 0
    if h * c == 1:
        assert line["scaling_efficiency"] == 1.0


@pytest.mark.parametrize("d", range(1, 9))
def test_tile_and_padding_rule_is_jax_s(bench_env, d):
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        pad_for_mesh,
    )

    for n in (N, 1000, 10_619, 30_000):
        tile = pod.pick_tile(n, d)
        assert (tile, pad_for_mesh(n, d, tile)) == jax_tile(n, d)
    bench_env.setenv("UKC_POD_TILE", "96")
    assert pod.pick_tile(10_619, d) == 96


def test_k1_count_of_a_warm_sweep_on_the_card_path():
    """The launches phase 14 of chip_smoke.py expects a warm sweep at
    10,619 on one card: tile 512, N_pad 10,752, 7 sub-steps."""
    assert jax_tile(10_619, 1) == (512, 10_752)
    assert count_substeps(1, 10_752, 512) == 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_print_one_line_from_rank_0(tmp_path):
    """UKC_POD_DISTRIBUTED=1 with two ranks of the torchrun environment:
    one flat mesh over both (D = 2, 2 hosts), the oracle's counters, and
    the line from rank 0 alone."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(KNOBS)}
    env.update(UKC_BENCH_DEVICE="cpu", UKC_BENCH_N=str(N),
               UKC_POD_DISTRIBUTED="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "uniprot_kmer_based_clustering_tpu_torch."
         "benches.pod"], cwd=str(tmp_path), env={**env, "RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1][0].strip() == ""
    lines = outs[0][0].strip().splitlines()
    assert len(lines) == 1, outs
    line = json.loads(lines[0])
    assert (line["devices"], line["hosts"], line["mesh"]) == (2, 2, "2")
    assert line["counters"] == _oracle()[0]
    assert "one_chip_pairs_per_s" not in line  # across processes: no ref


def test_one_chip_rate_from_the_environment(bench_env, capsys):
    bench_env.setenv("UKC_POD_DEVICES", "2")
    bench_env.setenv("UKC_POD_FUSED", "0")
    bench_env.setenv("UKC_1CHIP_PAIRS_PER_S", "1000")
    assert pod.main() == 0
    line = _line(capsys)
    assert line["one_chip_pairs_per_s"] == 1000.0
    # both rounded in the line: 4 decimals and 0.1 pairs/s
    assert line["scaling_efficiency"] == pytest.approx(
        line["pairs_per_s"] / (2 * 1000.0), abs=1e-4)
    assert "fused_seconds" not in line


def test_pod_tampered_gate_fails(bench_env, capsys, monkeypatch):
    real = common.scipy_oracle

    def tampered(*a, **k):
        counters, pairs = real(*a, **k)
        return {**counters, "pairs_over_threshold": 0}, pairs

    monkeypatch.setattr(common, "scipy_oracle", tampered)
    assert pod.main() == 1
    line = _line(capsys)
    assert line["value"] == 0.0 and line["metric"] == pod.METRIC
    assert "golden parity FAILED" in line["error"]


def test_pod_without_cuda_fails_instead_of_running_on_the_cpu(
        bench_env, capsys, monkeypatch):
    bench_env.setenv("UKC_BENCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pod.main() == 1
    line = _line(capsys)
    assert line["value"] == 0.0 and line["unit"] == pod.UNIT
    assert "no CUDA GPU" in line["error"]


def test_pod_artifact_is_named_torch_pod(bench_env, capsys, monkeypatch):
    from uniprot_kmer_based_clustering_tpu_torch.utils import artifact

    names = []
    monkeypatch.setattr(artifact, "write_bench_artifact",
                        lambda name, line, repo_dir=None: names.append(name))
    bench_env.setenv("UKC_POD_FUSED", "0")
    assert pod.main() == 0
    assert names == ["torch_pod"]


@pytest.mark.parametrize("spec", [None, "1x2"], ids=["flat", "2d"])
def test_a_rank_of_a_world_gives_its_own_card(bench_env, monkeypatch, spec):
    """Across processes the bench hands the mesh the unresolved
    ``UKC_BENCH_DEVICE`` (``cuda``: each rank's LOCAL_RANK card), never
    the card the process resolved before it joined the world."""
    from uniprot_kmer_based_clustering_tpu_torch import parallel
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh

    seen = []

    def fake(*shape, device="cuda"):
        seen.append(device)
        return types.SimpleNamespace(size=2)

    monkeypatch.setattr(mesh, "world", lambda: (1, 2))
    monkeypatch.setattr(parallel, "make_mesh", fake)
    monkeypatch.setattr(parallel, "make_mesh_2d", fake)
    bench_env.setenv("UKC_BENCH_DEVICE", "cuda")
    bench_env.setenv("LOCAL_RANK", "1")
    if spec:
        bench_env.setenv("UKC_POD_MESH", spec)
    pod.build_mesh(torch.device("cuda", 0))
    assert seen == ["cuda"]


def test_the_world_is_joined_before_the_device_is_resolved(
        bench_env, capsys, monkeypatch):
    """UKC_POD_DISTRIBUTED=1 on cards: NCCL's init (which makes the rank's
    card current) comes before ``cuda`` is resolved to a card."""
    from uniprot_kmer_based_clustering_tpu_torch import device
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh

    calls = []

    def resolve(name):
        calls.append(("resolve", name))
        raise common.BenchFailure("stop here")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh, "init_distributed",
                        lambda backend=None: calls.append(("init", backend)))
    monkeypatch.setattr(device, "resolve_device", resolve)
    bench_env.setenv("UKC_BENCH_DEVICE", "cuda")
    bench_env.setenv("UKC_POD_DISTRIBUTED", "1")
    assert pod.main() == 1
    assert calls == [("init", None), ("resolve", "cuda")]
    assert _line(capsys)["error"] == "stop here"


@pytest.mark.parametrize("h, c", [(1, 2), (2, 2)], ids=["D2", "2x2"])
def test_async_sweep_matches_the_blocking_sweep(h, c):
    """``sharded_sweep_async``'s dispatches, two back to back, each
    finalize to what the blocking sweep returns on the same mesh."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        pad_for_mesh,
        sharded_pairwise_similarity,
        sharded_pairwise_similarity_2d,
        sharded_sweep_async,
        stage_mesh_inputs,
    )

    seq_buf, offsets, classes = common.synth_proteins(N, seed=0)
    codes, koff = encode_kmers(seq_buf, offsets, 5)
    idx = build_index(codes, koff, 5)
    n_pad = pad_for_mesh(N, h * c, 128)
    bs = pack_bitsets(idx.incidence_protein, idx.incidence_rank, N,
                      idx.n_repeated, row_multiple=n_pad, word_multiple=128)
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[:N] = classes
    if h > 1:
        mesh, blocking = make_mesh_2d(h, c, device="cpu"), \
            sharded_pairwise_similarity_2d
    else:
        mesh, blocking = make_mesh(c, device="cpu"), \
            sharded_pairwise_similarity
    words_st, cls_st = stage_mesh_inputs(mesh, bs.words, cls)
    rs, th, tiles = blocking(mesh, words_st, cls_st, N, 10)
    dispatch, finalize = sharded_sweep_async(mesh, words_st, cls_st, N, 10)
    handles = [dispatch(), dispatch()]
    for got in map(finalize, handles):
        assert np.array_equal(got[0], rs) and np.array_equal(got[1], th)
        assert all(np.array_equal(a, b) for a, b in zip(got[2], tiles))
    assert common.counters_of(rs) == _oracle()[0]
