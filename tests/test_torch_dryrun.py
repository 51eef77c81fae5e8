"""The port's ``dryrun.py`` against the repository root's
``__graft_entry__.py`` on the CPU, tolerance 0.

``entry()``: the example arguments and the one-strip step's outputs.
``dryrun_multichip(4)``: the port on 4 CPU shards against the JAX dry run
on the 8 virtual CPU devices of ``tests/conftest.py``. Each side runs once
per module. The JAX run's arrays are recorded from inside it: the
library functions it calls are wrapped for the run, so each array
compared is the one the JAX dry run checked (its first call of that
function), not a second computation. Torch runs on one thread.
"""

import contextlib
import functools
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from uniprot_kmer_based_clustering_tpu_torch import dryrun as tdry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "uniprot_kmer_based_clustering_tpu"

# the JAX dry run's figures at 4 devices (its printed line)
JAX_FIGURES = {"stats_sum": 622733, "pairs": 36690,
               "stream_mesh_pairs": 36690, "docfreq_nnz": 896,
               "clusters": 496, "kaxis_pairs": 176}

# (module, attribute) of each library call the JAX dry run makes whose
# result is compared, and the key it is recorded under
_RECORDED = {
    "ring": ("parallel.sharded", "sharded_pairwise_similarity"),
    "extract": ("parallel.sharded", "sharded_extract_pairs"),
    "stream_mesh": ("parallel.stream_mesh", "sweep_extract_stream_mesh"),
    "docfreq": ("parallel.sharded", "doc_freq_psum"),
    "components": ("models.components", "connected_components_sharded"),
    "tree": ("models.tree", "cluster_tree_labels"),
    "agglomerative": ("models.agglomerative", "agglomerative_cluster"),
    "pairs": ("similarity.pairwise", "extract_pairs"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _recorder(calls, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    return wrapped


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(printed line, {key: [results of each call]}) of the JAX
    ``dryrun_multichip(4)``, and the mesh server's query answers."""
    import importlib

    from uniprot_kmer_based_clustering_tpu.similarity import QueryServer

    rec = {key: [] for key in _RECORDED}
    rec["query"] = []
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for key, (mod, name) in _RECORDED.items():
            m = importlib.import_module(f"{JAX}.{mod}")
            mp.setattr(m, name, _recorder(rec[key], getattr(m, name)))
        mp.setattr(QueryServer, "query",
                   _recorder(rec["query"], QueryServer.query))
        with contextlib.redirect_stdout(out):
            graft.dryrun_multichip(4)
    return out.getvalue().strip().splitlines()[-1], rec


@functools.lru_cache(maxsize=None)
def _port_run():
    return tdry.dryrun_multichip(4, device="cpu")


def _jax_figures(line):
    pat = (r"pairs=(\d+), multi-group.*stats sum=(\d+), pairs=(\d+), "
           r"docfreq nnz=(\d+), clusters=(\d+)\); .*pairs over 3300: (\d+)")
    m = re.search(pat, line)
    keys = ("stream_mesh_pairs", "stats_sum", "pairs", "docfreq_nnz",
            "clusters", "kaxis_pairs")
    return dict(zip(keys, map(int, m.groups())))


@pytest.mark.parametrize("key", list(JAX_FIGURES))
def test_dryrun_figures_equal_the_jax_line(key):
    line, _ = _jax_run()
    assert _jax_figures(line)[key] == JAX_FIGURES[key]
    assert _port_run()[key] == JAX_FIGURES[key]


def test_dryrun_line_equals_the_jax_line_up_to_the_d_sweep():
    line, _ = _jax_run()
    port = _port_run()["line"]
    cut = "ring D-sweep ["
    assert port.split(cut)[0] == line.split(cut)[0]
    assert port.split(cut)[1].startswith("CPU mesh, ")


def test_dryrun_d_sweep_runs_the_jax_device_counts():
    line, _ = _jax_run()
    want = [int(d) for d in re.findall(r"D=(\d+) [\d.]+s", line)]
    got = _port_run()["dsweep"]
    assert [e["d"] for e in got] == want == [1, 2, 4]
    assert [e["balance"] for e in got] == [(0.5, 0.5), (1.0, 1.0),
                                           (2.0, 2.0)]


def _jax_array(key):
    """The JAX dry run's array for a port result key."""
    _, rec = _jax_run()
    if key == "row_stats":
        return rec["ring"][0][0]
    if key == "tile_hits":
        return rec["ring"][0][1]
    if key == "pr":
        return rec["extract"][0]
    if key == "pr_m":
        return rec["stream_mesh"][0][3]
    if key == "freq":
        return rec["docfreq"][0]
    if key == "labels":
        return rec["components"][0]
    if key == "lab_tree":
        return rec["tree"][0]
    if key == "agg_labels":
        return rec["agglomerative"][0].labels
    if key == "query":
        return rec["query"][0][0]  # the mesh server's answer
    assert key == "pr_big"
    # extract_pairs: the ring check's reference, then the 7-mer point
    return rec["pairs"][1]


@pytest.mark.parametrize("key", [
    "row_stats", "tile_hits", "pr", "pr_m", "freq", "labels", "lab_tree",
    "agg_labels", "query", "pr_big",
])
def test_dryrun_arrays_equal_the_jax_runs(key):
    want = np.asarray(_jax_array(key))
    got = np.asarray(_port_run()[key])
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_dryrun_query_answers_equal_the_single_device_servers():
    _, rec = _jax_run()
    mesh_ans, one_ans = rec["query"][0][0], rec["query"][1][0]
    assert np.array_equal(mesh_ans, one_ans)
    assert np.array_equal(np.asarray(_port_run()["query"]), one_ans)


@pytest.mark.parametrize("what", ["args", "row_stats", "block_hits"])
def test_entry_equals_the_jax_entry(what):
    jfn, jargs = graft.entry()
    fn, args = tdry.entry(device="cpu")
    if what == "args":
        words, ca, cb, w = args
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(jargs[0]))
        assert ca is cb and np.array_equal(ca.numpy(), np.asarray(jargs[1]))
        assert w.dtype == torch.int8 and np.array_equal(w.numpy(),
                                                        np.asarray(jargs[3]))
        return
    k = {"row_stats": 0, "block_hits": 1}[what]
    want = np.asarray(jfn(*jargs)[k])
    got = fn(*args)[k].numpy()
    assert got.shape == want.shape == {0: (256, 8), 1: (2, 2, 2)}[k]
    assert np.array_equal(got, want)


def test_entry_on_the_cpu_launches_no_kernel():
    from uniprot_kmer_based_clustering_tpu_torch.ops import stats

    before = (stats.stats_from_counts_into.launches,
              stats.stats_from_counts_traced_into.launches)
    fn, args = tdry.entry(device="cpu")
    fn(*args)
    assert (stats.stats_from_counts_into.launches,
            stats.stats_from_counts_traced_into.launches) == before


def test_dryrun_on_cuda_without_a_card_raises(monkeypatch):
    """No card: the mesh refuses before anything runs, on the CPU or
    elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset

    ran = []
    monkeypatch.setattr(bitset, "pack_bitsets",
                        lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="sees no CUDA GPU"):
        tdry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="sees no CUDA GPU"):
        tdry.entry()
    assert ran == []


def test_dryrun_on_fewer_cards_than_asked_raises(monkeypatch):
    """Two visible cards for a four-card dry run: make_mesh's refusal,
    never fewer or shared cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="requested 4 devices, only 2 "
                                         "available"):
        tdry.dryrun_multichip(4)


def test_dryrun_with_a_short_device_list_raises():
    with pytest.raises(ValueError, match="requested 4 devices, only 3 "
                                         "listed"):
        tdry.dryrun_multichip(4, devices=["cpu"] * 3)


def test_dryrun_command_line_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", tdry.__name__, "4"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "sees no CUDA GPU" in proc.stderr
    assert "dryrun_multichip(4)" not in proc.stdout
