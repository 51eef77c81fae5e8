"""The port's bench entry points (``benches/``, ``cli bench``,
``utils/artifact.py``, ``ops.bitmul.sweep_mxu_async``) against the JAX
package and the repository's JAX bench scripts on the CPU.

Inputs are seeded: ``synth_proteins`` corpora and seeded numpy arrays.
Tolerance: exact equality (integer statistics, pair lists, counters,
file contents). The benches run on the CPU here (``UKC_BENCH_DEVICE=cpu``
or ``UKC_ENGINES_ON_CPU=1``) at a few hundred proteins; torch runs on
one thread and each JAX result is computed once.
"""

import functools
import glob
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_scale
from uniprot_kmer_based_clustering_tpu.config import PipelineConfig as JConfig
from uniprot_kmer_based_clustering_tpu.kmers import build_index as jbuild_index
from uniprot_kmer_based_clustering_tpu.kmers import encode_kmers as jencode
from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets as jpack
from uniprot_kmer_based_clustering_tpu.ops import bitmul as jbm
from uniprot_kmer_based_clustering_tpu.similarity import pairwise as jpw
from uniprot_kmer_based_clustering_tpu.utils import artifact as jartifact
from uniprot_kmer_based_clustering_tpu.utils.blosum import (
    rank_weights_int8 as jrank_weights,
)
from uniprot_kmer_based_clustering_tpu_torch import cli as tcli
from uniprot_kmer_based_clustering_tpu_torch.benches import common
from uniprot_kmer_based_clustering_tpu_torch.benches import engines
from uniprot_kmer_based_clustering_tpu_torch.benches import headline
from uniprot_kmer_based_clustering_tpu_torch.benches import scale
from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul as tbm
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw
from uniprot_kmer_based_clustering_tpu_torch.utils import artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "uniprot_kmer_based_clustering_tpu_torch"
BENCH_KNOBS = ("UKC_BENCH_", "UKC_SCALE_", "UKC_ENGINES_")
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "sweep_seconds",
                 "sync_latency_seconds", "cpu_native_engine_pairs_per_s",
                 "parity", "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench_env(monkeypatch):
    """No bench knob of the environment leaks into a test."""
    for k in list(os.environ):
        if k.startswith(BENCH_KNOBS):
            monkeypatch.delenv(k)
    return monkeypatch


def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


# -- sweep_mxu_async ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _corpus(n=300, seed=4):
    """synth_proteins(n) through the JAX host stages (the port's copies
    are held equal to them by tests/test_torch_isolation.py): packed
    words (512-row padding), padded classes and BLOSUM62 weights."""
    seq_buf, offsets, classes = bench_scale.synth_proteins(n, seed=seed)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=512)
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[:n] = classes
    wts = jrank_weights(idx.repeated_codes, 5, bs.w_pad * 32)
    return bs.words, cls, n, wts


def _sweep_kw(schedule, weighted):
    words, cls, n, wts = _corpus()
    thr = JConfig(weighting="blosum62").effective_weighted_threshold(wts) \
        if weighted else 10
    return dict(strip=128, block=128, schedule=schedule, threshold=thr,
                weights=wts if weighted else None)


@functools.lru_cache(maxsize=None)
def _jax_async(schedule, fused_k, weighted):
    words, cls, n, _ = _corpus()
    kw = _sweep_kw(schedule, weighted)
    thr = kw.pop("threshold")
    handles, finalize = jbm.sweep_mxu_async(
        jnp.asarray(words), jnp.asarray(cls), n, thr, fused_k=fused_k, **kw)
    out = finalize(handles)
    if fused_k != 0 and out[3] is not None:
        pairs = jpw.extract_pairs_fused(
            jnp.asarray(words), cls, out[1], out[2], out[3], n=n,
            threshold=thr, weights=kw["weights"])
        return out[:3], (out[3].k, out[3].bs, out[3].block,
                         out[3].pairs_ij.tolist()), pairs
    return out[:3], (None if fused_k != 0 else "absent"), None


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "blosum62"])
@pytest.mark.parametrize("fused_k", [0, None], ids=["fused0", "fusedauto"])
@pytest.mark.parametrize("schedule", ["strips", "scan"])
def test_sweep_mxu_async_matches_jax(schedule, fused_k, weighted):
    """Dispatch then finalize equals the JAX sweep_mxu_async and its
    finalize: row stats, tile hits, the tile enumeration, the fused
    candidates' shape (None on strips) and, fused, the pairs extracted
    from them."""
    words, cls, n, _ = _corpus()
    kw = _sweep_kw(schedule, weighted)
    thr = kw.pop("threshold")
    w = torch.from_numpy(words.view(np.int32))
    handles, finalize = tbm.sweep_mxu_async(w, cls, n, thr, fused_k=fused_k,
                                            **kw)
    got = finalize(handles)
    (rs_j, th_j, (ti_j, tj_j, b_j)), cand_j, pairs_j = _jax_async(
        schedule, fused_k, weighted)
    rs_t, th_t, (ti_t, tj_t, b_t) = got[:3]
    assert np.array_equal(rs_t, rs_j) and rs_t.dtype == np.int64
    assert np.array_equal(th_t, th_j)
    assert np.array_equal(ti_t, ti_j) and np.array_equal(tj_t, tj_j)
    assert b_t == b_j
    assert int(th_t[:, 0].sum()) > 0
    if fused_k == 0:
        assert len(got) == 3
        return
    cands = got[3]
    if cand_j is None:
        assert cands is None
        return
    assert (cands.k, cands.bs, cands.block, cands.pairs_ij.tolist()) == cand_j
    pairs_t = tpw.extract_pairs_fused(
        w, cls, th_t, (ti_t, tj_t, b_t), cands, n=n, threshold=thr,
        weights=None if kw["weights"] is None
        else torch.from_numpy(kw["weights"]))
    assert np.array_equal(pairs_t, pairs_j) and len(pairs_t) > 0


@pytest.mark.parametrize("schedule", ["strips", "scan"])
def test_back_to_back_dispatches_finalize_once(schedule):
    """Three sweeps dispatched back to back hold three distinct output
    buffers; finalizing the last equals sweep_mxu, and so does each."""
    words, cls, n, _ = _corpus()
    kw = _sweep_kw(schedule, False)
    thr = kw.pop("threshold")
    w = torch.from_numpy(words.view(np.int32))
    dispatched = [tbm.sweep_mxu_async(w, cls, n, thr, **kw) for _ in range(3)]
    ptrs = {h[0].data_ptr() for h, _ in dispatched}
    ptrs |= {h[1].data_ptr() for h, _ in dispatched}
    assert len(ptrs) == 6
    handles, finalize = dispatched[-1]
    want = tbm.sweep_mxu(w, cls, n, thr, **kw)
    for (rs, th, tiles), (rs_w, th_w, tiles_w) in [
            (finalize(handles), want),
            *((f(h), want) for h, f in dispatched[:2])]:
        assert np.array_equal(rs, rs_w) and np.array_equal(th, th_w)
        assert tiles[2] == tiles_w[2]


def test_sweep_mxu_async_is_exported_and_refuses_bad_knobs():
    from uniprot_kmer_based_clustering_tpu_torch import ops

    assert ops.sweep_mxu_async is tbm.sweep_mxu_async
    w = torch.zeros((512, 128), dtype=torch.int32)
    cls = np.zeros(512, np.int32)
    with pytest.raises(ValueError, match="unknown schedule"):
        tbm.sweep_mxu_async(w, cls, 500, 10, schedule="ring")
    with pytest.raises(ValueError, match="requires stats_engine='xla'"):
        tbm.sweep_mxu_async(w, cls, 500, 10, strip=128, block=128,
                            schedule="scan", fused_k=512,
                            stats_engine="pallas")


# -- utils/artifact -----------------------------------------------------------

def _artifact_without_device(path):
    """The artifact without the provenance's device fields, its timestamp
    and its note on who captured it (worded apart in each package)."""
    with open(path) as f:
        rec = json.load(f)
    prov = rec["provenance"]
    assert prov.pop("captured_by").startswith(
        "bench script (utils/artifact.py)")
    for key in ("device", "platform", "n_devices", "power_limit", "torch",
                "written_utc"):
        prov.pop(key, None)
    return rec


def test_write_bench_artifact_writes_what_jax_writes(bench_env, tmp_path):
    """The same line under the same round: the same file, apart from the
    provenance's device fields (and its timestamp and capture note)."""
    bench_env.setenv("UKC_BENCH_ROUND", "7")
    bench_env.setenv("UKC_SCALE_N", "400")
    line = {"metric": "m", "value": 1.5, "nested": {"a": [1, 2]}}
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    pj = jartifact.write_bench_artifact("x", line, str(tmp_path / "j"))
    pt = artifact.write_bench_artifact("torch_x", line, str(tmp_path / "t"))
    assert os.path.basename(pj) == "BENCH_x_r07.json"
    assert os.path.basename(pt) == "BENCH_torch_x_r07.json"
    assert _artifact_without_device(pt) == _artifact_without_device(pj)
    with open(pt) as f:
        prov = json.load(f)["provenance"]
    # no CUDA context was made by this process: the device is the CPU
    assert prov["device"] == "cpu" and prov["torch"] == torch.__version__
    assert "UKC_SCALE_N=400" in prov["repro_command"]
    assert "UKC_BENCH_ROUND=7" in prov["repro_command"]


def test_write_bench_artifact_writes_nothing_without_a_round(bench_env,
                                                             tmp_path):
    assert artifact.write_bench_artifact(
        "torch_engines", {"value": 1}, str(tmp_path)) is None
    assert os.listdir(tmp_path) == []
    from uniprot_kmer_based_clustering_tpu_torch.utils import (
        write_bench_artifact,
    )

    assert write_bench_artifact is artifact.write_bench_artifact


JAX_ARTIFACT_NAMES = sorted({
    re.sub(r"_r\d+$", "", os.path.basename(p)[len("BENCH_"):-len(".json")])
    for p in glob.glob(os.path.join(REPO, "BENCH_*.json"))
})


def test_no_port_artifact_name_is_a_jax_one(bench_env, tmp_path,
                                            monkeypatch):
    """Every name the port's benches write starts with torch_ (the
    engines and scale benches, recorded through a stand-in writer), none
    is the name of a JAX artifact of the repository, and the writer
    refuses each JAX name."""
    assert JAX_ARTIFACT_NAMES and not any(
        n.startswith("torch_") for n in JAX_ARTIFACT_NAMES)
    bench_env.setenv("UKC_BENCH_ROUND", "1")
    for name in JAX_ARTIFACT_NAMES:
        with pytest.raises(ValueError, match="must start with 'torch_'"):
            artifact.write_bench_artifact(name, {}, str(tmp_path))
    names = []
    monkeypatch.setattr(artifact, "write_bench_artifact",
                        lambda name, line, repo_dir=None: names.append(name))
    engines._write({})
    bench_env.setenv("UKC_BENCH_DEVICE", "cpu")
    bench_env.setenv("UKC_SCALE_N", "300")
    bench_env.setenv("UKC_SCALE_BLOCK", "32")
    bench_env.setenv("UKC_SCALE_FUSED", "0")
    assert scale.main() == 0
    bench_env.setenv("UKC_SCALE_STREAM_ONLY", "1")
    assert scale.main() == 0
    bench_env.setenv("UKC_SCALE_K", "7")
    assert scale.main() == 0
    assert names == ["torch_engines", "torch_scale0k", "torch_scale0k_stream",
                     "torch_scale7mer0k"]
    assert not set(names) & set(JAX_ARTIFACT_NAMES)
    assert os.listdir(tmp_path) == []


# -- benches/common -----------------------------------------------------------

@pytest.mark.parametrize("n, seed", [(50, 0), (777, 3), (10_619, 0)])
def test_synth_proteins_equals_bench_scale(bench_env, n, seed):
    want = bench_scale.synth_proteins(n, seed=seed)
    got = common.synth_proteins(n, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_synth_proteins_reads_the_scale_knobs(bench_env):
    default = common.synth_proteins(200, seed=1)
    bench_env.setenv("UKC_SCALE_TEMPLATES", "7")
    bench_env.setenv("UKC_SCALE_MUTDIV", "3")
    want = bench_scale.synth_proteins(200, seed=1)
    got = common.synth_proteins(200, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not np.array_equal(got[1], default[1])


@functools.lru_cache(maxsize=None)
def _host_index(n=400, seed=0, k=5):
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
    )

    seq_buf, offsets, classes = common.synth_proteins(n, seed=seed)
    codes, koff = encode_kmers(seq_buf, offsets, k)
    return build_index(codes, koff, k), classes


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "blosum62"])
def test_scipy_oracle_matches_the_jax_native_free_sweep(weighted):
    """The benches' oracle (B·Bᵀ, or B·diag(w)·Bᵀ) equals the JAX
    package's MXU sweep and extraction on the same corpus."""
    idx, classes = _host_index()
    n = len(classes)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=512)
    cfg = JConfig(engine="mxu", weighting="blosum62" if weighted else "none")
    wts = jrank_weights(idx.repeated_codes, 5, bs.w_pad * 32) \
        if weighted else None
    res = jpw.pairwise_similarity(bs, classes, cfg, weights=wts)
    thr = cfg.effective_weighted_threshold(wts) if weighted else 10
    counters, pairs = common.index_oracle(
        idx, classes, n, threshold=thr,
        weights=None if wts is None else wts[: idx.n_repeated])
    assert counters == res.parity_counters()
    assert np.array_equal(pairs, res.pairs) and len(pairs) > 0


# -- benches/scale: oracle_gate -----------------------------------------------

@pytest.mark.parametrize("fmt", ["arr3", "packed"])
@pytest.mark.parametrize("tamper", [False, True], ids=["exact", "tampered"])
def test_oracle_gate_matches_jax(fmt, tamper):
    idx, classes = _host_index()
    n = len(classes)
    _, pairs = common.index_oracle(idx, classes, n)
    pairs = pairs.astype(np.int32)
    if tamper:
        pairs = pairs.copy()
        pairs[len(pairs) // 2, 2] += 1
    if fmt == "packed":
        pairs = np.array([tpw.packed_key(i, j) | int(c)
                          for i, j, c in pairs.tolist()], np.int64)
        assert np.array_equal(jpw.unpack_pairs(pairs),
                              tpw.unpack_pairs(pairs))
    if tamper:
        with pytest.raises(AssertionError, match="oracle gate"):
            bench_scale.oracle_gate(idx, classes, pairs, n, 10, samples=2048)
        with pytest.raises(AssertionError, match="oracle gate"):
            scale.oracle_gate(idx, classes, pairs, n, 10, samples=2048)
        return
    want = bench_scale.oracle_gate(idx, classes, pairs, n, 10)
    assert scale.oracle_gate(idx, classes, pairs, n, 10) == want > 512


# -- the headline and cli bench ----------------------------------------------

def _cpu_headline_env(env, n=600):
    env.setenv("UKC_BENCH_DEVICE", "cpu")
    env.setenv("UKC_BENCH_N", str(n))
    env.setenv("UKC_BENCH_REPS", "1")


@functools.lru_cache(maxsize=None)
def _jax_counters(n):
    """The JAX package's MXU engine on synth_proteins(n, seed=0)."""
    seq_buf, offsets, classes = bench_scale.synth_proteins(n, seed=0)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=512)
    return jpw.pairwise_similarity(bs, classes,
                                   JConfig(engine="mxu")).parity_counters()


def test_headline_on_the_cpu_prints_bench_py_line(bench_env, capsys):
    _cpu_headline_env(bench_env)
    assert headline.main() == 0
    line = _last_json(capsys.readouterr().out)
    assert BENCH_PY_KEYS <= set(line)
    assert line["metric"] == "pairwise_similarity"
    assert line["unit"] == "pairs/s/chip" and line["value"] > 0
    assert line["parity"] == "oracle-exact"
    assert line["counters"] == _jax_counters(600)
    assert line["dataset"] == "synth_proteins(600, seed=0)"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    # a CPU tensor takes the plain epilogue: no kernel launch counted
    assert line["kernels"] == {"K1": 0, "K2": 0}
    assert line["sync_latency_seconds"] > 0 and line["sweep_seconds"] > 0


def test_headline_tampered_gate_scores_zero(bench_env, capsys, monkeypatch):
    _cpu_headline_env(bench_env, n=300)
    real = common.index_oracle

    def tampered(*a, **kw):
        counters, pairs = real(*a, **kw)
        return {**counters,
                "max_shared_kmers": counters["max_shared_kmers"] + 1}, pairs

    monkeypatch.setattr(common, "index_oracle", tampered)
    assert headline.main() == 1
    line = _last_json(capsys.readouterr().out)
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "parity FAILED" in line["error"]


@pytest.mark.parametrize("bench", [headline, engines, scale],
                         ids=["headline", "engines", "scale"])
def test_bench_without_cuda_fails_instead_of_running_on_the_cpu(
        bench_env, capsys, monkeypatch, bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    line = _last_json(capsys.readouterr().out)
    assert line["value"] == 0.0
    assert "no CUDA GPU" in line["error"]
    assert line["metric"] == bench.METRIC


def test_cli_bench_runs_the_port_headline_alone(tmp_path):
    """A fresh interpreter runs `cli bench` on the CPU: the headline's
    line, and neither jax, the JAX package nor a root bench script in
    sys.modules."""
    forbidden = ("jax", "jaxlib", "uniprot_kmer_based_clustering_tpu",
                 "bench", "bench_scale", "bench_engines")
    code = (
        "import sys\n"
        f"from {PORT}.cli import main\n"
        "rc = main(['bench'])\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {forbidden!r}]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(BENCH_KNOBS)}
    env.update(UKC_BENCH_DEVICE="cpu", UKC_BENCH_N="300",
               UKC_BENCH_REPS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env={**env, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = _last_json(proc.stdout)
    assert line["counters"] == _jax_counters(300)
    assert line["parity"] == "oracle-exact"


def test_cli_bench_fasta_argument_wins(bench_env, monkeypatch, tmp_path,
                                       toy_fasta, capsys):
    seen = []
    monkeypatch.setattr(headline, "main",
                        lambda: seen.append(os.environ["UKC_BENCH_FASTA"])
                        or 0)
    other = tmp_path / "other.fasta"
    other.write_text(">a|F|U|c|g\nMKV\n")
    bench_env.setenv("UKC_BENCH_FASTA", str(other))
    assert tcli.main(["bench", toy_fasta]) == 0
    assert seen == [toy_fasta]
    bench_env.setenv("UKC_BENCH_FASTA", str(other))
    assert tcli.main(["bench"]) == 0
    assert seen[-1] == str(other)
    assert tcli.main(["bench", str(tmp_path / "missing.fasta")]) == 2
    assert "no such FASTA" in capsys.readouterr().err
    assert len(seen) == 2


def test_headline_reads_a_fasta_and_gates_it_on_the_golden_counters(
        bench_env, capsys, toy_fasta):
    """UKC_BENCH_FASTA names a file: that file is the corpus and its gate
    is bench.py's golden counters, which the toy file does not meet."""
    bench_env.setenv("UKC_BENCH_DEVICE", "cpu")
    bench_env.setenv("UKC_BENCH_REPS", "1")
    bench_env.setenv("UKC_BENCH_FASTA", toy_fasta)
    assert headline.main() == 1
    line = _last_json(capsys.readouterr().out)
    assert "parity FAILED" in line["error"]
    assert str(headline.GOLDEN) in line["error"]


# -- benches/engines ----------------------------------------------------------

def test_engines_bench_on_the_cpu_is_exact(bench_env, capsys):
    bench_env.setenv("UKC_ENGINES_ON_CPU", "1")
    bench_env.setenv("UKC_BENCH_N", "400")
    assert engines.main() == 0
    line = _last_json(capsys.readouterr().out)
    assert line["metric"] == "engine_parity" and line["unit"] == "engines"
    rows = line["engines"]
    skipped = {k for k, v in rows.items() if v["parity"].startswith("skip")}
    assert skipped >= {"stats_pallas_vs_xla", *engines.EXTRA_GATES}
    assert line["engines_skipped"] == len(skipped)
    assert all(v["parity"] == "oracle-exact" for k, v in rows.items()
               if k not in skipped)
    assert line["value"] == line["engines_total"] == len(rows) - len(skipped)
    assert line["pairs_over_threshold"] == _jax_pairs(400).shape[0]
    assert rows["stream_onepass"]["sweep_trace"]["steps"] > 0


@functools.lru_cache(maxsize=None)
def _jax_pairs(n):
    seq_buf, offsets, classes = bench_scale.synth_proteins(n, seed=0)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=512)
    return jpw.pairwise_similarity(bs, classes, JConfig(engine="mxu")).pairs


@functools.lru_cache(maxsize=None)
def _engines_run(n=400):
    seq_buf, offsets, classes = common.synth_proteins(n, seed=0)
    corpus = common.Corpus(seq_buf, offsets, classes, f"synth {n}", None)
    return engines.prepare(resolve_device("cpu"), corpus)


@pytest.mark.parametrize("row", ["stats", *engines.EXTRA_GATES])
def test_engines_rows_the_cpu_run_skips_are_exact(bench_env, row):
    """The rows a CPU run of the bench skips, run directly on the CPU at
    400 proteins against their references: the plain epilogue twice
    (K1 only launches on a card), the k=7 and weighted oracles, the
    reference pair list, the structural gate."""
    run = _engines_run()
    assert np.array_equal(run.ref_pairs, _jax_pairs(400))
    if row == "stats":
        recs, ok = engines.stats_rows(run)
        assert ok and {r["parity"] for r in recs.values()} == {"identical"}
        return
    rec, ok = engines.EXTRA_ROWS[row](run)
    assert ok, rec
    assert rec["parity"] == ("structural-exact" if row == "agglomerative"
                             else "oracle-exact")


def test_structural_gate_catches_a_bad_merge_list():
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        AgglomerativeResult,
    )

    merges = np.array([[0, 2, 5], [1, 3, 4], [0, 1, 2]], np.int64)
    good = AgglomerativeResult(np.array([0, 0, 0, 0, 4], np.int32), merges, 2)
    assert engines.structural_gate(good, 5) is None
    bad_labels = AgglomerativeResult(np.array([0, 1, 0, 1, 4], np.int32),
                                     merges, 2)
    assert "union-find" in engines.structural_gate(bad_labels, 5)
    twice = AgglomerativeResult(good.labels, merges[[0, 0]], 1)
    assert "twice" in engines.structural_gate(twice, 5)
    upward = AgglomerativeResult(good.labels, merges[:, [1, 0, 2]], 1)
    assert "below" in engines.structural_gate(upward, 5)


# -- benches/scale ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scale_oracle(n, k):
    idx, classes = _host_index(n, 0, k)
    return common.index_oracle(idx, classes, n)[0]


@pytest.mark.parametrize("mesh", [0, 2], ids=["single", "mesh2"])
def test_scale_stream_only_run_on_the_cpu_equals_the_oracle(bench_env,
                                                            capsys, mesh):
    bench_env.setenv("UKC_BENCH_DEVICE", "cpu")
    bench_env.setenv("UKC_SCALE_N", "400")
    bench_env.setenv("UKC_SCALE_BLOCK", "32")
    bench_env.setenv("UKC_SCALE_STREAM_ONLY", "1")
    if mesh:
        bench_env.setenv("UKC_SCALE_STREAM_MESH", str(mesh))
    assert scale.main() == 0
    line = _last_json(capsys.readouterr().out)
    want = _scale_oracle(400, 5)
    assert line["metric"] == "pairwise_similarity_scale"
    assert line["pairs_over_threshold"] == want["pairs_over_threshold"]
    assert line["cross_amr_pairs"] == want["pairs_after_merge"]
    assert line["oracle_checked_pairs"] > 0
    assert line["pair_format"] == "packed-int64"
    assert line.get("stream_mesh_devices", 0) == mesh


def test_scale_in_core_run_on_the_cpu_equals_the_oracle(bench_env, capsys):
    """The scan schedule (strips of 32 rows), fused extraction equal to
    two-pass, and the stream engine equal to the in-core pairs."""
    bench_env.setenv("UKC_BENCH_DEVICE", "cpu")
    bench_env.setenv("UKC_SCALE_N", "400")
    bench_env.setenv("UKC_SCALE_BLOCK", "32")
    bench_env.setenv("UKC_SCALE_STRIP", "32")
    bench_env.setenv("UKC_SCALE_STREAM", "1")
    assert scale.main() == 0
    line = _last_json(capsys.readouterr().out)
    want = _scale_oracle(400, 5)
    assert line["pairs_over_threshold"] == want["pairs_over_threshold"]
    assert line["cross_amr_pairs"] == want["pairs_after_merge"]
    assert line["fused_k"] > 0 and "fused" not in line
    assert line["stream_parity"] == "pair-list identical to the in-core engine"
    assert line["oracle_checked_pairs"] > 0 and line["device"] == "cpu"
