"""The port's slice as a whole against the JAX package: run_pipeline,
the `cli run` artifacts, checkpoints across packages, the import
boundary and the no-silent-CPU rule.

Tolerance: exact equality (parity counters, pair lists, labels, and the
pairs.tsv / clusters.tsv bytes).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline as jrun
from uniprot_kmer_based_clustering_tpu.utils.blosum import rank_weights_int8
from uniprot_kmer_based_clustering_tpu_torch import pipeline as tpl
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(engine="mxu", tile=16, strip=32, threshold=2)


@pytest.fixture(scope="module")
def synth_fasta(tmp_path_factory):
    """bench_scale's template-mutation corpus, 1200 proteins, headers in
    the reference's format."""
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(1200, seed=3)
    path = tmp_path_factory.mktemp("synth") / "synth.fasta"
    with open(path, "w") as f:
        for i in range(1200):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


def _same(a, b):
    assert a.parity_report() == b.parity_report()
    assert np.array_equal(a.pairwise.pairs, b.pairwise.pairs)
    assert np.array_equal(a.cluster_labels, b.cluster_labels)


def test_pipeline_multi_strip_matches_jax(synth_fasta):
    """1200 proteins, tile 128, strip 256: 5 strips, 55 tiles, thousands of
    pairs through the two-pass extraction."""
    cfg = PipelineConfig(engine="mxu", tile=128, strip=256)
    got = trun(synth_fasta, cfg, device="cpu")
    assert got.bitset.n_pad == 1280
    assert got.parity_report()["pairs_over_threshold"] > 1000
    _same(jrun(synth_fasta, cfg), got)
    assert list(got.timings) == ["ingest", "encode", "index", "pack",
                                 "sweep", "cluster"]


@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_blosum_weights_are_the_jax_pipelines(weighting):
    """The weights the port's pipeline hands the sweep: None unweighted,
    else what the JAX pipeline computes, rank_weights_int8 over every
    packed bit column."""
    from bench_scale import synth_proteins

    seq_buf, offsets, _ = synth_proteins(200, seed=1)
    codes, koff = tpl.encode_kmers(seq_buf, offsets, 5)
    index = tpl.build_index(codes, koff, 5)
    bitset = tpl.pack_bitsets(index.incidence_protein, index.incidence_rank,
                              200, index.n_repeated, row_multiple=128)
    got = tpl.blosum_weights(index, PipelineConfig(weighting=weighting),
                             bitset)
    if weighting == "none":
        assert got is None
        return
    want = rank_weights_int8(index.repeated_codes, 5, bitset.w_pad * 32)
    assert got.dtype == np.int8 and got.shape == (bitset.w_pad * 32,)
    assert np.array_equal(got, want)
    assert got[: index.n_repeated].any()


def _cli_outputs(out):
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(out, "pairs.tsv"), "rb") as f:
        pairs = f.read()
    with open(os.path.join(out, "clusters.tsv"), "rb") as f:
        clusters = f.read()
    return stats, pairs, clusters


@pytest.mark.parametrize("extra", [[], ["--all-pairs", "--threshold", "3"],
                                   ["--weighting", "blosum62"]])
def test_cli_run_matches_jax_cli(toy_fasta, tmp_path, capsys, extra):
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--engine", "mxu", "--cpu", "--out",
                  jout, *extra]) == 0
    assert tmain(["run", toy_fasta, "--engine", "mxu", "--device", "cpu",
                  "--out", tout, *extra]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    js, jp, jc = _cli_outputs(jout)
    ts, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts["parity"] == js["parity"] and ts["clusters"] == js["clusters"]
    assert ts["parity"]["pairs_over_threshold"] > 0
    assert ts["device"] == "cpu"
    assert set(ts["timings_s"]) == set(js["timings_s"])


@pytest.mark.parametrize("extra", [
    ["--engine", "popcount"],
    ["--engine", "xla", "--all-pairs", "--threshold", "0"],
    ["--engine", "popcount", "--weighting", "blosum62"],
    ["--engine", "mxu", "--extract", "fused", "--extract-k", "4"],
], ids=["popcount", "xla-all-pairs-t0", "popcount-weighted", "fused"])
def test_cli_engines_and_fused_match_jax_cli(toy_fasta, tmp_path, extra):
    """The flags this port no longer refuses, byte for byte against the
    JAX CLI (the toy corpus is one strip: fused falls back to two-pass in
    both packages; the scan's fused path is pinned in
    test_torch_pairwise.py)."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout, *extra]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout,
                  *extra]) == 0
    js, jp, jc = _cli_outputs(jout)
    ts, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts["parity"] == js["parity"] and ts["clusters"] == js["clusters"]
    assert ts["parity"]["pairs_over_threshold"] > 0


def test_checkpoints_cross_packages(toy_fasta, tmp_path):
    """A checkpoint directory written by one package resumes in the other
    (same cache keys, same artifacts): the resumed run skips the sweep."""
    cfg = PipelineConfig(**TOY)
    j_dir, t_dir = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    j1 = jrun(toy_fasta, cfg, checkpoint_dir=j_dir)
    t2 = trun(toy_fasta, cfg, checkpoint_dir=j_dir, device="cpu")
    assert "sweep" not in t2.timings and "index" not in t2.timings
    _same(j1, t2)
    t1 = trun(toy_fasta, cfg, checkpoint_dir=t_dir, device="cpu")
    assert "sweep" in t1.timings
    j2 = jrun(toy_fasta, cfg, checkpoint_dir=t_dir)
    assert "sweep" not in j2.timings and "index" not in j2.timings
    _same(t1, j2)
    assert sorted(os.listdir(j_dir)) == sorted(os.listdir(t_dir))


def test_cli_devices_matches_jax_cli(toy_fasta, tmp_path, capsys):
    """`cli run --device cpu --devices 4` (the flat ring on four CPU
    shards) against the JAX CLI's `--cpu --devices 4` (four virtual
    devices): pairs.tsv and clusters.tsv byte for byte; stats.json's
    parity, clusters, n_devices and stage names."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--devices", "4", "--out",
                  jout]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--devices", "4",
                  "--out", tout]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    js, jp, jc = _cli_outputs(jout)
    ts, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts["parity"] == js["parity"] and ts["clusters"] == js["clusters"]
    assert ts["n_devices"] == js["n_devices"] == 4
    assert set(ts["timings_s"]) == set(js["timings_s"])
    assert ts["parity"]["pairs_over_threshold"] > 0


@pytest.mark.parametrize("writer", ["jax_single_device", "torch_mesh"])
def test_mesh_checkpoints_cross_packages(toy_fasta, tmp_path, writer):
    """A mesh run resumes from a JAX single-device checkpoint directory,
    and a JAX single-device run from a mesh run's (the artifacts do not
    depend on the device layout): the resumed run skips the sweep."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh

    cfg = PipelineConfig(**TOY)
    mesh = make_mesh(4, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    if writer == "jax_single_device":
        first = jrun(toy_fasta, cfg, checkpoint_dir=ckpt)
        second = trun(toy_fasta, cfg, checkpoint_dir=ckpt, mesh=mesh)
    else:
        first = trun(toy_fasta, cfg, checkpoint_dir=ckpt, mesh=mesh)
        assert "sweep" in first.timings
        second = jrun(toy_fasta, cfg, checkpoint_dir=ckpt)
    assert "sweep" not in second.timings and "index" not in second.timings
    _same(first, second)


def test_port_never_imports_jax(toy_fasta):
    """In a fresh interpreter (this one has jax from conftest) the port's
    whole pipeline and CLI run without loading jax."""
    code = (
        "import sys\n"
        "from uniprot_kmer_based_clustering_tpu_torch import cluster_fasta\n"
        "from uniprot_kmer_based_clustering_tpu_torch.cli import main\n"
        f"r = cluster_fasta({toy_fasta!r}, device='cpu', engine='mxu', "
        "tile=16, strip=32, threshold=2)\n"
        "assert r.pairwise.pairs.shape[0] > 0\n"
        f"assert main(['run', {toy_fasta!r}, '--device', 'cpu', "
        "'--out', sys.argv[1]]) == 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX_OK')\n"
    )
    out_dir = os.path.join(os.path.dirname(toy_fasta), "nojax_out")
    proc = subprocess.run(
        [sys.executable, "-c", code, out_dir], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout


def test_cuda_without_gpu_raises(toy_fasta, tmp_path):
    """No silent fallback: asking for CUDA where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trun(toy_fasta, PipelineConfig(**TOY))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmain(["run", toy_fasta, "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_cli_accepts_cpu_and_profile(toy_fasta, tmp_path, capsys):
    """--cpu is --device cpu (no GPU is asked for, so none is missed), and
    --profile DIR runs the pipeline under torch.profiler and leaves a
    Chrome trace there; the artifacts are those of a plain run."""
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    plain, prof = str(tmp_path / "plain"), str(tmp_path / "prof")
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", plain]) == 0
    assert tmain(["run", toy_fasta, "--cpu", "--profile",
                  str(tmp_path / "trace"), "--out", prof]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    ps, pp, pc = _cli_outputs(plain)
    fs, fp, fc = _cli_outputs(prof)
    assert fp == pp and fc == pc and fs["device"] == "cpu"
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cluster_fasta_api(toy_fasta):
    from uniprot_kmer_based_clustering_tpu_torch import cluster_fasta

    got = cluster_fasta(toy_fasta, device="cpu", **TOY)
    _same(jrun(toy_fasta, PipelineConfig(**TOY)), got)
    agg = cluster_fasta(toy_fasta, device="cpu", cluster="agglomerative",
                        min_shared=2, **TOY)
    want = jrun(toy_fasta, PipelineConfig(cluster="agglomerative",
                                          min_shared=2, **TOY))
    _same(want, agg)
    assert np.array_equal(agg.dendrogram, want.dendrogram)
    assert len(agg.dendrogram) > 0 and got.dendrogram is None


@pytest.mark.parametrize("flags,n_devices", [
    (["--mesh-shape", "2x4"], (8, 8)),
    (["--mesh-shape", "1x2", "--dump-kmers"], (2, 2)),
    (["--shard-axis", "kmers"], (8, 1)),
    (["--devices", "2", "--shard-axis", "kmers"], (2, 2)),
], ids=["2x4", "1x2-dump-kmers", "kmers", "kmers-2"])
def test_cli_mesh_layouts_match_jax_cli(toy_fasta, tmp_path, capsys, flags,
                                        n_devices):
    """The 2-D ring (--mesh-shape HxC) and the k-axis layout
    (--shard-axis kmers) on CPU shards against the JAX CLI's --cpu runs on
    its virtual devices: pairs.tsv, clusters.tsv (and pair_kmers.tsv)
    byte for byte; stats.json's parity, clusters and stage names.
    --shard-axis kmers with no count spans every device: the JAX
    package's 8 virtual ones, the port's one CPU shard."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout, *flags]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout,
                  *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    js, jp, jc = _cli_outputs(jout)
    ts, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts["parity"] == js["parity"] and ts["clusters"] == js["clusters"]
    assert (js["n_devices"], ts["n_devices"]) == n_devices
    assert set(ts["timings_s"]) == set(js["timings_s"])
    assert ts["parity"]["pairs_over_threshold"] > 0
    if "--dump-kmers" in flags:
        with open(os.path.join(jout, "pair_kmers.tsv"), "rb") as f:
            want = f.read()
        with open(os.path.join(tout, "pair_kmers.tsv"), "rb") as f:
            assert f.read() == want and want


def test_cli_mesh_shape_and_kmers_are_exclusive(toy_fasta, tmp_path):
    """--mesh-shape with --shard-axis kmers exits with the JAX CLI's
    message, before any output, in both packages."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    flags = ["--mesh-shape", "2x2", "--shard-axis", "kmers"]
    for main, dev in ((jmain, ["--cpu"]), (tmain, ["--device", "cpu"])):
        out = tmp_path / main.__module__.split(".")[0]
        with pytest.raises(SystemExit, match="mutually exclusive sharding "
                                             "layouts"):
            main(["run", toy_fasta, *dev, "--out", str(out), *flags])
        assert not out.exists()


@pytest.mark.parametrize("layout", ["2d", "kaxis"])
def test_layout_checkpoints_cross_packages(toy_fasta, tmp_path, layout):
    """A 2-D or k-axis mesh run resumes from a JAX single-device
    checkpoint directory, and a JAX single-device run from the mesh run's
    own: the resumed run skips the index and the sweep."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
    )

    cfg = PipelineConfig(**TOY)
    mesh = (make_mesh_2d(2, 2, device="cpu") if layout == "2d"
            else make_mesh(4, axis="k", device="cpu"))
    j_dir, t_dir = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    j1 = jrun(toy_fasta, cfg, checkpoint_dir=j_dir)
    t2 = trun(toy_fasta, cfg, checkpoint_dir=j_dir, mesh=mesh)
    assert "sweep" not in t2.timings and "index" not in t2.timings
    _same(j1, t2)
    t1 = trun(toy_fasta, cfg, checkpoint_dir=t_dir, mesh=mesh)
    assert "sweep" in t1.timings
    j2 = jrun(toy_fasta, cfg, checkpoint_dir=t_dir)
    assert "sweep" not in j2.timings and "index" not in j2.timings
    _same(t1, j2)


# The root-importable names docs/API.md lists, by subpackage ("" is the
# package root). Left out: the make_ring_* / make_kaxis_* closures, which
# the port does not keep (ROADMAP, "Not to port": nothing is compiled
# ahead).
API_NAMES = {
    "": ["cluster_fasta", "PipelineConfig"],
    "io": ["read_fasta", "ProteinTable"],
    "kmers": ["encode_kmers", "encode_kmers_device", "decode_kmer",
              "build_index", "KmerIndex", "pack_bitsets",
              "pack_bitsets_device", "BitsetMatrix", "VirtualBitsetMatrix",
              "append_to_index", "AMINO_ACIDS", "residues_to_indices"],
    "similarity": ["pairwise_similarity", "PairwiseResult", "extract_pairs",
                   "extract_pairs_fused", "query_shared_kmers",
                   "QueryServer", "packed_key", "packed_pair",
                   "pairs_as_array", "unpack_pairs"],
    "ops": ["sweep_pallas", "sweep_xla", "pairwise_counts_xla", "sweep",
            "ROW_STAT_NAMES", "upper_triangle_tiles"],
    "parallel": ["init_distributed", "make_mesh", "make_mesh_2d",
                 "pad_for_mesh",
                 "stage_mesh_inputs", "stage_mesh_inputs_csr",
                 "sweep_extract_stream_mesh", "sharded_pairwise_similarity",
                 "sharded_pairwise_similarity_2d",
                 "sharded_pairwise_similarity_kaxis",
                 "sharded_extract_pairs", "sharded_pairwise_fused",
                 "doc_freq_psum"],
    "models": ["connected_components", "connected_components_device",
               "connected_components_sharded", "agglomerative_cluster",
               "agglomerative_cluster_device", "AgglomerativeResult"],
    "align": ["align_pairs", "diamond_available", "align_pairs_sw",
              "sw_scores_device", "sw_ends_and_starts_device",
              "sw_align_host", "LocalAlignment"],
    "utils": ["StageTimers"],
}


@pytest.mark.parametrize("sub", sorted(API_NAMES))
def test_subpackage_roots_export_the_api(sub):
    """Every name above imports from the subpackage root of both
    packages, and the port's is a callable or value of the same kind."""
    import importlib

    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("uniprot_kmer_based_clustering_tpu"
                                   + suffix)
    tmod = importlib.import_module("uniprot_kmer_based_clustering_tpu_torch"
                                   + suffix)
    for name in API_NAMES[sub]:
        want, got = getattr(jmod, name), getattr(tmod, name)
        assert isinstance(got, type) == isinstance(want, type), name
        assert callable(got) == callable(want), name
        if callable(got):
            assert got.__module__.split(".")[0] == (
                "uniprot_kmer_based_clustering_tpu_torch"), name


def test_run_pipeline_takes_the_mesh_fourth(toy_fasta, monkeypatch):
    """run_pipeline's positional arguments are the JAX function's
    (fasta, config, checkpoint_dir, mesh, echo_timings, stop_after), with
    ``device`` last: a mesh passed fourth runs the mesh path."""
    import inspect

    from uniprot_kmer_based_clustering_tpu.pipeline import (
        run_pipeline as jrun_,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        sharded as tsharded,
    )

    jparams = list(inspect.signature(jrun_).parameters)
    tparams = list(inspect.signature(trun).parameters)
    assert tparams[: len(jparams)] == jparams and tparams[-1] == "device"
    calls = []
    real = tsharded.sharded_pairwise_similarity

    def spy(mesh, *a, **kw):
        calls.append(mesh.size)
        return real(mesh, *a, **kw)

    monkeypatch.setattr(tsharded, "sharded_pairwise_similarity", spy)
    cfg = PipelineConfig(**TOY)
    got = trun(toy_fasta, cfg, None, make_mesh(2, device="cpu"))
    assert calls == [2]
    _same(got, jrun(toy_fasta, cfg))
