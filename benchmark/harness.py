"""One run of one cell: corpus, set-up, measured window, reference check
and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in ``configs/<config>.json``; its
traffic in ``traffic/<traffic>.json``, which names the entry
``entries/<entry>.py`` that drives the program; each end-to-end metric in
``end_to_end/<metric>.py`` and each per-layer metric in
``layers/<metric>.py``. Adding a cell, a configuration, a traffic mix or
a metric adds files and entries and edits none.

The window is a closed loop: one client runs the entry's job back to
back until ``--seconds`` have passed, so the last job ends a little
after. Every job's answer is kept and held against the plain reference
once the window has closed (``compare.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(HERE, "entries"),
                os.path.join(HERE, "layers"), ROOT]

import compare  # noqa: E402
import corpus  # noqa: E402
import tracing  # noqa: E402

# top-level module names that no run may have loaded once its window has
# closed: JAX, and the JAX package the port was made from (compared as
# whole names, since the port's own name begins with it)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "uniprot_kmer_based_clustering_tpu")
KERNEL_COUNTERS = {
    "K1": ("ops.stats", "stats_from_counts_into"),
    "K2": ("ops.stats", "stats_from_counts_traced_into"),
    "K3": ("ops.tri_mxu", "tri_mxu_sweep"),
    "K4": ("ops.popcount", "popcount_sweep"),
}
PORT = "uniprot_kmer_based_clustering_tpu_torch"
# the reference's answers, by configuration and seed (see reference_answer)
CACHE_DIR = os.path.join(HERE, ".cache", "reference")
# where the cells run; the harness's tests drive the same run on the CPU
DEVICE = "cuda"


class CellError(RuntimeError):
    """The run cannot measure its cell: no result is printed."""


@dataclasses.dataclass
class Run:
    """What the metric readers read about one run."""

    cell: dict
    config: dict
    traffic: dict
    kind: str
    n: int
    tile: int
    jobs: int
    window_s: float
    job_seconds: list
    timings: list
    setup_s: float
    peak_bytes: int
    trace: Optional[tracing.Trace] = None


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<benchmark>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise CellError(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec: dict, workload: str):
    """(cell, configuration, traffic) of ``workload`` in ``spec``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(spec: dict, cell: dict, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those with no ``workloads`` key and those that list
    it."""
    return [m for m in spec[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def pipeline_config(config: dict):
    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig

    return PipelineConfig(**config["pipeline"])


def kernel_launches() -> dict:
    import importlib

    out = {}
    for k, (mod, fn) in KERNEL_COUNTERS.items():
        out[k] = getattr(importlib.import_module(f"{PORT}.{mod}"),
                         fn).launches
    return out


def nvidia_smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw,"
             "power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def reference_of(config: dict, traffic: dict):
    """The plain reference of ``config``: (its module, the keyword
    arguments of its ``answer``).

    A configuration names its reference with ``"reference": "<name>"``,
    the module ``reference/<name>.py``, whose answer is called one way
    for every reference: ``answer(seq_buf, offsets, classes,
    pipeline=<the pipeline block>, with_clusters=<whether the entry
    clusters>)``. A configuration without the key has
    ``reference/kmer_pairs.py``'s answer, with the arguments it has
    always had. Both also take ``count_dtype``, the control's
    narrowing. A module may add numbers to the comparison
    (``CHECKS``, see ``compare.judge``)."""
    p = config["pipeline"]
    with_clusters = traffic["entry"] == "pipeline"
    name = config.get("reference")
    if name is None:
        return (load_module("reference", "kmer_pairs"),
                dict(k=p["k"], threshold=p["threshold"],
                     cross_amr_only=p["cross_amr_only"],
                     with_components=with_clusters))
    return (load_module("reference", name),
            dict(pipeline=p, with_clusters=with_clusters))


def reference_cache_path(config: dict, traffic: dict, seed: int) -> str:
    """Where the reference's answer for ``config`` and ``seed`` is kept:
    under a digest of the configuration, of whether the entry clusters
    and of the sources that make the corpus and the answer:
    ``kmer_pairs.py`` for a configuration that names no reference, every
    file of ``reference/`` for one that does."""
    import hashlib

    files = [os.path.join("reference", "kmer_pairs.py")]
    if config.get("reference") is not None:
        files = sorted(os.path.join("reference", f)
                       for f in os.listdir(os.path.join(HERE, "reference"))
                       if f.endswith(".py"))
    h = hashlib.sha256(json.dumps([config, traffic["entry"] == "pipeline"],
                                  sort_keys=True).encode())
    for src in ["corpus.py"] + files:
        with open(os.path.join(HERE, src), "rb") as f:
            h.update(f.read())
    return os.path.join(CACHE_DIR,
                        f"{config['name']}.{seed}.{h.hexdigest()[:16]}.npz")


def reference_answer(config: dict, traffic: dict, seed: int, seq_buf,
                     offsets, classes) -> dict:
    """The plain reference's answer for this corpus. It is kept in
    ``.cache/reference`` inside the benchmark's folder
    (:func:`reference_cache_path`), so that a later run of the same
    configuration and seed reads it instead of computing it again; only
    this function writes there."""
    import numpy as np

    path = reference_cache_path(config, traffic, seed)
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    mod, kwargs = reference_of(config, traffic)
    ref = mod.answer(seq_buf, offsets, classes, **kwargs)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **ref)
    os.replace(tmp, path)
    return ref


def measure(spec: dict, workload: str, seed: int, seconds: float,
            traced: bool, *, t_start: Optional[float] = None):
    """Run ``workload`` once on ``DEVICE``: returns (result line, info
    line, checks)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, traffic = cell_parts(spec, workload)
    parts = {"process_to_corpus_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    seq_buf, offsets, classes = corpus.synth_proteins(config["corpus"], seed)
    tmp = tempfile.mkdtemp(prefix="ukc-bench-")
    try:
        fasta = os.path.join(tmp, "corpus.fasta")
        corpus.write_fasta(fasta, seq_buf, offsets, classes)
        parts["corpus_s"] = time.perf_counter() - t

        t = time.perf_counter()
        entry = load_module("entries", traffic["entry"]).Entry(
            fasta, pipeline_config(config), traffic, DEVICE)
        parts["program_setup_s"] = time.perf_counter() - t
        parts.update({f"program_setup.{k}": v
                      for k, v in entry.setup_timings.items()})
        cards = entry.cards
        on_cuda = bool(cards) and entry.device_type == "cuda"

        t = time.perf_counter()
        with torch.profiler.record_function(tracing.JOB_SPAN):
            entry.job()
        parts["warmup_job_s"] = time.perf_counter() - t
        setup_peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
                         default=0) if on_cuda else 0
        setup_s = time.perf_counter() - t_start

        smi_before = nvidia_smi() if on_cuda else None
        answers, failures, ends, timings = [], [], [], []
        if on_cuda:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
        launches0 = kernel_launches()
        prof = None
        if traced:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities,
                                          record_shapes=True)
            prof.start()
        t0 = time.perf_counter()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            while time.perf_counter() - t0 < seconds:
                try:
                    with torch.profiler.record_function(tracing.JOB_SPAN):
                        a = entry.job()
                except Exception as e:  # a failed job counts, the loop goes on
                    failures.append(f"{type(e).__name__}: {e}")
                    continue
                ends.append(time.perf_counter())
                answers.append(a)
                timings.append(a.get("timings", {}))
        if prof is not None:
            prof.stop()
        t_end = ends[-1] if ends else time.perf_counter()
        launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
        smi_after = nvidia_smi() if on_cuda else None
        window_peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
                          default=0) if on_cuda else 0
        entry.close()
        del entry
        if on_cuda:
            torch.cuda.empty_cache()

        kind = torch.cuda.get_device_name(cards[0]) if on_cuda else "cpu"
        run = Run(cell=cell, config=config, traffic=traffic, kind=kind,
                  n=int(config["corpus"]["n"]),
                  tile=pipeline_config(config).tile,
                  jobs=len(answers), window_s=t_end - t0,
                  job_seconds=[b - a for a, b in zip([t0] + ends, ends)],
                  timings=timings, setup_s=setup_s, peak_bytes=window_peak)
        e2e = {m["name"]: (m, load_module("end_to_end", m["name"]).read(run))
               for m in metrics_of(spec, cell, "end_to_end")}
        metrics, extra = {}, {}
        if traced:
            run.trace = tracing.capture(prof, [c.index for c in cards]
                                        if on_cuda else [])
            del prof
            for m in metrics_of(spec, cell, "per_layer"):
                v = load_module("layers", m["name"]).read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if on_cuda:
                extra["busy_s"] = statistics.fmean(
                    run.trace.busy_s(c) for c in run.trace.cards)
                extra["window_s"] = run.trace.window_s
        else:
            for name, (m, v) in e2e.items():
                if v is not None:
                    metrics[name] = {"value": v, "unit": m["unit"]}

        t = time.perf_counter()
        ref = reference_answer(config, traffic, seed, seq_buf, offsets,
                               classes)
        reference_s = time.perf_counter() - t
        checks, wrong_jobs = compare.judge(
            answers, len(failures), ref,
            getattr(reference_of(config, traffic)[0], "CHECKS", {}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
           "count": len(set(cards)) if on_cuda else 0,
           "memory_peak_bytes": max(setup_peak, window_peak), **extra}
    result = {"correct": compare.passes(checks),
              "attempted": len(answers) + len(failures),
              "failed": len(failures) + wrong_jobs,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None and on_cuda:
        result["breakdown"] = tracing.breakdown(run.trace)
    result["checks"] = checks
    stages = sorted({k for t in timings for k in t})
    info = {
        "workload": workload, "seed": seed, "jobs": run.jobs,
        "setup_parts": parts,
        "launches_per_job": {k: v / max(1, len(answers) + len(failures))
                             for k, v in launches.items()},
        "stage_s_mean": {k: statistics.fmean(t.get(k, 0.0) for t in timings)
                         for k in stages},
        "job_s": ([min(run.job_seconds), statistics.median(run.job_seconds),
                   max(run.job_seconds)] if run.job_seconds else None),
        "end_to_end": {k: v for k, (_, v) in e2e.items()},
        "nvidia_smi": {"before": smi_before, "after": smi_after},
        "reference_s": reference_s,
        "failures": failures[:3],
    }
    return result, info, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_json(ROOT, "BENCHMARK.json")
        cell, _, _ = cell_parts(spec, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise CellError("torch sees no CUDA card; the benchmark never "
                            "runs on the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise CellError(f"{args.workload} needs {cell['chips']} cards, "
                            f"torch sees {torch.cuda.device_count()}")
        result, info, checks = measure(spec, args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       t_start=t_start)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    left = forbidden_modules()
    if left:
        print(f"benchmark: the run loaded {left}, which the port must not "
              "load", file=sys.stderr, flush=True)
        return 3
    print(json.dumps({"info": info}), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
