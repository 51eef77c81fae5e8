"""Where a resume of the out-of-core mesh, and a batch served on a mesh,
spend their time.

Every mesh's four shards sit on the one card (``make_mesh(devices=[cuda]
* 4)``), so a mesh's seconds are the sum over its shards.

1. Resume: the 30,000-protein synthetic corpus (``chip_smoke.write_fasta``)
   from the CSR source under ``chip_smoke.STREAM_SMALL_BUDGET`` a shard,
   on the mesh and on one device: a run without checkpoints, a run with
   them, a kill after 2 groups and its resume. Each line gives the wall
   seconds and the engine's trace (stage, dispatch, drain, checkpoint,
   grouped-redo and fetch seconds), and the resume also the grouped
   extractor's own trace. Every run's results must equal the first's.
2. Mesh serving: batches of 1, 64 and 256 queries of the 10,619 corpus on
   four row shards, split into the host pack, the pinned fill, the
   query copies to the shards, ``blocked_counts`` of each shard, the
   gather to the first shard, the fetch of the full counts and the host
   scan; each part between two synchronisations, the mean of 5 batches
   after 2. Beside it, the whole ``query`` call of the mesh server and
   of the single-device server.

    python3 scripts/stream_mesh_split.py      (from the repo root)
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from uniprot_kmer_based_clustering_tpu_torch.ops import stream  # noqa: E402
from uniprot_kmer_based_clustering_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    stream_mesh,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_to_first,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity import (  # noqa: E402
    query as q,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointStore,
)

D = 4
REPS, WARMUP = 5, 2


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a[:2] + a[3:],
                                                    b[:2] + b[3:]))


def _trace_line(tr):
    return json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in tr.items()})


def resume_split(dev, tmp, state30):
    table, index, bitset = state30
    cls = np.asarray(table.amr_class_ids, np.int32)
    mesh = make_mesh(devices=[dev] * D)
    budget = chip_smoke.STREAM_SMALL_BUDGET
    store = CheckpointStore(os.path.join(tmp, "ckpt"))

    def src():
        return stream.CSRBlockSource(index.incidence_protein,
                                     index.incidence_rank, bitset.n_pad,
                                     bitset.w_pad)

    def run(engine, label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if engine == "mesh":
                out = stream_mesh.sweep_extract_stream_mesh(
                    mesh, cls, table.n, chip_smoke.THRESHOLD,
                    block_source=src(), hbm_budget_bytes=budget, **kw)
            else:
                out = stream.sweep_extract_stream(
                    None, cls, table.n, chip_smoke.THRESHOLD, device=dev,
                    block_source=src(), hbm_budget_bytes=budget, **kw)
        except RuntimeError as e:
            if "fault injection" not in str(e):
                raise
            out = None
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tr = (stream_mesh.last_mesh_trace if engine == "mesh"
              else stream.last_onepass_trace)
        print(f"SPLIT resume {engine} {label}: {secs:.6f} s; trace "
              f"{_trace_line(tr) if out is not None else 'killed'}",
              flush=True)
        return out, tr

    for engine in ("mesh", "single device"):
        ref, _ = run(engine, "no checkpoints")
        key = engine.replace(" ", "-")
        out, _ = run(engine, "checkpointed", checkpoint_store=store,
                     checkpoint_key=key + "-full")
        if not _same(out, ref):
            raise AssertionError(f"{engine}: checkpointed run differs")
        run(engine, "killed after 2 groups", checkpoint_store=store,
            checkpoint_key=key, fail_after_groups=2)
        out, tr = run(engine, "resumed", checkpoint_store=store,
                      checkpoint_key=key)
        if not _same(out, ref) or tr.get("groups_skipped") != 2:
            raise AssertionError(f"{engine}: the resume differs")
        print(f"SPLIT resume {engine} grouped redo trace "
              f"{_trace_line(stream.last_grouped_trace)}", flush=True)


def serving_split(dev, state10):
    table, index, bitset = state10
    seqs = [table.seq(i) for i in range(table.n)]
    mesh = make_mesh(devices=[dev] * D)
    msrv = q.QueryServer(index, bitset, mesh=mesh)
    srv = q.QueryServer(index, bitset, mode="device", device=dev)
    th = chip_smoke.THRESHOLD

    def timed(parts, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return out

    for size in (1, 64, chip_smoke.QUERY_BATCH):
        parts = {}
        whole = {"mesh query": 0.0, "single-device query": 0.0}
        for rep in range(WARMUP + REPS):
            batch = seqs[rep * size : (rep + 1) * size]
            p = {} if rep < WARMUP else parts
            qwords = timed(p, "host pack", lambda: q.pack_query_bitsets(
                index, batch, bitset.w_pad))
            qp = timed(p, "pinned fill",
                       lambda: msrv._query_rows(qwords, q._bucket(size)))
            qs = timed(p, "query copies", lambda: [
                qp.to(d, non_blocking=True) for d in mesh.devices])
            cs = timed(p, "blocked_counts (4 shards)", lambda: [
                q.blocked_counts(x, b, w) for x, b, w in zip(
                    qs, msrv._shard_blocks, msrv._shard_wts)])
            counts = timed(p, "gather", lambda: gather_to_first(cs, mesh))
            host = timed(p, "fetch", lambda: counts[: bitset.n, :size]
                         .t().contiguous().cpu().numpy())
            timed(p, "host scan", lambda: [
                np.nonzero(host[i] > th)[0] for i in range(size)])
            for name, s in (("mesh query", msrv),
                            ("single-device query", srv)):
                got = timed(p if rep >= WARMUP else {}, name,
                            lambda: s.query(batch, threshold=th))
                if rep >= WARMUP:
                    whole[name] += p.pop(name)
        line = ", ".join(f"{k} {1e3 * v / REPS:.3f} ms"
                         for k, v in parts.items())
        print(f"SPLIT serving batch {size}: {line}; whole call: mesh "
              f"{1e3 * whole['mesh query'] / REPS:.3f} ms, single device "
              f"{1e3 * whole['single-device query'] / REPS:.3f} ms "
              f"({len(got)} answers)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA GPU visible to torch", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        states = {}
        for n in (chip_smoke.N_PROTEINS, chip_smoke.N_SCALE):
            fasta = os.path.join(tmp, f"{n}.fasta")
            chip_smoke.write_fasta(fasta, n)
            states[n] = chip_smoke.host_state(fasta)
        serving_split(dev, states[chip_smoke.N_PROTEINS])
        resume_split(dev, tmp, states[chip_smoke.N_SCALE])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
