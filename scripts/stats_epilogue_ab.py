#!/usr/bin/env python3
"""Time the port's statistics epilogue (K1, K2) and the sweeps around it
on one CUDA GPU, for one checkout or for two in turns.

    python3 scripts/stats_epilogue_ab.py              # this checkout
    python3 scripts/stats_epilogue_ab.py --root DIR   # the checkout at DIR
    python3 scripts/stats_epilogue_ab.py --ab BASE    # BASE, this, this, BASE

One run imports the package of its checkout, builds its kernels and, on
data drawn on the device from a seed at the main paths' shapes, measures

- K1 on the strip-0 block [1536, 10752] at (0, 0) (n 10,619, tile 512)
  and K2 on the (0, 3584) block [3584, 3584] of the 30,000-protein scan:
  kernel-only time (``chip_smoke.kernel_only_ms``: L2 flushed by a read,
  and for the record by a write, events around the launch alone, median
  of 50), back-to-back calls of the
  public wrapper and of the accumulate-into wrapper where the checkout
  has one (``chip_smoke.cuda_ms``), and the needed-bytes bound; beside
  them a device copy of the strip-0 block (read + write, L2 cold) as the
  streaming rate the card reaches, and a one-int fill as the floor of the
  kernel-only method;
- the epilogue of one sweep: what the strip sweep launches for its
  epilogue on each of the 7 strips, and the scan on each of its 45 steps,
  summed (back-to-back device time of each);
- the warm strip ``sweep_mxu`` at N_pad 10,752 x 7,680 words and the warm
  scan sweep at 32,256 x 28,416 words (host clock around a synchronise).

The kernel-only launch and the per-sweep epilogue follow the checkout's
epilogue entries: the tile-list entries ``ukc_stats_epilogue`` and
``ukc_stats_epilogue_traced`` (outputs zeroed outside the timed window;
the sweep's index copy and scatter around each K1 launch, and the
merge after each K2 launch) or the accumulate-into wrappers
``stats_from_counts_into`` and ``stats_from_counts_traced_into``.

Each run prints one JSON line. ``--ab`` runs the two checkouts as
subprocesses in the order BASE, this, this, BASE on the same card and
prints both runs of each beside each other.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "uniprot_kmer_based_clustering_tpu_torch"
N10, NPAD10, W10, STRIP10 = 10619, 10752, 7680, 1536
N30, NPAD30, W30, BS30 = 30000, 32256, 28416, 3584
TILE = 512


def _smoke():
    """chip_smoke.py of this checkout, loaded by path so that the package
    under test is the one of ``--root``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _classes(n_pad, n, gen):
    import torch

    cls = torch.randint(0, 15, (n_pad,), dtype=torch.int32, device="cuda",
                        generator=gen)
    cls[n:] = -1
    return cls


def _words(rows, n, w, gen):
    """Random packed words at 1/8 bit density, rows past n zero; and the
    count over which ~1% of pairs lie."""
    import torch

    def draw():
        return torch.empty((rows, w), dtype=torch.int32,
                           device="cuda").random_(generator=gen)

    words = draw()
    words &= draw()
    words &= draw()
    words[n:] = 0
    mean = 31 * w / 64  # random_() draws 31 bits a word
    return words, int(mean + 2.33 * (mean * 63 / 64) ** 0.5)


def run(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        _build,
        bitmul,
        stats,
    )

    if not os.path.abspath(stats.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {stats.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU visible to torch")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _build.load_kernels()
    out = {"root": root, "card": smoke.nvidia_smi_line(),
           "build_s": time.perf_counter() - t0}
    tile_list = "ukc_stats_epilogue" in _build._SIGNATURES
    out["entries"] = "tile-list" if tile_list else "accumulate-into"
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def i32(*shape, hi=12):
        return torch.randint(0, hi, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    # K1: strip 0 of the 10,619-protein strip schedule
    n, s, j = N10, STRIP10, NPAD10
    counts, cls = i32(s, j), _classes(j, n, gen)
    kw = dict(i_off=0, j_off=0, n=n, threshold=10, tile=TILE)
    ti, tj = stats.stats_tiles(s, j, 0, 0, TILE)
    if tile_list:
        tiles = torch.from_numpy(np.stack([ti, tj], axis=1)).to(dev)
        rs = torch.zeros((s, 8), dtype=torch.int32, device=dev)
        th = torch.zeros((len(ti), 2), dtype=torch.int32, device=dev)

        def k1():
            lib.ukc_stats_epilogue(
                counts.data_ptr(), j, cls.data_ptr(), cls.data_ptr(),
                tiles.data_ptr(), len(ti), TILE, 0, 0, n, 10, 1,
                rs.data_ptr(), th.data_ptr(), stream)

        def k1_zero():
            rs.zero_()
            th.zero_()
    else:
        rs = torch.empty((s, 8), dtype=torch.int32, device=dev)
        bh = torch.zeros((s // TILE, j // TILE, 2), dtype=torch.int32,
                         device=dev)
        k1_zero = None

        def k1():
            stats.stats_from_counts_into(counts, cls[:s], cls, rs, bh, **kw)

    out["k1_kernel_ms"] = smoke.kernel_only_ms(k1, prepare=k1_zero)
    out["k1_kernel_wflush_ms"] = smoke.kernel_only_ms(k1, prepare=k1_zero,
                                                      flush="write")
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    out["floor_ms"] = smoke.kernel_only_ms(lambda: tiny.fill_(0))
    copy = torch.empty_like(counts)
    out["copy_ms"] = smoke.kernel_only_ms(lambda: copy.copy_(counts))
    out["copy_tbs"] = 2 * counts.numel() * 4 / out["copy_ms"] / 1e9
    del copy
    out["k1_call_ms"] = smoke.cuda_ms(
        lambda: stats.stats_from_counts(counts, cls[:s], cls, **kw))
    out["k1_into_call_ms"] = None if tile_list else smoke.cuda_ms(k1)
    out["k1_bound_ms"] = smoke.epilogue_bound_ms(s, j, 0, 0, n,
                                                 8 * s + 2 * len(ti))
    del counts

    # K1 over the 7 strips, as the strip sweep launches it
    nb = j // TILE
    row_stats = torch.empty((j, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
    strip_ms = 0.0
    for i0 in range(0, j, s):
        c, gb = i32(s, j - i0), i0 // TILE
        ca, cb = cls[i0 : i0 + s], cls[i0:]
        kw_s = dict(kw, i_off=i0, j_off=i0)
        if tile_list:
            def epi():
                rs, th, (lti, ltj, _) = stats.stats_from_counts(
                    c, ca, cb, **kw_s)
                sel_i = torch.from_numpy(gb + lti.astype(np.int64)).to(dev)
                sel_j = torch.from_numpy(gb + ltj.astype(np.int64)).to(dev)
                block_hits[sel_i, sel_j] = th
                row_stats[i0 : i0 + s] = rs
        else:
            def epi():
                stats.stats_from_counts_into(
                    c, ca, cb, row_stats[i0 : i0 + s],
                    block_hits[gb:, gb:], **kw_s)
        strip_ms += smoke.cuda_ms(epi)
        del c
    out["k1_sweep_ms"] = strip_ms

    # K2: the (0, 3584) block of the 30,000-protein scan, then every step
    n, s = N30, BS30
    counts, cls = i32(s, s), _classes(NPAD30, n, gen)
    ca, cb = cls[:s], cls[s : 2 * s]
    kw = dict(n=n, threshold=10, tile=TILE)
    if tile_list:
        rs = torch.zeros((s, 8), dtype=torch.int32, device=dev)
        bh = torch.zeros((s // TILE, s // TILE, 2), dtype=torch.int32,
                         device=dev)

        def k2():
            lib.ukc_stats_epilogue_traced(
                counts.data_ptr(), s, s, ca.data_ptr(), cb.data_ptr(), TILE,
                0, s, n, 10, 1, rs.data_ptr(), bh.data_ptr(), stream)

        def k2_zero():
            rs.zero_()
            bh.zero_()
    else:
        rs = torch.zeros((s, 8), dtype=torch.int32, device=dev)
        bh = torch.zeros((s // TILE, s // TILE, 2), dtype=torch.int32,
                         device=dev)
        k2_zero = None

        def k2():
            stats.stats_from_counts_traced_into(counts, ca, cb, rs, bh, 0, s,
                                                **kw)

    out["k2_kernel_ms"] = smoke.kernel_only_ms(k2, prepare=k2_zero)
    out["k2_kernel_wflush_ms"] = smoke.kernel_only_ms(k2, prepare=k2_zero,
                                                      flush="write")
    out["k2_call_ms"] = smoke.cuda_ms(
        lambda: stats.stats_from_counts_traced(counts, ca, cb, 0, s, **kw))
    out["k2_into_call_ms"] = None if tile_list else smoke.cuda_ms(k2)
    out["k2_bound_ms"] = smoke.epilogue_bound_ms(
        s, s, 0, s, n, 8 * s + 2 * (s // TILE) ** 2)

    nb = NPAD30 // TILE
    row_stats = torch.zeros((NPAD30, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
    ns = NPAD30 // s
    scan_ms = 0.0
    for i0, j0 in (np.stack(np.triu_indices(ns), axis=1) * s).tolist():
        ca, cb = cls[i0 : i0 + s], cls[j0 : j0 + s]
        if tile_list:
            def epi():
                rs, bh = stats.stats_from_counts_traced(counts, ca, cb, i0,
                                                        j0, **kw)
                bitmul.accumulate_pair_block(row_stats, block_hits, rs, bh,
                                             i0, j0, block=TILE)
        else:
            def epi():
                stats.stats_from_counts_traced_into(
                    counts, ca, cb, row_stats[i0 : i0 + s],
                    block_hits[i0 // TILE:, j0 // TILE:], i0, j0, **kw)
        scan_ms += smoke.cuda_ms(epi)
    out["k2_sweep_ms"] = scan_ms
    del counts, row_stats, block_hits

    # the warm sweeps
    words, thr = _words(NPAD10, N10, W10, gen)
    cls = _classes(NPAD10, N10, gen)
    out["sweep10_s"], res = smoke.best_seconds(
        lambda: bitmul.sweep_mxu(words, cls, N10, thr))
    out["sweep10_hits"] = int(res[1].sum())
    del words, res
    words, thr = _words(NPAD30, N30, W30, gen)
    cls = _classes(NPAD30, N30, gen)
    out["scan30_s"], res = smoke.best_seconds(
        lambda: bitmul.sweep_mxu(words, cls, N30, thr), reps=2, warmup=1)
    out["scan30_hits"] = int(res[1].sum())
    return out


def ab(base: str) -> int:
    """BASE, this, this, BASE as subprocesses; both runs of each side by
    side."""
    runs = []
    for root in (base, HERE, HERE, base):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root],
            capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    b, t = (runs[0], runs[3]), (runs[1], runs[2])
    print(f"card: {runs[0]['card']}; base {b[0]['entries']} entries, this "
          f"{t[0]['entries']} entries")
    for key in runs[0]:
        if key in ("root", "card", "entries", "build_s"):
            continue
        print(f"{key}: base {b[0][key]} / {b[1][key]}; this {t[0][key]} / "
              f"{t[1][key]}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed (default: this)")
    ap.add_argument("--ab", metavar="BASE",
                    help="compare the checkout at BASE with this one")
    args = ap.parse_args()
    if args.ab:
        return ab(os.path.abspath(args.ab))
    print(json.dumps(run(os.path.abspath(args.root))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
