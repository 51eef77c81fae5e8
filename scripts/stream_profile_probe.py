"""Does ``cli run --profile DIR`` trace the card?

Runs the port's ``cli run --engine stream --profile DIR`` on a synthetic
3,000-protein corpus (``chip_smoke.write_fasta``) on the CUDA device and
counts the events of the Chrome trace that ``torch.profiler`` wrote: all
events by category, the kernel events with their device microseconds, and
the statistics-epilogue (K2) kernels among them. Exits non-zero when the
trace holds no kernel event.

    python3 scripts/stream_profile_probe.py      (from the repo root)
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from uniprot_kmer_based_clustering_tpu_torch.cli import main  # noqa: E402


def probe() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "f.fasta")
        chip_smoke.write_fasta(fasta, 3000)
        rc = main(["run", fasta, "--out", os.path.join(tmp, "o"),
                   "--profile", os.path.join(tmp, "p"), "--engine", "stream"])
        with open(os.path.join(tmp, "p", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2 = sum(1 for e in kernels if "stats" in e.get("name", "")
             or "epilogue" in e.get("name", ""))
    print(f"PROFILE rc {rc} events {len(events)} by category {cats}")
    print(f"PROFILE kernel events {len(kernels)} device us "
          f"{sum(e.get('dur', 0) for e in kernels)}")
    print(f"PROFILE K2 kernels {k2}")
    return 0 if rc == 0 and kernels else 1


if __name__ == "__main__":
    raise SystemExit(probe())
