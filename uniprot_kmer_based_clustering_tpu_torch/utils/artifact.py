"""Round-stamped bench artifacts (the JAX package's ``utils/artifact.py``).

Every bench prints exactly one JSON line; this helper also mirrors that
line to ``BENCH_<name>_r<NN>.json`` at the repository root when
``UKC_BENCH_ROUND`` is set. Each artifact carries a ``provenance`` block:
the reproduction command, the card it ran on, the git commit of the
tree and the timestamp.

The port's benches name their artifacts ``torch_…``
(``BENCH_torch_engines_r05.json``), so no port run can overwrite an
artifact of the JAX package; :func:`write_bench_artifact` refuses any
other name.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import time
from typing import Optional

PREFIX = "torch_"


def _provenance() -> dict:
    env_bits = []
    for var in ("UKC_BENCH_ROUND", "UKC_BENCH_FASTA", "UKC_BENCH_N",
                "UKC_BENCH_DEVICE", "UKC_BENCH_REPS", "UKC_ENGINES_ON_CPU",
                "UKC_SCALE_N", "UKC_SCALE_K", "UKC_SCALE_TEMPLATES",
                "UKC_SCALE_MUTDIV", "UKC_SCALE_BLOCK", "UKC_SCALE_STRIP",
                "UKC_SCALE_DEVIDX", "UKC_SCALE_FUSED", "UKC_SCALE_STREAM",
                "UKC_SCALE_STREAM_ONLY", "UKC_SCALE_STREAM_BUDGET",
                "UKC_SCALE_STREAM_REPS",
                "UKC_BENCH_ENGINES", "UKC_POD_DEVICES", "UKC_QUERY_N"):
        if os.environ.get(var):
            env_bits.append(f"{var}={shlex.quote(os.environ[var])}")
    cmd = " ".join(env_bits + [shlex.quote(sys.executable)]
                   + [shlex.quote(a) for a in sys.argv])
    prov = {
        "repro_command": cmd,
        "written_utc": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        ),
        "captured_by": "bench script (utils/artifact.py) — re-run "
                       "repro_command to re-derive",
    }
    try:
        prov["git_commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        prov["git_commit"] = None
    prov.update(device_provenance())
    return prov


def device_provenance() -> dict:
    """The card the bench ran on: its name and power limit as nvidia-smi
    reads them, ``torch.__version__`` and the device count. CUDA is
    never initialised here: without a CUDA context already made by the
    bench, the device is ``cpu``."""
    prov = {"device": "cpu", "power_limit": None, "n_devices": 0,
            "torch": None}
    torch = sys.modules.get("torch")
    if torch is None:
        return prov
    prov["torch"] = torch.__version__
    if not torch.cuda.is_initialized():
        return prov
    prov["device"] = torch.cuda.get_device_name(0)
    prov["n_devices"] = torch.cuda.device_count()
    prov["power_limit"] = nvidia_smi("power.limit")
    return prov


def nvidia_smi(fields: str) -> Optional[str]:
    """``nvidia-smi --query-gpu=FIELDS`` for the first card, or None where
    nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def write_bench_artifact(
    name: str, line: dict, repo_dir: Optional[str] = None
) -> Optional[str]:
    """Write ``line`` to BENCH_<name>_r<NN>.json; returns the path, or
    None when UKC_BENCH_ROUND is unset (ad-hoc runs leave no artifact).
    A ``provenance`` block (repro command, card, git commit, UTC
    timestamp) is added unless the caller already supplied one. ``name``
    must start with ``torch_``."""
    if not name.startswith(PREFIX):
        raise ValueError(
            f"bench artifact name {name!r} must start with {PREFIX!r}: "
            "the other names belong to the JAX package's artifacts"
        )
    rnd = os.environ.get("UKC_BENCH_ROUND")
    if not rnd:
        return None
    if repo_dir is None:
        # utils/ -> package -> repo root
        repo_dir = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    if "provenance" not in line:
        line = {**line, "provenance": _provenance()}
    path = os.path.join(repo_dir, f"BENCH_{name}_r{int(rnd):02d}.json")
    with open(path, "w") as f:
        json.dump(line, f, indent=2)
        f.write("\n")
    return path
