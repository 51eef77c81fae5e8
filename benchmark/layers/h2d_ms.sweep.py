"""``h2d_ms.sweep``: device milliseconds of host-to-device copies a job,
summed over the cards (``state.bitset_to_torch``; on a mesh
``stage_mesh_inputs``)."""

from _util import per_job_ms


def read(run):
    if run.trace is None:
        return None
    return per_job_ms(run, run.trace.device_seconds(name_has=("Memcpy HtoD",)))
