"""Engine, host policy: the engine's seconds in its host-policy phases
(schedule with admit, draft, batch_assemble, postprocess and the front
end's own work), summed over the requests that finished inside the window
(the window's opening requests included), each over its own life from
admission to finish, over the sum of those lives (the program's record,
``harness/records.py``)."""

from bench.harness import records


def read(run):
    return records.phase_pct(run, records.HOST_POLICY)
