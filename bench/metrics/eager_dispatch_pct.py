"""Runner, eager dispatch: the host's seconds issuing eager steps
(``ModelRunner.step``, the ``device_dispatch`` phase), summed over the
requests that finished inside the window (the window's opening requests
included), each over its own life from admission to finish, over the sum
of those lives (the program's record, ``harness/records.py``).

The share holds host time that the device overlaps: the host issues a
step's ops while the device runs the ones before them, and blocks when
the launch queue is full. It bounds from above the host's hold on the
device; the device's idle under ``device_dispatch`` is the part that
holds the device back."""

from bench.harness import records


def read(run):
    return records.phase_pct(run, records.EAGER_DISPATCH)
