"""Gas optics (gasoptics/lut_gas_optics.py, ops/cuda/lut_gas_optics.py):
the least time the lookup-table gas optics of the profiled calls needs
(the ``lut_lw`` and ``lut_sw`` parts of the cell's work,
radbench/counts_lut.py) over the device time launched under the port's
``rte.lut.*`` spans, percent."""

from radbench.counts import least_seconds
from radbench.launched import launched_under

PARTS = ("lut_lw", "lut_sw")


def read(t):
    ops = launched_under(t, "rte.lut.")
    parts = [t.work[p] for p in PARTS if p in t.work]
    if not ops or not parts:
        return None
    seconds = sum(float(e["dur"]) for e in ops) * 1e-6
    return 100.0 * sum(least_seconds(*p) for p in parts) / seconds
