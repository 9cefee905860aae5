"""Front end (drivers/rfmip.py, drivers/gcm.py, parallel/streaming.py):
spans of work made again every call that could be made once
(radbench/spans.py REBUILDS: the Planck table, the solar source, the
replicated nets, the staging ring, the kernels' kept nets and weight
splits), over the profiled calls."""

from radbench.spans import rebuilds_per_call


def read(t):
    return rebuilds_per_call(t)
