"""Front end (drivers/rfmip.py, drivers/gcm.py, parallel/streaming.py):
self time of the port's ``prep`` spans (radbench/spans.py: host Python
and numpy, e.g. ``rte.canon``, ``rte.pack``), milliseconds a call."""

from radbench.spans import ms_per_call


def read(t):
    return ms_per_call(t, "prep")
