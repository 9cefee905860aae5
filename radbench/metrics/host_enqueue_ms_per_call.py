"""Front end (drivers/rfmip.py, drivers/allsky.py, parallel/streaming.py):
self time of the port's ``enqueue`` spans (radbench/spans.py: queueing
work for the card, e.g. ``rte.prep``, ``rte.kernel.lw``, ``rte.step``),
milliseconds a call."""

from radbench.spans import ms_per_call


def read(t):
    return ms_per_call(t, "enqueue")
