"""Host link (parallel/streaming.py, drivers/gcm.py): self time of the
port's ``rte.wait`` spans, the host blocked on the card, milliseconds a
call."""

from radbench.spans import ms_per_call


def read(t):
    return ms_per_call(t, "wait")
