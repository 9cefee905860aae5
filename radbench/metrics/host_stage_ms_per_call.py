"""Host link (parallel/streaming.py, the drivers' copies): self time of the
port's ``stage`` spans (radbench/spans.py: ``rte.h2d``, ``rte.ring``,
``rte.stage``, ``rte.d2h``), milliseconds a call."""

from radbench.spans import ms_per_call


def read(t):
    return ms_per_call(t, "stage")
