"""Device: the share of the card's idle time in the profiled window that
no span of the port's host stages covers (radbench/spans.py), percent."""

from radbench.spans import idle_unattributed_share


def read(t):
    return idle_unattributed_share(t)
