"""Ranks (parallel/distributed.py ``RankGroup``): rank 0's time in its
``rte.rank.barrier`` spans, waiting at the host-side barrier for the other
ranks to finish their share of the step, milliseconds a call; None where
the window holds no such span (no rank group)."""

SPAN = "rte.rank.barrier"


def read(t):
    waits = [float(e["dur"]) for e in t.host
             if e.get("cat") == "user_annotation" and e["name"] == SPAN]
    if not waits:
        return None
    return sum(waits) * 1e-3 / t.calls
