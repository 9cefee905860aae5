"""Host link (parallel/streaming.py, the drivers' copies): device time of
the host-to-device copies, milliseconds a call."""


def read(t):
    ms = sum(float(e["dur"]) for e in t.device
             if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]) * 1e-3
    return ms / t.calls if ms > 0 else None
