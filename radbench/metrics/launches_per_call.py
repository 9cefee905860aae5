"""Front end (drivers/rfmip.py, drivers/gcm.py): device kernels, copies and
memsets launched, over the profiled calls."""


def read(t):
    if not t.device:
        return None
    return len(t.device) / t.calls
