"""device_ms_per_request.serve (ms): the device's busy time over the
profiled slice divided by its requests. Layer: ``models/`` (the generator's
forward). Moves ``serve_img_per_s``."""


def read(run):
    if not run.events or not run.requests:
        return None
    return 1e3 * run.busy_s / len(run.requests)
