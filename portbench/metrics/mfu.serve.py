"""mfu.serve (%): the least time of the generator's forward for the
patches requested in the profiled slice (padding rows do not count, so
padding shows as waste) over the slice's wall time. Layer: the whole
generator forward. Moves ``serve_img_per_s``."""


def read(run):
    patches = sum(n for _, _, n in run.requests)
    if not patches or run.slice_s <= 0 or not run.least_unit_s:
        return None
    return 100.0 * run.least_unit_s * patches / run.slice_s
