"""``setup_s``: process start to the first timed job (imports, the
kernels' libraries, the input from the seed, one warm-up job)."""


def read(run):
    return run.setup_s
