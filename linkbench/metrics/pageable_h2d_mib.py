"""``pageable_h2d_mib``: MiB a job copied to the card from pageable host
memory (the program's ``h2d_pageable_bytes`` counter)."""

from linkbench.metrics._program import counter


def read(run):
    return counter(run, "h2d_pageable_bytes", 2.0**-20)
