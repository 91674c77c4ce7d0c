"""Approximate blocking: minhash-LSH candidates and a q-gram similarity tier.

The port of splink_tpu/approx/. Every exact blocking rule is an equality
conjunction over key codes, so a record with a typo in each blocking key
is unreachable by training and serving alike. This package adds the recall
tier, on one device:

  * :mod:`.minhash` — per-record minhash signatures over q-gram sets (the
    exact gram codes of ``ops/qgram.py``) with LSH banding, as functions
    on tensors;
  * :mod:`.lsh` — LSH-bucket candidates through the device sort-join tier
    (``blocking_device.py``), q-gram Jaccard verification on the device,
    and progressive emission: candidates ranked by estimated similarity
    and emitted best first under an explicit ``approx_pair_budget``.

Opt in with ``approx_blocking: true``; the tier composes with the exact
rules (a pair any exact rule produced is never emitted again) and backs
the serving fallback (``serve/index.py``): a query whose exact keys hit no
bucket falls back to LSH-bucket candidates tagged ``approx=True``.
"""

from .lsh import (  # noqa: F401
    ApproxConfig,
    approx_block_into,
    approx_columns,
    build_approx_plan,
    generate_approx_candidates,
)
from .minhash import (  # noqa: F401
    band_key_arrays,
    factorise_band_codes,
    hash_params,
    minhash_signatures,
)
