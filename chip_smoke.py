#!/usr/bin/env python3
"""Smoke run of splink_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA string kernels from splink_tpu_torch/csrc,
holds each against its plain PyTorch version on the card at every variant's
widths (8 to 264, uint8 and 32-bit codepoints; Jaro-Winkler dense and
masked), holds the masked Jaro-Winkler launch against the masked plain
version at survivor densities 0, 0.2%, 50% and 100%, drives the resident
train-and-score path at full size through the public entry point (1,000,000
seeded rows, ~16M candidate pairs, two Jaro-Winkler columns, one
Levenshtein, one numeric, one exact; every Jaro-Winkler launch there must
be one masked launch per column and batch), checks the output, checks the
masked kernel on the main path's first batch and its real survivor mask,
times each kernel and the whole two-phase step of one batch, runs a
20,000-row subset on the card and on the CPU for parity, runs columns of
max_string_length 64 and 96 on the card and on the CPU (the multi-word and
generic kernel variants, the W = 2 Jaro-Winkler form timed against the
generic one), and round-trips the model through JSON. It builds the native
host library with g++ and holds each of its functions (the encoder, the
self and cross joins) to its numpy plain version at the main path's shapes,
array for array, and requires the main path's encode and blocking to have
gone through it. It drives the term-frequency path at the main path's full
size (two flagged columns: the u-probability fold in scoring, then the
ex-post aggregation on the card), and holds it to the CPU: the linker on a
subset, and the device aggregation on the main path's own token ids. It
drives the kinds path at the main path's full size (the same rows and
pairs; double metaphone, q-gram Jaccard, q-gram cosine, numeric and a
hand-written CASE expression that only the general CASE compiler handles,
whose jaro_winkler_sim and levenshtein(substr(...)) launch the dense
kernels on every batch), holds those launches' inputs against the plain
versions, times one batch of each q-gram form and of the CASE column, and
holds the kinds path on a subset against the CPU (equal gamma matrices,
probabilities within 1e-5, a bit-identical model JSON round trip). It
drives a job past the default max_resident_pairs at full size (the
``large`` phase: 4,000,000 rows, ~320M candidate pairs): training
through device pair generation (one masked Jaro-Winkler launch per name
column and one Levenshtein launch per batch), then through host blocking
feeding the overlap PatternStream (equal counts and parameters), then
the trained model's first 8 scored chunks, each checked against the
resident gamma program; and it holds every regime to the resident one
on the subset (``regimes_parity``: the pattern regime virtual and
materialised, the streamed regime of a custom comparison, checkpointed
EM and its resume after an injected fault bit for bit, the OOM fallback,
and the pattern regime on the card against the CPU). Every full-size path
blocks through the device sort-join tier (a tier counter says so); the
``blocking_device`` phase holds that tier to the host join (pair sets)
and to the device tier on the CPU (arrays, in order) at the main path's
size, with and without masks, times both tiers' parts, and holds the
bucket CSR to the host construction; ``large`` also trains through the
host join and times the device tier alone; the ``spill`` phase writes the
large job into the durable pair store and trains from it, kills a child
process (``chip_smoke.py --spill-child <dir> <out.json>``) at
``emit_segment`` and resumes it byte for byte, and holds the spill-fed
streamed EM to the streamed-G path bit for bit. The ``serve`` phase
freezes the main path's linker into a serving index (export, save, load,
warmup over the whole bucket menu and the brown-out tier), answers 10,000
typo'd queries in batches of 1,024 (two dense Jaro-Winkler launches and
one Levenshtein launch a batch), times ``candidate_gather`` and
``score_fused`` alone, serves 2,000 single records from 8 client threads
through LinkageService, and raises unless fused equals unfused, served
probabilities equal the offline ones (the TF engine's equal
``tf_match_probability``), a CPU engine over the same artifact agrees
within 1e-5, the indexes built with the device CSR, the host CSR and
out of core have one fingerprint, and no kernel library is built after
warmup. The ``approx`` phase drives the approximate tier (minhash-LSH
blocking) at bench.py's size: 50,000 base rows with near-unique names and
a twin of each whose first name and surname both carry a '#', blocked on
the names with ``approx_blocking`` into the main path's comparison
columns; it times the tier's stages, measures the recall of the twins at
the budget, unbudgeted and by the exact tier, and raises unless the
emitted pairs are the best-first top of every survivor, the card equals
the CPU on 5,000 base rows (unweighted and TF-weighted; a weighted lane
may part only at a near tie), and an index over those base rows serves
every garbled twin through its fallback, tagged ``approx``, with
probabilities ``==`` the offline ones, bit-identically after a save and a
load, with no kernel library built after warmup. The ``fleet`` phase,
right after ``serve``, runs over the serve phase's index, engine and
queries: it saves the engine's AOT library sidecar and starts three child
replicas (``chip_smoke.py --aot-child``) with empty build directories: A
from the sidecar with no nvcc or g++ reachable (0 builds, every library
restored), B without a sidecar (it builds), C from a sidecar with one
byte of one blob flipped (one ``corrupt_blob`` event, that library
built); each answers 1,024 queries ``==`` the parent and reports its
seconds from spawn to first answer. It then replays the 10,000 queries
through a WireServer and a RemoteReplica (submit and submit_many; every
delivered answer ``==`` the batch path's, two dense Jaro-Winkler launches
and one Levenshtein launch a service batch), measures 8 closed-loop
clients over the wire and in process, puts a ReplicaRouter over two more
replicas on the card, kills server A a third into a routed replay (no
request past its deadline, every delivered answer ``==``, a failover
counted), restarts it, partitions B from its accept site (a
``wire_accept`` fault in B's settings) until it heals and reconnects
(``wire_reconnect`` in the flight recorder), federates both replicas
(merged counters and histograms equal to the union, both in the
Prometheus text) and opens B's breaker for exactly one incident bundle.
The ``obs`` phase, after ``fleet``: the main path's training and scoring
again with ``telemetry_dir`` (parameters and scores bit-identical to the
telemetry-off run, one ``em_iteration`` record per update equal to the
history, ``pairs_blocked`` and ``gamma_histogram`` equal to the run's own,
a memory snapshot at every stage within the card's memory, ``python -m
splink_tpu_torch.obs summarize`` naming every stage; then telemetry off
and on in turns), ``profile_dir`` on the parity subset (one trace per
traced stage, both hand kernels' CUDA events in the gammas trace, a
profiled artifact saved and loaded), the quality profile over the main
path's 16.1M training pairs (equal to a host recount from the card's own
gammas and probabilities, the serve index's fingerprint unchanged), the
drift sketch over the serve phase's 10,000 queries (answers ``==`` the
sketch-off engine's, drained counts ``==`` a host oracle, no
synchronizing operation in its update), and the drift monitor in a
LinkageService (a clean replay below the alert PSI; ``city`` shifted fires
one ``drift_alert``, a flight dump in ``telemetry_dir`` and an alert naming
``gamma:city``). The ``analysis`` phase, after ``obs``: the trace
audit, the num audit and the perf audit (``splink_tpu_torch.analysis``)
on the card over all 29 registered kernels, against the committed
``cuda`` tier of ``perf_baselines.json`` and ``num_baselines.json``; any
finding raises. The ``jaro_winkler`` and ``levenshtein`` entries must
launch the hand kernels (their records carry the launches, and one call
of each adds one to ``strings_cuda.launches``); the phase's line lists
every perf cell's ``execute_ms`` and every kernel's host syncs.
Every phase prints one JSON line; any failed check raises. The last lines are the
kernel table, the card's name and power limit as nvidia-smi reports them,
and {"ok": true, "device": {...}}.

Imports nothing of JAX or splink_tpu. Exits non-zero without printing a
result when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N_ROWS = 1_000_000
SUBSET_ROWS = 20_000
SEED = 20261016
KERNEL_CHECK_PAIRS = 2_000_000
WIDE_CHECK_PAIRS = 100_000  # past width 32, so that the plain versions fit
CHECK_WIDTHS = (8, 24, 32, 40, 64, 128, 256, 264)
MASK_DENSITIES = (0.0, 0.002, 0.5, 1.0)  # masked-launch checks at 2M x 24
TIMING_RUNS = 15
STEP_RUNS = 51  # host-clock readings vary more than device times
HOST_RUNS = 5  # the native functions and their plain versions, host clock
TF_COLUMNS = ("first_name", "surname")
TF_RTOL = 1e-12  # the device aggregation, card against CPU (float64 sums)
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers one call's launch
L2_FLUSH_BYTES = 256 << 20  # read before each timed run: 5x the H100's 50 MB L2

# H100 SXM peaks (the on-chip measurement table): 3.35 TB/s HBM, 67 TFLOP/s
# FP32 outside the tensor cores. The table has no integer row: an FP32 FMA
# counts as two flops on 128 FP32 lanes per SM, and Hopper has 64 INT32
# lanes per SM, so the INT32 peak is a quarter of the FP32 flop rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

SETTINGS = {
    # bench.py's flagship settings, with city moved to levenshtein (so both
    # kernels run) and postcode taking over the exact comparison
    "link_type": "dedupe_only",
    "blocking_rules": ["l.blk = r.blk"],
    "comparison_columns": [
        {"col_name": "first_name", "num_levels": 3,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "surname", "num_levels": 3,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "city", "num_levels": 3,
         "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
        {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
         "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
        {"col_name": "postcode", "num_levels": 2, "comparison": {"kind": "exact"}},
    ],
}

# Long free-text columns: the multi-word kernel variants on the main path's
# entry points (width 64 = two 32-bit words; width 96 takes Jaro-Winkler's
# generic form)
WIDE_SETTINGS = {
    "link_type": "dedupe_only",
    "blocking_rules": ["l.blk = r.blk"],
    "comparison_columns": [
        {"col_name": "address", "num_levels": 3, "max_string_length": 64,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "notes", "num_levels": 3, "max_string_length": 96,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "employer", "num_levels": 3, "max_string_length": 64,
         "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
        {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
         "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
    ],
}

# Every comparison kind ported last, on the main path's rows and blocking:
# city's CASE is outside compat_sql's shapes, so the general CASE compiler
# evaluates it, launching the dense Jaro-Winkler kernel on every pair and
# Levenshtein on 4-character substrings
CITY_CASE = """CASE WHEN city_l IS NULL OR city_r IS NULL THEN -1
WHEN city_l = city_r THEN 3
WHEN jaro_winkler_sim(city_l, city_r) > 0.92 THEN 2
WHEN levenshtein(substr(city_l,1,4), substr(city_r,1,4)) <= 1
  OR jaccard_sim(Q3gramTokeniser(city_l), Q3gramTokeniser(city_r)) > 0.6 THEN 1
ELSE 0 END"""
KINDS_SETTINGS = {
    "link_type": "dedupe_only",
    "blocking_rules": ["l.blk = r.blk"],
    "comparison_columns": [
        {"col_name": "first_name", "num_levels": 3, "comparison": {"kind": "dmetaphone"}},
        {"col_name": "surname", "num_levels": 3,
         "comparison": {"kind": "qgram_jaccard", "q": 2, "thresholds": [0.7, 0.4]}},
        {"col_name": "postcode", "num_levels": 2,
         "comparison": {"kind": "qgram_cosine", "q": 3, "thresholds": [0.5]}},
        {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
         "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
        {"col_name": "city", "num_levels": 4, "case_expression": CITY_CASE},
    ],
}

# The main path's settings with term-frequency adjustment on both names
TF_SETTINGS = json.loads(json.dumps(SETTINGS))
for _col in TF_SETTINGS["comparison_columns"]:
    if _col["col_name"] in TF_COLUMNS:
        _col["term_frequency_adjustments"] = True

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _pool(rng, k, lo, hi, alphabet=LETTERS):
    lens = rng.integers(lo, hi + 1, k)
    codes = alphabet[rng.integers(0, len(alphabet), (k, hi))]
    return np.array(
        [codes[i, : lens[i]].tobytes().decode() for i in range(k)], dtype=object
    )


def _typo(rng, s):
    i = int(rng.integers(0, len(s)))
    c = chr(int(LETTERS[rng.integers(0, 26)]))
    op = int(rng.integers(0, 3))
    if op == 0:
        return s[:i] + c + s[i + 1:]
    if op == 1:
        return s[:i] + c + s[i:]
    return s[:i] + s[i + 1:] if len(s) > 1 else s + c


def make_people(n: int, seed: int, groups: int | None = None):
    """Seeded people table: names from pools of random 4-10 letter strings
    (5,000 first names, 20,000 surnames), ~10% planted duplicates carrying a
    one-character typo in a name or the city and sharing their source's
    block, ~2% nulls per column; ``blk`` uniform over ``groups`` groups
    (default n // 32)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_dup = n // 10
    n_base = n - n_dup
    digits = np.frombuffer(b"0123456789ABCDEFGHJKLMNPRSTUVWXY", np.uint8)
    pools = {
        "first_name": _pool(rng, 5_000, 4, 10),
        "surname": _pool(rng, 20_000, 4, 10),
        "city": _pool(rng, 2_000, 5, 12),
        "postcode": _pool(rng, 200_000, 6, 6, digits),
    }
    cols = {k: v[rng.integers(0, len(v), n_base)] for k, v in pools.items()}
    cols["dob"] = rng.integers(0, 30_000, n_base).astype(np.float64)
    cols["blk"] = rng.integers(0, groups or n // 32, n_base)
    src = rng.integers(0, n_base, n_dup)
    for k in cols:
        cols[k] = np.concatenate([cols[k], cols[k][src]])
    which = rng.integers(0, 3, n_dup)
    for r in range(n_dup):
        k = ("first_name", "surname", "city")[which[r]]
        cols[k][n_base + r] = _typo(rng, cols[k][n_base + r])
    for k in ("first_name", "surname", "city", "postcode", "dob"):
        cols[k] = cols[k].astype(object)
        cols[k][rng.random(n) < 0.02] = None
    cols["unique_id"] = np.arange(n)
    dup_of = np.concatenate([np.full(n_base, -1), src])
    return pd.DataFrame(cols), dup_of


def make_addresses(n: int, seed: int):
    """Seeded table of long values: ``address`` 20-60 letters and spaces
    (n // 4 distinct), ``employer`` 10-50 (n // 8), ``notes`` 40-90
    (n // 4), ``dob``; ~10% planted duplicates with a one-character typo in
    address, employer or notes, ~2% nulls, ``blk`` uniform over n // 32
    groups."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_dup = n // 10
    n_base = n - n_dup
    spaced = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def pool(k, lo, hi):
        p = _pool(rng, k, lo - 1, hi - 1, spaced)
        return np.array([chr(int(LETTERS[rng.integers(0, 26)])) + v for v in p], dtype=object)

    cols = {"address": pool(max(n // 4, 1), 20, 60)[rng.integers(0, max(n // 4, 1), n_base)],
            "employer": pool(max(n // 8, 1), 10, 50)[rng.integers(0, max(n // 8, 1), n_base)],
            "dob": rng.integers(0, 30_000, n_base).astype(np.float64),
            "blk": rng.integers(0, max(n // 32, 1), n_base),
            "notes": pool(max(n // 4, 1), 40, 90)[rng.integers(0, max(n // 4, 1), n_base)]}
    src = rng.integers(0, n_base, n_dup)
    for k in cols:
        cols[k] = np.concatenate([cols[k], cols[k][src]])
    which = rng.integers(0, 3, n_dup)
    for r in range(n_dup):
        k = ("address", "employer", "notes")[which[r]]
        cols[k][n_base + r] = _typo(rng, cols[k][n_base + r])
    for k in ("address", "employer", "notes", "dob"):
        cols[k] = cols[k].astype(object)
        cols[k][rng.random(n) < 0.02] = None
    cols["unique_id"] = np.arange(n)
    return pd.DataFrame(cols)


# ----------------------------------------------------------------------
# Kernel checks and timing
# ----------------------------------------------------------------------


def random_pairs(torch, n, width, wide, gen):
    """(s1, s2, l1, l2) on the card: strings over a small alphabet, s2 a
    mutated copy of s1 on half the pairs, lengths 0..width."""
    dev = "cuda"
    base = 0x4E00 if wide else ord("a")
    dtype = torch.int32 if wide else torch.uint8
    s1 = torch.randint(0, 8, (n, width), generator=gen, device=dev) + base
    noise = torch.randint(0, 8, (n, width), generator=gen, device=dev) + base
    keep = torch.rand((n, width), generator=gen, device=dev) < 0.8
    copy = torch.rand((n, 1), generator=gen, device=dev) < 0.5
    s2 = torch.where(copy & keep, s1, noise)
    l1 = torch.randint(0, width + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    l2 = torch.randint(0, width + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.arange(width, device=dev)[None, :]
    s1 = torch.where(pos < l1[:, None], s1, 0).to(dtype).contiguous()
    s2 = torch.where(pos < l2[:, None], s2, 0).to(dtype).contiguous()
    return s1, s2, l1, l2


def edge_pairs(torch):
    """The hand cases of the reference kernel tests
    (tests/test_strings_pallas.py), width 16."""
    cases = [("martha", "marhta"), ("dixon", "dicksonx"), ("jellyfish", "smellyfish"),
             ("", ""), ("", "abc"), ("abc", ""), ("a", "a"), ("ab", "ba"),
             ("abcdefgh", "abcdefgh"), ("crate", "trace"), ("dwayne", "duane"),
             ("aaaaaaaa", "aaaa"), ("kitten", "sitting"), ("flaw", "lawn"),
             ("a" * 16, "a" * 16), ("abcdefghijklmnop", "ponmlkjihgfedcba")]
    w = 16

    def enc(ss):
        b = np.zeros((len(ss), w), np.uint8)
        for i, s in enumerate(ss):
            b[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
        return torch.from_numpy(b).cuda()

    lens = lambda ss: torch.tensor([len(s) for s in ss], dtype=torch.int32).cuda()  # noqa: E731
    a, b = [x for x, _ in cases], [y for _, y in cases]
    return enc(a), enc(b), lens(a), lens(b)


def check_kernels(torch, strings, strings_cuda, args, gen):
    """Kernel vs plain version on the same card tensors, Jaro-Winkler also
    masked to a random half of the pairs; raises if they differ
    (Jaro-Winkler: torch.equal on float32; Levenshtein: exact)."""
    mask = torch.rand(args[0].shape[0], generator=gen, device="cuda") < 0.5
    jw_k = strings_cuda.jaro_winkler_cuda(*args)
    jw_p = strings.jaro_winkler_plain(*args)
    jw_mk = strings_cuda.jaro_winkler_cuda(*args, mask=mask)
    lev_k = strings_cuda.levenshtein_cuda(*args)
    lev_p = strings.levenshtein_plain(*args)
    torch.cuda.synchronize()
    shape = f"{tuple(args[0].shape)} {args[0].dtype}"
    if not torch.equal(jw_k, jw_p):
        bad = int((jw_k != jw_p).sum())
        raise AssertionError(f"jaro_winkler kernel differs from plain on {bad} pairs at {shape}")
    check_masked(torch, jw_mk, torch.where(mask, jw_p, 0.0), f"{shape}, half masked")
    if not torch.equal(lev_k, lev_p):
        bad = int((lev_k != lev_p).sum())
        raise AssertionError(f"levenshtein kernel differs from plain on {bad} pairs at {shape}")


def check_masked(torch, got, want, what):
    """The masked Jaro-Winkler launch against the masked plain version."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"masked jaro_winkler differs from plain on {bad} pairs: {what}")


def cuda_ms(torch, fn, runs=TIMING_RUNS, warmup=3, device_only=True):
    """Median milliseconds of fn() between two CUDA events, after warm-up.

    device_only: each run starts with a cold L2 (a 256 MB buffer is read
    first, so fn's inputs come from HBM as the bytes bound assumes), and
    the stream is held busy (torch.cuda._sleep, about 1 ms) so that the
    flush, the start event, fn's launches and the stop event are all queued
    before the card reaches them; the interval is then the card's time for
    fn's work alone. Otherwise the interval also holds the host's time to
    make the call (argument checks, allocation, the launch) and the L2
    keeps what the previous run left, which is how the kernel times before
    the redesign were taken."""
    if device_only:
        flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
            flush.max()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def jw_ops(torch, s1, l1, l2, mask=None):
    """The word operations of the kernel's algorithm for these inputs, per
    pair the mask keeps (every pair without one): each character of the
    shorter string (la) builds its match mask against the longer (lb) with
    ceil(lb / 4) SWAR compares for uint8 (lb compares for 32-bit
    codepoints) and takes 11 word operations for the window mask, the
    claim and the two sets; the prefix compares ceil(la / 4) words (la
    codepoints). The transposition walk, which depends on the matches, is
    left out, so this bounds the kernel's integer work from below."""
    la = torch.minimum(l1, l2).long()
    lb = torch.maximum(l1, l2).long()
    if s1.element_size() == 1:
        compares, prefix = (lb + 3) // 4, (la + 3) // 4
    else:
        compares, prefix = lb, la
    ops = torch.where(la > 0, la * (compares + 11) + prefix, 0)
    if mask is not None:
        ops = torch.where(mask, ops, 0)
    return int(ops.sum())


def jw_ops_window_scan(torch, s1, l1, l2, mask=None):
    """The count used before the redesign: character comparisons of the
    greedy eligibility scan, sum over i < min(l) of the window span clipped
    to [0, max(l)), at any width, over the pairs the mask keeps."""
    if mask is not None:
        l1, l2 = l1[mask], l2[mask]
    la = torch.minimum(l1, l2).long()
    lb = torch.maximum(l1, l2).long()
    w = torch.clamp(lb // 2 - 1, min=0)
    i = torch.arange(s1.shape[1], device=l1.device)[None, :]
    total = 0
    for c in range(0, len(la), 1 << 20):  # (rows, width) at a time
        a, b, w_ = la[c:c + (1 << 20), None], lb[c:c + (1 << 20), None], w[c:c + (1 << 20), None]
        span = torch.clamp(torch.minimum(i + w_ + 1, b) - torch.clamp(i - w_, min=0), min=0)
        total += int(torch.where(i < a, span, 0).sum())
    return total


def lev_ops(torch, s1, l1, l2):
    """The word operations of the kernel's algorithm for these inputs, per
    pair with both sides non-empty: the shorter string (lt) steps through
    the longer (lp); each step builds the match mask with ceil(lp / 4) SWAR
    compares for uint8 (lp compares for 32-bit codepoints) and advances
    ceil(lp / 32) words at 15 operations each. Every such operation is at
    least one instruction, so this bounds the kernel's integer work from
    below."""
    lt = torch.minimum(l1, l2).long()
    lp = torch.maximum(l1, l2).long()
    compares = (lp + 3) // 4 if s1.element_size() == 1 else lp
    per_step = compares + 15 * ((lp + 31) // 32)
    return int(torch.where(lt > 0, lt * per_step, 0).sum())


def lev_ops_one_word(torch, s1, l1, l2):
    """The count used before the redesign, for the one-word kernel: l1 * l2
    scalar compares plus 15 word operations per text character."""
    a, b = l1.long(), l2.long()
    return int(torch.where((a > 0) & (b > 0), a * b + 15 * a, 0).sum())


def res_usage(cuda_tool, libs):
    """Per kernel variant ("<kernel>/<u8|u32>/w<W>", w0 the generic form)
    the registers and stack frame bytes, read from the built libraries with
    ``cuobjdump -res-usage``."""
    names = {"levenshtein_kernel": "levenshtein", "levenshtein_generic_kernel": "levenshtein",
             "jaro_winkler_kernel": "jaro_winkler", "jaro_winkler_wide_kernel": "jaro_winkler"}
    pat = re.compile(r"\d(levenshtein_generic_kernel|levenshtein_kernel|"
                     r"jaro_winkler_wide_kernel|jaro_winkler_kernel)I([hj])(?:Li(\d+)E)?")
    out, current = {}, None
    for path in libs.values():
        text = subprocess.run([cuda_tool("cuobjdump"), "-res-usage", path],
                              capture_output=True, text=True, check=True).stdout
        for line in text.splitlines():
            if "Function" in line:
                m = pat.search(line)
                current = None
                if m:
                    w = m.group(3) or ("1" if m.group(1) == "jaro_winkler_kernel" else "0")
                    current = f"{names[m.group(1)]}/{'u8' if m.group(2) == 'h' else 'u32'}/w{w}"
            regs = re.search(r"REG:(\d+) STACK:(\d+)", line)
            if current and regs:
                out[current] = {"registers": int(regs.group(1)), "stack_bytes": int(regs.group(2))}
    return out


def measure(torch, name, plain_fn, kernel_fn, args, ops_fn):
    """Kernel vs plain version on ``args`` (s1, s2, l1, l2[, mask]):
    equality, median times, and the bound: the larger of the bytes moved
    (inputs once, output once; with a mask, the mask, the output and only
    the kept pairs' rows and lengths) over the HBM rate and the integer
    operations over the INT32 rate."""
    s1, s2, l1, l2 = args[:4]
    mask = args[4] if len(args) > 4 else None
    kw = {} if mask is None else {"mask": mask}
    got, want = kernel_fn(*args[:4], **kw), plain_fn(*args[:4], **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from plain on {tuple(s1.shape)}")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    n = s1.shape[0]
    pair_bytes = 2 * s1.shape[1] * s1.element_size() + 2 * 4
    kept = n if mask is None else int(mask.sum())
    nbytes = kept * pair_bytes + 4 * n + (0 if mask is None else n)
    ops = ops_fn(torch, s1, l1, l2, **kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: kernel_fn(*args[:4], **kw)),
        "call_ms": cuda_ms(torch, lambda: kernel_fn(*args[:4], **kw), device_only=False),
        "plain_ms": cuda_ms(torch, lambda: plain_fn(*args[:4], **kw), device_only=False),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": [n, s1.shape[1]],
        "dtype": str(s1.dtype).replace("torch.", ""),
        "pairs_computed": kept,
        "bytes": nbytes,
        "int_ops": ops,
    }


def host_ms(torch, fn, runs=STEP_RUNS, warmup=3):
    """Median host milliseconds of fn() from the call to a synchronize
    after it, and fn()'s last result."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def two_phase_step_ms(torch, gammas, pc, aux, thresholds):
    """One column's whole two-phase step on one batch (bound, survivors,
    kernel, levels): median host ms to a synchronize, and its levels."""
    return host_ms(torch, lambda: gammas._jw_two_phase(pc, aux, thresholds))


def bound_ms(torch, jw_bound, pc, aux):
    """The step's first part alone, the Jaro-Winkler upper bound of every
    pair of the batch: median host ms to a synchronize."""
    (cl, pl), (cr, pr) = aux
    return host_ms(torch, lambda: jw_bound.jw_upper_bound(cl, pl, cr, pr, pc.len_l, pc.len_r))[0]


def first_batch(torch, gammas, linker, column):
    """The main path's first pair batch of ``column`` on the card, as the
    gamma program builds it: (PairColumn, JW-bound aux lanes)."""
    prog = gammas.GammaProgram(linker.settings, linker._table, device="cuda")
    b = int(linker.settings["pair_batch_size"])
    idx = [torch.from_numpy(np.asarray(a[:b], np.int64)).cuda()
           for a in (linker._pairs.idx_l, linker._pairs.idx_r)]
    ctx = gammas.PairContext(prog._layout, prog._packed.index_select(0, idx[0]),
                             prog._packed.index_select(0, idx[1]))
    return ctx.col(column), ctx.jw_aux(column)


KERNELS = {
    # name: (replaces, plain, wrapper name, operation count)
    "jaro_winkler": ("splink_tpu/ops/strings_pallas.py:123", "jaro_winkler_plain",
                     "jaro_winkler_cuda", jw_ops),
    "levenshtein": ("splink_tpu/ops/strings_pallas.py:225", "levenshtein_plain",
                    "levenshtein_cuda", lev_ops),
}


def cuda_vs_cpu(splink_tpu_torch, strings_cuda, settings, df):
    """The same settings and rows through the linker on the card and on the
    CPU; with term-frequency columns, the ex-post adjustment too. Raises
    unless the pair sets and gamma matrices are equal and every probability
    column (match_probability, tf_match_probability,
    tf_adjusted_match_prob) within 1e-5. Returns the card's linker and
    frame, the CPU's linker, the largest difference of each probability
    column and the kernel variants the card's run launched."""
    runs = {}
    for dev in ("cuda", "cpu"):
        strings_cuda.variant_launches.clear()
        lk = splink_tpu_torch.Splink(json.loads(json.dumps(settings)), df=df, device=dev)
        frame = lk.get_scored_comparisons()
        if any(c.get("term_frequency_adjustments") for c in settings["comparison_columns"]):
            frame = lk.make_term_frequency_adjustments(frame)
        runs[dev] = (lk, frame, dict(strings_cuda.variant_launches))
    (gpu, gdf, variants), (cpu, cdf, cpu_variants) = runs["cuda"], runs["cpu"]
    if cpu_variants:
        raise AssertionError(f"the CPU run launched kernels: {cpu_variants}")
    if not (np.array_equal(gpu._pairs.idx_l, cpu._pairs.idx_l)
            and np.array_equal(gpu._pairs.idx_r, cpu._pairs.idx_r)):
        raise AssertionError("pair sets differ between cuda and cpu")
    if not np.array_equal(gpu._G, cpu._G):
        raise AssertionError("gamma matrices differ between cuda and cpu")
    if list(gdf.columns) != list(cdf.columns):
        raise AssertionError("frame columns differ between cuda and cpu")
    diffs = {}
    for col in ("match_probability", "tf_match_probability", "tf_adjusted_match_prob"):
        if col in gdf:
            diffs[col] = float(np.abs(gdf[col].to_numpy() - cdf[col].to_numpy()).max())
            if diffs[col] > 1e-5:
                raise AssertionError(f"{col} cuda vs cpu differs by {diffs[col]}")
    return gpu, gdf, cpu, diffs, variants


# ----------------------------------------------------------------------
# The native host library and the term-frequency path
# ----------------------------------------------------------------------


def host_median_ms(fn, runs=HOST_RUNS):
    """Median host milliseconds of fn() over ``runs`` calls after one
    warm-up, and fn()'s last result."""
    out = fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def native_vs_plain(native, name, args):
    """One native function against its plain version on ``args``: raises
    unless every output array is equal, order and dtype included; returns
    both median host times and the output sizes."""
    native_ms, got = host_median_ms(lambda: getattr(native, name)(*args))
    plain_ms, want = host_median_ms(lambda: getattr(native, f"{name}_plain")(*args))
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"native {name} differs from its plain version "
                                 f"({g.dtype} {g.shape} vs {w.dtype} {w.shape})")
    return {"native_ms": native_ms, "plain_ms": plain_ms,
            "out": [[list(g.shape), str(g.dtype)] for g in got]}


def native_phase(native, blocking, df, table):
    """Each native function at the main path's shapes: the encoder on the
    first_name column's 1,000,000 rows at width 16, the self join of the
    ``blk`` groups (the main path's rule), and the cross join of the same
    rows split in half."""
    vals = [v if isinstance(v, str) else "" for v in df["first_name"].tolist()]
    flat = np.frombuffer("".join(vals).encode("ascii"), np.uint8)
    offsets = np.zeros(len(vals) + 1, np.int64)
    np.cumsum([len(v) for v in vals], out=offsets[1:])
    out = {"encode_fixed_width": {"rows": len(vals), "width": 16,
                                  **native_vs_plain(native, "encode_fixed_width",
                                                    (flat, offsets, 16))}}
    codes = blocking._key_codes(table, ["blk"])
    rows = np.flatnonzero(codes >= 0).astype(np.int32)
    rows_sorted, _, starts, sizes = blocking._sort_groups(codes, rows)
    out["self_join_pairs"] = {"groups": len(sizes), **native_vs_plain(
        native, "self_join_pairs", (rows_sorted, starts, sizes))}
    half = len(rows) // 2
    lrows, lcodes, ls, lz = blocking._sort_groups(codes, rows[:half])
    rrows, rcodes, rs, rz = blocking._sort_groups(codes, rows[half:])
    _, li, ri = np.intersect1d(lcodes, rcodes, return_indices=True)
    out["cross_join_pairs"] = {"groups": len(li), **native_vs_plain(
        native, "cross_join_pairs", (lrows, ls[li], lz[li], rrows, rs[ri], rz[ri]))}
    return out


def zero_counts(strings_cuda, native, tf):
    from splink_tpu_torch import blocking

    for k in strings_cuda.launches:
        strings_cuda.launches[k] = 0
    strings_cuda.variant_launches.clear()
    for k in native.calls:
        native.calls[k] = 0
    for k in blocking.tiers:
        blocking.tiers[k] = 0
    tf.device_aggregations.clear()


def check_path_counts(what, strings_cuda, native, tier="device"):
    """Raise unless the path just driven launched every CUDA kernel, went
    through the native library for its encode, and blocked once through
    ``tier``: the device sort-join tier, or the host join (whose self join
    is the native library's)."""
    from splink_tpu_torch import blocking

    for k, v in strings_cuda.launches.items():
        if v <= 0:
            raise AssertionError(f"{what} launched no {k} kernel")
    if native.calls["encode_fixed_width"] <= 0:
        raise AssertionError(f"{what} did not call the native encode_fixed_width")
    want = {"device": int(tier == "device"), "host": int(tier == "host")}
    if blocking.tiers != want:
        raise AssertionError(f"{what} blocked through {blocking.tiers}, expected {want}")
    if tier == "host" and native.calls["self_join_pairs"] <= 0:
        raise AssertionError(f"{what} did not call the native self_join_pairs")


def check_unit_interval(df, col, dtype):
    v = df[col].to_numpy()
    if v.dtype != dtype or not np.isfinite(v).all() or (v < 0).any() or (v > 1).any():
        raise AssertionError(f"{col}: {v.dtype}, finite {bool(np.isfinite(v).all())}, "
                             f"range [{np.nanmin(v)}, {np.nanmax(v)}], expected {dtype} in [0, 1]")
    return v


# ----------------------------------------------------------------------
# The kinds path: q-gram, double metaphone and the general CASE compiler
# ----------------------------------------------------------------------


def kinds_host_seconds(data, qgram, df, table):
    """Host seconds of the kinds path's per-row preprocessing at full size:
    the ``__dm_first_name`` codes (once per distinct value) and their
    encoding, and the q-gram and charset row aux the packed table carries."""
    out = {}
    t0 = time.perf_counter()
    codes = data.double_metaphone_codes(df["first_name"])
    out["dmetaphone_codes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data.encode_string_column(codes)
    out["dmetaphone_encode_s"] = time.perf_counter() - t0
    for name, fn, args in (
        ("qgram_row_aux_surname_q2_s", qgram.qgram_row_aux, ("surname", 2)),
        ("qgram_row_aux_postcode_q3_s", qgram.qgram_row_aux, ("postcode", 3)),
        ("charset_row_aux_city_s", qgram.charset_row_aux, ("city",)),
    ):
        sc = table.strings[args[0]]
        t0 = time.perf_counter()
        fn(sc.bytes_, sc.lengths, sc.token_ids, *args[1:])
        out[name] = time.perf_counter() - t0
    return out


def qgram_bound(torch, s1, s2, q, aux_bytes):
    """The least time for one q-gram function on this batch: the bytes it
    must move (both sides' characters and lengths, the aux it reads, a
    float32 out) over the HBM rate, and its gram compares (one per window
    pair and code word: the cross matrix; ``self_terms`` adds the two
    per-side matrices of the self-contained forms) over the INT32 rate."""
    B, L = s1.shape
    nw = max(L - q + 1, 1)
    words = -(-q // (63 // (8 if s1.dtype == torch.uint8 else 21)))
    nbytes = 2 * B * L * s1.element_size() + 2 * 4 * B + aux_bytes + 4 * B

    def bound(self_terms):
        ops = B * nw * nw * words * (3 if self_terms else 1)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "int_ops": ops}

    return bound


def kinds_batch_timing(torch, gammas, qgram, case_compiler, linker):
    """Each q-gram form and the CASE column on the kinds path's first pair
    batch on the card: median device ms between events around the call
    (the host's launches included: these are eager PyTorch ops) and median
    host ms to a synchronize; the q-gram forms also on the CPU, where the
    results must equal the card's."""
    prog = gammas.GammaProgram(linker.settings, linker._table, device="cuda")
    b = int(linker.settings["pair_batch_size"])
    idx = [torch.from_numpy(np.asarray(a[:b], np.int64)).cuda()
           for a in (linker._pairs.idx_l, linker._pairs.idx_r)]
    ctx = gammas.PairContext(prog._layout, prog._packed.index_select(0, idx[0]),
                             prog._packed.index_select(0, idx[1]))
    b = idx[0].numel()
    sur, post = ctx.col("surname"), ctx.col("postcode")
    (m_l, n_l, _), (_, n_r, _) = ctx.qgram_aux("surname", 2)
    (_, _, x11), (_, _, x22) = ctx.qgram_aux("postcode", 3)
    city = linker.settings["comparison_columns"][4]
    forms = {
        "qgram_jaccard_masked/surname_q2": (
            qgram.qgram_jaccard_masked,
            (sur.chars_l, sur.chars_r, sur.len_l, sur.len_r, m_l, n_l, n_r, 2),
            qgram_bound(torch, sur.chars_l, sur.chars_r, 2, 4 * m_l.numel() + 8 * b)(False)),
        "qgram_cosine_masked/postcode_q3": (
            qgram.qgram_cosine_masked,
            (post.chars_l, post.chars_r, post.len_l, post.len_r, x11, x22, 3),
            qgram_bound(torch, post.chars_l, post.chars_r, 3, 8 * b)(False)),
        "qgram_cosine_distance/postcode_q3": (
            qgram.qgram_cosine_distance,
            (post.chars_l, post.chars_r, post.len_l, post.len_r, 3),
            qgram_bound(torch, post.chars_l, post.chars_r, 3, 0)(True)),
    }
    out = []
    for name, (fn, args, bound) in forms.items():
        got = fn(*args)
        want = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: the card's values differ from the CPU's")
        out.append({"name": name, "pairs": b, "shape": list(args[0].shape),
                    "event_ms": cuda_ms(torch, lambda: fn(*args), device_only=False),
                    "host_ms": host_ms(torch, lambda: fn(*args), runs=TIMING_RUNS)[0],
                    **bound})
    run = case_compiler.compile_case_expression(city["comparison"]["expr"], city["num_levels"])
    out.append({"name": "case_sql/city", "pairs": b,
                "event_ms": cuda_ms(torch, lambda: run(ctx), device_only=False),
                "host_ms": host_ms(torch, lambda: run(ctx), runs=TIMING_RUNS)[0]})
    return out


# ----------------------------------------------------------------------
# Main
# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# Jobs past max_resident_pairs: the large phase and the regimes' parity
# ----------------------------------------------------------------------

LARGE_ROWS = 4_000_000
LARGE_GROUPS = 25_000  # ~160 rows a block: ~320M candidate pairs
LARGE_STREAM_CHUNKS = 8
MAX_RESIDENT_PAIRS = 268_435_456  # the settings schema's default
VIRTUAL_RTOL = 1e-12  # virtual against materialised pairs, the reference's bound
PROFILE_BATCHES = 4


def params_state(linker) -> str:
    """The fitted parameters and their whole history as JSON text: equal
    strings mean bit-identical trajectories."""
    return json.dumps({"current": linker.params.params,
                       "history": linker.params.param_history}, sort_keys=True)


def max_rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) if a.size else 0.0


def virtual_batches(linker) -> int:
    """Batches of the virtual pass over the linker's plan (each rule in
    batches of min(pair_batch_size, next power of two >= its total))."""
    batch = int(linker.settings["pair_batch_size"])
    return sum(-(-rp.total // min(batch, 1 << max(int(rp.total - 1).bit_length(), 6)))
               for rp in linker._virtual.rules if rp.total)


def check_large_variants(strings_cuda, batches: int, what: str):
    """Every batch: one masked Jaro-Winkler launch per name column (two) and
    one Levenshtein launch (city), nothing else."""
    want = {"jaro_winkler/u8/w1/masked": 2 * batches, "levenshtein/u8/w1": batches}
    got = dict(strings_cuda.variant_launches)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    return got


def profile_virtual_batches(torch, pairgen, linker, n_batches=PROFILE_BATCHES):
    """``n_batches`` batches of the virtual pattern pass (decode, mask,
    gammas, ids, histogram), first timed alone (host clock to a
    synchronize, and CUDA events around the same loop), then under
    torch.profiler for the device's busy time per batch (the sum of its
    kernels' self times), the ops with the most device time and the
    kernel launches per batch. The idle share is 1 - busy / the untraced
    wall: the profiler's own host cost would inflate the traced wall."""
    from torch.profiler import ProfilerActivity, profile

    program = linker._ensure_pattern_program()
    fn = pairgen.make_virtual_pattern_fn(program, linker._virtual, 0)
    batch = int(linker.settings["pair_batch_size"])
    hist = torch.zeros(program.n_patterns + 1, dtype=torch.int64, device="cuda")
    qs = [torch.arange(b * batch, (b + 1) * batch, device="cuda") for b in range(n_batches + 1)]

    def run(batches):
        for q in batches:
            hist.add_(torch.bincount(fn(q), minlength=program.n_patterns + 1))

    run(qs[-1:])  # warm-up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(qs[:n_batches])
    stop.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_batches
    event_ms = start.elapsed_time(stop) / n_batches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(qs[:n_batches])
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in events) / 1e3 / n_batches
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return {"batches": n_batches, "pairs_per_batch": batch, "host_wall_ms_per_batch": wall,
            "event_ms_per_batch": event_ms, "device_busy_ms_per_batch": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall) if wall else None,
            "top_device_ops_ms_per_batch": {e.key[:80]: dev_us(e) / 1e3 / n_batches
                                            for e in top},
            "launches_per_batch": sum(e.count for e in events
                                      if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                   "cudaLaunchKernelExC")) / n_batches}


def large_phase(torch, splink_tpu_torch, strings_cuda, native, gammas, pairgen, reset,
                df, dup_of, main_dtypes, device="cuda"):
    """The regimes past max_resident_pairs at full size: a job whose pairs
    exceed the default max_resident_pairs trains through device pair
    generation (1); the same job through materialised pairs feeding the
    overlap PatternStream gives the same counts and parameters, its pairs
    emitted by the device sort-join tier (2) and by the host join (2b); the
    trained model streams its first scored chunks, each checked against the
    resident gamma program (3). Returns the phase's record and the virtual
    run's pattern counts and (lambda, m, u), which the spill phase holds
    its store-fed run to."""
    from splink_tpu_torch import blocking_device
    on_card = device == "cuda"
    out = {"rows": len(df), "groups": int(df["blk"].nunique())}
    settings = json.loads(json.dumps(SETTINGS))

    # 1: device pair generation, the histogram-only pattern pass and EM
    reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    virt = splink_tpu_torch.Splink(json.loads(json.dumps(settings)), df=df, device=device)
    virt.estimate_parameters()
    wall = time.perf_counter() - t0
    if not virt.device_pair_generation_active:
        raise AssertionError("the large job did not take device pair generation")
    counts = virt._pattern_counts
    pairs = int(counts.sum())
    if not (pairs > MAX_RESIDENT_PAIRS and virt._pair_bound > MAX_RESIDENT_PAIRS):
        raise AssertionError(f"{pairs} pairs, bound {virt._pair_bound}: not past "
                             f"max_resident_pairs {MAX_RESIDENT_PAIRS}")
    if virt._pairs is not None or virt._P_virtual is not None:
        raise AssertionError("the virtual training run kept per-pair state on the host")
    batches = virtual_batches(virt)
    variants = check_large_variants(strings_cuda, batches, "the virtual pass") if on_card else {}
    stage = dict(virt.stage_seconds)
    out["virtual"] = {
        "wall_s": wall, "stage_s": stage, "candidate_positions": virt._virtual.n_candidates,
        "pairs": pairs, "pair_bound": virt._pair_bound, "batches": batches,
        "distinct_patterns": int((counts > 0).sum()), "n_patterns": int(counts.size),
        "em_updates": int(virt._last_em_result.n_updates),
        "em_converged": bool(virt._last_em_result.converged),
        "pattern_pass_pairs_per_s": pairs / stage["gammas_patterns"],
        "pass_with_program_pairs_per_s": pairs / (stage["gammas_patterns"]
                                                  + stage["gamma_program"]),
        "variant_launches": variants, "launches": dict(strings_cuda.launches),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        "lambda": float(virt.params.params["λ"]),
    }

    # 2: materialised pairs feeding the overlap PatternStream, emitted by
    # the device sort-join tier ("auto" past AUTO_MIN_PAIRS on the card):
    # the same counts, the same parameters
    reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat = splink_tpu_torch.Splink({**json.loads(json.dumps(settings)),
                                   "device_pair_generation": "off"}, df=df, device=device)
    mat.estimate_parameters()
    mat_wall = time.perf_counter() - t0
    if mat.device_pair_generation_active or mat._P is None:
        raise AssertionError("the materialised run did not take the overlap PatternStream")
    if mat._pairs.n_pairs != pairs or not np.array_equal(mat._pattern_counts, counts):
        raise AssertionError("pattern counts differ between virtual and materialised pairs")
    rel = {k: max_rel_diff(a, b) for k, a, b in zip(
        ("lambda", "m", "u"), mat.params.to_arrays()[:3], virt.params.to_arrays()[:3])}
    if max(rel.values()) > VIRTUAL_RTOL:
        raise AssertionError(f"virtual vs materialised parameters differ: {rel}")
    mat_variants = {}
    n_mat_batches = -(-pairs // int(virt.settings["pair_batch_size"]))
    if on_card:
        mat_variants = check_large_variants(strings_cuda, n_mat_batches, "the materialised pass")
        check_path_counts("the large materialised path", strings_cuda, native, tier="device")
    out["materialised"] = {
        "wall_s": mat_wall, "stage_s": dict(mat.stage_seconds), "pairs": mat._pairs.n_pairs,
        "blocking_tier": "device", "blocking_device": dict(blocking_device.last_run),
        "counts_equal": True, "params_max_rel_diff": rel, "variant_launches": mat_variants,
        "native_calls": dict(native.calls),
        "host_pair_index_gb": 2 * mat._pairs.idx_l.nbytes / 1e9,
        "pattern_ids_gb": mat._P.nbytes / 1e9,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
    }
    del mat

    # 2b: the same through the host join (device_blocking "off"), so the
    # host join stays measured at full size
    reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hj = splink_tpu_torch.Splink({**json.loads(json.dumps(settings)),
                                  "device_pair_generation": "off", "device_blocking": "off"},
                                 df=df, device=device)
    hj.estimate_parameters()
    hj_wall = time.perf_counter() - t0
    if hj._pairs.n_pairs != pairs or not np.array_equal(hj._pattern_counts, counts):
        raise AssertionError("pattern counts differ between virtual pairs and the host join's")
    hj_rel = {k: max_rel_diff(a, b) for k, a, b in zip(
        ("lambda", "m", "u"), hj.params.to_arrays()[:3], virt.params.to_arrays()[:3])}
    if max(hj_rel.values()) > VIRTUAL_RTOL:
        raise AssertionError(f"virtual vs host-join parameters differ: {hj_rel}")
    if on_card:
        check_large_variants(strings_cuda, n_mat_batches, "the host-join pass")
        check_path_counts("the large host-join path", strings_cuda, native, tier="host")
    out["materialised_host_join"] = {
        "wall_s": hj_wall, "stage_s": dict(hj.stage_seconds), "pairs": hj._pairs.n_pairs,
        "blocking_tier": "host", "counts_equal": True, "params_max_rel_diff": hj_rel,
        "native_calls": dict(native.calls),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
    }
    if on_card:
        # 2c: the device tier alone on the same rows (no consumer): its own
        # parts at full size, beside the PatternStream it feeds in step 2
        from splink_tpu_torch import blocking

        hj._pairs = None
        dev_settings = {**hj.settings, "device_blocking": "on"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = blocking.block_using_rules(dev_settings, hj._table, device=device)
        alone_wall = time.perf_counter() - t0
        if alone.n_pairs != pairs:
            raise AssertionError(f"the device tier alone emitted {alone.n_pairs} pairs")
        del alone
        out["device_tier_alone"] = {
            "wall_s": alone_wall, **blocking_device.last_run,
            "decode_compact_ms": decode_compact_ms(torch, blocking_device, dev_settings,
                                                   hj._table, runs=1)}
    del hj

    # 3: the trained model's first scored chunks from the virtual stream
    reset()
    program = gammas.GammaProgram(virt.settings, virt._table, device=device)
    stream = virt.stream_scored_comparisons_after_em()
    chunk_ms, planted, probs = [], [], []
    for _ in range(LARGE_STREAM_CHUNKS):
        t0 = time.perf_counter()
        frame = next(stream)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        if [(c, str(t)) for c, t in frame.dtypes.items()] != main_dtypes:
            raise AssertionError("a streamed chunk's columns or dtypes differ from the "
                                 "resident path's frame")
        p = check_unit_interval(frame, "match_probability", np.float32)
        # unique_id is the row number in make_people's frames
        il, ir = (torch.from_numpy(frame[c].to_numpy().astype(np.int64)).to(device)
                  for c in ("unique_id_l", "unique_id_r"))
        G = program.gamma_batch(il, ir).cpu().numpy()
        for c, col in enumerate(SETTINGS["comparison_columns"]):
            if not np.array_equal(frame[f"gamma_{col['col_name']}"].to_numpy(), G[:, c]):
                raise AssertionError(f"streamed gamma_{col['col_name']} differs from the "
                                     "resident gamma program on the chunk's pairs")
        planted.append(dup_of[frame["unique_id_r"].to_numpy()] == frame["unique_id_l"].to_numpy())
        probs.append(p)
    stream.close()
    planted, probs = np.concatenate(planted), np.concatenate(probs)
    med, p99 = float(np.median(probs[planted])), float(np.quantile(probs[~planted], 0.99))
    if not med > p99:
        raise AssertionError(f"streamed chunks: planted median {med} vs other p99 {p99}")
    out["stream"] = {"chunks": LARGE_STREAM_CHUNKS, "pairs": int(len(probs)),
                     "chunk_host_ms": chunk_ms, "planted_pairs": int(planted.sum()),
                     "planted_median_p": med, "other_p99": p99,
                     "gammas_equal_resident_program": True,
                     "variant_launches": dict(strings_cuda.variant_launches)}
    if on_card:
        try:
            out["profile"] = profile_virtual_batches(torch, pairgen, virt)
        except Exception as e:  # noqa: BLE001 - a measurement, not a check
            out["profile"] = {"error": f"{type(e).__name__}: {e}"[:300]}
    out["large_path_launches"] = out["virtual"]["launches"]
    return out, counts, virt.params.to_arrays()[:3]


# ----------------------------------------------------------------------
# Device blocking and the durable pair store
# ----------------------------------------------------------------------

BLOCKING_RUNS = 3  # each tier, in turns; medians
SPILL_MAIN_CHUNK = 1 << 22  # four segments of the main path's 16.1M pairs
SPILL_KILL = "emit_segment@seq=2:kind=kill"  # after the second of four segments
SPILL_MAX_RESIDENT = 8_388_608  # the main path's pairs exceed it
# the second rule drops the first rule's pairs: its chunks are masked
MASKED_RULES = ["l.blk = r.blk", "l.postcode = r.postcode"]
SPILL_CUSTOM = {"custom_name": "postcode_custom", "custom_columns_used": ["postcode"],
                "num_levels": 2,
                "comparison": {"kind": "custom", "fn": "chip_smoke_postcode_exact"}}


def pair_keys(p) -> np.ndarray:
    """A pair index as sorted int64 keys i << 32 | j: equal arrays are equal
    pair sets."""
    return np.sort((np.asarray(p.idx_l).astype(np.int64) << 32) | np.asarray(p.idx_r))


def decode_compact_ms(torch, blocking_device, settings, table, runs=BLOCKING_RUNS):
    """Median host ms to a synchronize of the device tier's decode, masks
    and compaction of every chunk on the card, with no copy off it."""
    plan = blocking_device.build_device_plan(settings, table, device="cuda")
    ctx = blocking_device._emission_context(
        plan, int(settings.get("blocking_chunk_pairs") or blocking_device.DEFAULT_CHUNK_PAIRS))

    def decode_all():
        for r, rp in enumerate(plan.rules):
            bs = blocking_device._rule_batch(ctx, rp)
            for p0 in range(0, rp.total, bs):
                blocking_device._emit_chunk(plan, r, ctx, bs, p0, min(p0 + bs, rp.total), False)

    return host_ms(torch, decode_all, runs=runs, warmup=1)[0]


def masked_check(torch, blocking, blocking_device, settings, table, out_dir):
    """A masked rule set on the main path's rows: the second rule drops the
    first rule's pairs, so its chunks compact on the card (the packed
    layout) and carry a transfer digest computed there. The card's pairs
    equal the CPU device tier's array for array and the host join's as a
    set, and a 2-shard store written on the card equals, bins and manifest
    (digests included), the one the CPU writes."""
    import shutil
    import tempfile

    from splink_tpu_torch.spill import PairSpillStore

    masked = {**settings, "blocking_rules": MASKED_RULES, "device_blocking": "on"}
    t0 = time.perf_counter()
    card = blocking.block_using_rules(masked, table, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = blocking.block_using_rules(masked, table, device="cpu")
    if not (np.array_equal(card.idx_l, cpu.idx_l) and np.array_equal(card.idx_r, cpu.idx_r)):
        raise AssertionError("masked rules: the device tier differs between the card and the CPU")
    host = blocking.block_using_rules({**masked, "device_blocking": "off"}, table, device="cuda")
    if not np.array_equal(pair_keys(card), pair_keys(host)):
        raise AssertionError("masked rules: the device tier's pair set differs from the host "
                             "join's")
    root = tempfile.mkdtemp(prefix="masked_", dir=out_dir)
    try:
        stores = {}
        for dev in ("cuda", "cpu"):
            plan = blocking_device.build_device_plan(masked, table, device=dev)
            store = PairSpillStore.attach(os.path.join(root, dev), np.int32, {})
            t0 = time.perf_counter()
            with store:
                blocking_device.emit_pairs_sharded(plan, store, blocking_device.DEFAULT_CHUNK_PAIRS,
                                                   n_shards=2)
            store.finalize()
            stores[dev] = (store_digest(root, dev), time.perf_counter() - t0,
                           [sg.digest for sg in store.segments])
        (want, _, _), (got, card_store_s, digests) = stores["cpu"], stores["cuda"]
        if got != want or not any(d is not None for d in digests):
            raise AssertionError("masked rules: the card's store differs from the CPU's, or "
                                 "carries no digest")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"rules": MASKED_RULES, "pairs": card.n_pairs, "card_s": card_s,
            "card_equals_cpu_in_order": True, "pair_set_equals_host_join": True,
            "store_segments": len(got["segments"]),
            "digested_segments": sum(d is not None for d in digests),
            "card_store_equals_cpu_store": True, "card_store_s": card_store_s}


def blocking_device_phase(torch, blocking, blocking_device, settings, table, out_dir):
    """The device sort-join tier against the host join at the main path's
    size, through block_using_rules alone (no consumer): equal pair sets;
    the card's device tier equal to the port's device tier on the CPU,
    array for array; medians of 3 of each tier's parts; the device-only
    time of the decode and compaction and of the segmented sort; the
    bucket CSR on the ``blk`` codes equal to the host construction; and a
    masked rule set (:func:`masked_check`)."""
    runs = {"on": [], "off": []}
    last = {}
    for mode in ("on", "off") * BLOCKING_RUNS:
        blocking.clear_key_code_cache(table)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pairs = blocking.block_using_rules({**settings, "device_blocking": mode}, table,
                                           device="cuda")
        torch.cuda.synchronize()
        rec = {"wall_s": time.perf_counter() - t0,
               "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if mode == "on":
            rec.update(blocking_device.last_run)
        runs[mode].append(rec)
        last[mode] = pairs
    if blocking.tiers != {"device": BLOCKING_RUNS, "host": BLOCKING_RUNS}:
        raise AssertionError(f"blocking tiers {blocking.tiers}")
    on, off = last["on"], last["off"]
    if on.n_pairs != off.n_pairs or not np.array_equal(pair_keys(on), pair_keys(off)):
        raise AssertionError("the device tier's pair set differs from the host join's")

    def med(mode, key):
        return float(np.median([r[key] for r in runs[mode]]))

    n = on.n_pairs
    out = {"pairs": n, "rules": settings["blocking_rules"], "pair_sets_equal": True,
           "device": {k: med("on", k) for k in ("wall_s", "plan_s", "emit_s", "finish_s",
                                                  "peak_device_mem_gb")},
           "host": {k: med("off", k) for k in ("wall_s", "peak_device_mem_gb")},
           "runs": runs}
    out["device"]["chunks"] = runs["on"][-1]["chunks"]
    out["device"]["pairs_per_s"] = n / out["device"]["wall_s"]
    out["host"]["pairs_per_s"] = n / out["host"]["wall_s"]
    # the parts of the device tier: host key codes, the segmented sort (its
    # uploads and the copy of the sorted rows back included), and the
    # decode and compaction of every chunk on the card with no copy off it
    blocking.clear_key_code_cache(table)
    t0 = time.perf_counter()
    codes = blocking._key_codes(table, ["blk"])
    out["device"]["key_codes_s"] = time.perf_counter() - t0
    ranks, _ = blocking._uid_ranks(table, settings["link_type"])
    rows = np.arange(table.n_rows, dtype=np.int32)
    zeros = np.zeros(table.n_rows, np.int32)
    out["device"]["sort_ms"] = host_ms(torch, lambda: blocking_device.segment_sort(
        codes, zeros, ranks, rows, torch.device("cuda")), runs=BLOCKING_RUNS, warmup=1)[0]
    out["device"]["decode_compact_ms"] = decode_compact_ms(torch, blocking_device, settings,
                                                           table)
    # the card's device tier against the CPU's, array for array
    t0 = time.perf_counter()
    cpu = blocking.block_using_rules({**settings, "device_blocking": "on"}, table, device="cpu")
    out["cpu_device_tier_s"] = time.perf_counter() - t0
    if not (np.array_equal(on.idx_l, cpu.idx_l) and np.array_equal(on.idx_r, cpu.idx_r)):
        raise AssertionError("the device tier's pairs differ between the card and the CPU")
    out["card_equals_cpu_in_order"] = True
    del last, on, off, cpu
    # the serving bucket CSR on the card against the host construction
    t0 = time.perf_counter()
    csr = blocking_device.build_bucket_csr(codes, "cuda")
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_rows, _, h_starts, h_sizes = blocking._sort_groups(
        codes, np.flatnonzero(codes >= 0).astype(np.int32))
    h_bucket = np.full(table.n_rows, -1, np.int32)
    h_bucket[h_rows] = np.repeat(np.arange(len(h_sizes), dtype=np.int32), h_sizes)
    host_csr_s = time.perf_counter() - t0
    for name, got, want in zip(("rows_sorted", "starts", "sizes", "row_bucket"), csr,
                               (h_rows, h_starts, h_sizes, h_bucket)):
        if not np.array_equal(got, want.astype(np.int32)):
            raise AssertionError(f"bucket CSR {name} differs from the host construction")
    out["bucket_csr"] = {"buckets": len(h_sizes), "equal_to_host": True, "device_s": csr_s,
                         "host_s": host_csr_s}
    out["masked"] = masked_check(torch, blocking, blocking_device, settings, table, out_dir)
    blocking.clear_key_code_cache(table)
    return out


def spill_child(build_dir: str, out_path: str) -> int:
    """The kill-and-resume child: the main path's rows and settings through
    build_spill_dir's emission (chunks of 2^22: four segments), on the
    card. An injected kill at emit_segment ends it before it writes
    ``out_path``."""
    import splink_tpu_torch

    df, _ = make_people(N_ROWS, SEED)
    lk = splink_tpu_torch.Splink({**json.loads(json.dumps(SETTINGS)), "build_spill_dir": build_dir,
                                  "blocking_chunk_pairs": SPILL_MAIN_CHUNK}, df=df)
    pairs = lk._ensure_pairs()
    with open(out_path, "w") as fh:
        json.dump({"pairs": pairs.n_pairs, "segments": len(pairs.spill_store.segments),
                   "blocking_s": lk.stage_seconds["blocking"]}, fh)
    return 0


def store_digest(directory: str, name: str = "pairs") -> dict:
    """sha256 of both bins and the manifest's segment list of the store in
    ``directory/name``."""
    import hashlib

    pairs_dir = os.path.join(directory, name)
    out = {}
    for name in ("idx_l.bin", "idx_r.bin"):
        h = hashlib.sha256()
        with open(os.path.join(pairs_dir, name), "rb") as fh:
            for block in iter(lambda: fh.read(1 << 24), b""):
                h.update(block)
        out[name] = h.hexdigest()
    with open(os.path.join(pairs_dir, "pair_manifest.json")) as fh:
        out["segments"] = json.load(fh)["segments"]
    return out


def spill_phase(torch, splink_tpu_torch, big, large_counts, large_params, df, out_dir):
    """The durable pair store on the card. (1) The large job written with
    build_spill_dir and trained through pattern ids read from the store:
    the counts equal the large phase's, the parameters within 1e-12. (2) At
    the main path's size a child process is killed at emit_segment after
    the second of four segments, and a fresh one resumes: both bins and the
    manifest's segments byte-identical to an uninterrupted build's. (3)
    With a custom column (no patterns) and max_resident_pairs below the
    pairs, the spill-fed streamed EM is bit-identical to the streamed-G
    path without build_spill_dir."""
    import shutil
    import tempfile

    from splink_tpu_torch import blocking

    root = tempfile.mkdtemp(prefix="spill_", dir=out_dir)
    out = {}
    try:
        need = 8 * int(large_counts.sum()) + (1 << 30)
        free = shutil.disk_usage(root).free
        out["disk_free_gb"] = free / 1e9
        if free < need:
            raise AssertionError(f"{free / 1e9:.2f} GB free under {root}, the store needs "
                                 f"{need / 1e9:.2f} GB")
        # 1: the large job, written durably and trained from the store
        for k in blocking.tiers:
            blocking.tiers[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lk = splink_tpu_torch.Splink({**json.loads(json.dumps(SETTINGS)),
                                      "device_pair_generation": "off",
                                      "build_spill_dir": os.path.join(root, "large")}, df=big)
        lk.estimate_parameters()
        wall = time.perf_counter() - t0
        store = lk._pairs.spill_store
        if store is None or not store.completed or lk._P is None:
            raise AssertionError("the large job did not train from a finished spill store")
        if store.total_pairs != int(large_counts.sum()) or not np.array_equal(
                lk._pattern_counts, large_counts):
            raise AssertionError("the store-fed pattern counts differ from the large phase's")
        rel = {k: max_rel_diff(a, b) for k, a, b in zip(
            ("lambda", "m", "u"), lk.params.to_arrays()[:3], large_params)}
        if max(rel.values()) > VIRTUAL_RTOL:
            raise AssertionError(f"store-fed vs virtual parameters differ: {rel}")
        stage = dict(lk.stage_seconds)
        nbytes = 2 * store.idx_dtype.itemsize * store.total_pairs
        t0 = time.perf_counter()
        store.verify()
        verify_s = time.perf_counter() - t0
        out["large"] = {
            "rows": len(big), "pairs": store.total_pairs, "segments": len(store.segments),
            "bin_bytes": nbytes, "wall_s": wall, "stage_s": stage,
            "emission_s": stage["blocking"], "bytes_per_s": nbytes / stage["blocking"],
            "pairs_per_s": store.total_pairs / stage["blocking"],
            "pattern_pass_s": stage["gammas_patterns"],
            "counts_equal": True, "params_max_rel_diff": rel, "verify_sha256_s": verify_s,
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        lk._pairs.release()
        del lk, store
        shutil.rmtree(os.path.join(root, "large"), ignore_errors=True)

        # 2: kill and resume at the main path's size
        full_dir = os.path.join(root, "full")
        t0 = time.perf_counter()
        full = splink_tpu_torch.Splink({**json.loads(json.dumps(SETTINGS)),
                                        "build_spill_dir": full_dir,
                                        "blocking_chunk_pairs": SPILL_MAIN_CHUNK}, df=df)
        fpairs = full._ensure_pairs()
        full_s = time.perf_counter() - t0
        want = store_digest(full_dir)
        if len(want["segments"]) != 4:
            raise AssertionError(f"{len(want['segments'])} segments, expected 4")
        fpairs.release()
        del full, fpairs
        part_dir = os.path.join(root, "part")
        runs = {}
        for tag, faults in (("killed", SPILL_KILL), ("resumed", None)):
            env = {k: v for k, v in os.environ.items() if k != "SPLINK_TPU_FAULTS"}
            if faults:
                env["SPLINK_TPU_FAULTS"] = faults
            res = os.path.join(root, f"{tag}.json")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--spill-child",
                                   part_dir, res], env=env, capture_output=True, text=True,
                                  timeout=600)
            runs[tag] = {"rc": proc.returncode, "s": time.perf_counter() - t0}
            if tag == "killed":
                with open(os.path.join(part_dir, "pairs", "pair_manifest.json")) as fh:
                    committed = len(json.load(fh)["segments"])
                torn = os.path.getsize(os.path.join(part_dir, "pairs", "idx_l.bin"))
                runs[tag].update(committed_segments=committed, bin_bytes_at_kill=torn)
                if proc.returncode != -9 or committed != 2 or os.path.exists(res):
                    raise AssertionError(f"the killed child: rc {proc.returncode}, {committed} "
                                         f"committed segments: {proc.stderr[-2000:]}")
            elif proc.returncode != 0:
                raise AssertionError(f"the resumed child failed: {proc.stderr[-3000:]}")
            else:
                with open(res) as fh:
                    runs[tag].update(json.load(fh))
        got = store_digest(part_dir)
        if got != want:
            raise AssertionError("the resumed store differs from the uninterrupted build's")
        out["kill_resume"] = {"pairs": runs["resumed"]["pairs"], "segments": 4,
                              "uninterrupted_s": full_s, "runs": runs, "byte_identical": True,
                              "bins_sha256": {k: want[k] for k in ("idx_l.bin", "idx_r.bin")}}

        # 3: the spill-fed streamed EM against the streamed-G path
        splink_tpu_torch.register_comparison("chip_smoke_postcode_exact", postcode_exact)
        em = json.loads(json.dumps(SETTINGS))
        em["comparison_columns"].append(json.loads(json.dumps(SPILL_CUSTOM)))
        em["max_resident_pairs"] = SPILL_MAX_RESIDENT
        res = {}
        for tag, extra in (("spill_fed", {"build_spill_dir": os.path.join(root, "em")}),
                           ("streamed_g", {})):
            for k in blocking.tiers:
                blocking.tiers[k] = 0
            t0 = time.perf_counter()
            lk = splink_tpu_torch.Splink({**json.loads(json.dumps(em)), **extra}, df=df)
            lk.estimate_parameters()
            res[tag] = (lk, time.perf_counter() - t0)
            if "em_streamed" not in lk.stage_seconds or lk._use_pattern_pipeline():
                raise AssertionError(f"{tag}: not the streamed regime")
        (a, a_s), (b, b_s) = res["spill_fed"], res["streamed_g"]
        if a._pairs.spill_store is None or b._pairs.spill_store is not None:
            raise AssertionError("the spill-fed run has no store, or the streamed-G run has one")
        if blocking.tiers != {"device": 1, "host": 0}:
            raise AssertionError(f"the streamed-G run blocked through {blocking.tiers}")
        if not (np.array_equal(a._pairs.idx_l, b._pairs.idx_l)
                and np.array_equal(a._pairs.idx_r, b._pairs.idx_r)):
            raise AssertionError("the spill store's pairs differ from the device tier's")
        if params_state(a) != params_state(b):
            raise AssertionError("the spill-fed EM differs from the streamed-G path")
        out["spill_fed_em"] = {
            "pairs": a._pairs.n_pairs, "max_resident_pairs": SPILL_MAX_RESIDENT,
            "em_updates": len(a.params.param_history), "bit_identical": True,
            "spill_fed": {"wall_s": a_s, "stage_s": dict(a.stage_seconds)},
            "streamed_g": {"wall_s": b_s, "stage_s": dict(b.stage_seconds)},
        }
        a._pairs.release()
        del a, b, res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def postcode_exact(ctx, col_settings):
    """A custom comparison (postcode token equality): settings with one
    cannot use the pattern-id pipeline."""
    import torch

    from splink_tpu_torch.ops.gamma import apply_null

    pc = ctx.col("postcode")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)


def regimes_parity(splink_tpu_torch, resilience, sub, out_dir, device="cuda"):
    """Every regime on ``device`` at the subset's size, against the resident
    regime: the pattern regime (virtual and materialised), the streamed-G
    regime, checkpointed EM and its resume after an injected fault, the OOM
    fallback; and the pattern regime on the card against the CPU."""
    import pandas as pd
    import warnings

    from splink_tpu_torch.utils.logging_utils import DegradationWarning

    splink_tpu_torch.register_comparison("chip_smoke_postcode_exact", postcode_exact)
    base = json.loads(json.dumps(SETTINGS))
    out = {"rows": len(sub)}
    key = ["unique_id_l", "unique_id_r"]

    def run(settings, entry="get_scored_comparisons", dev=device, **kw):
        lk = splink_tpu_torch.Splink(json.loads(json.dumps(settings)), df=sub, device=dev)
        res = getattr(lk, entry)(**kw)
        if entry == "get_scored_comparisons":
            res = res.sort_values(key).reset_index(drop=True)
        return lk, res

    # the pattern regime against the resident one (float64), and virtual
    # against materialised pairs (float32)
    f64 = {**base, "float64": True, "retain_intermediate_calculation_columns": True}
    res_lk, res64 = run(f64)
    pat = {}
    for dpg in ("on", "off"):
        lk64, fr64 = run({**f64, "max_resident_pairs": 1024, "device_pair_generation": dpg})
        if not lk64._use_pattern_pipeline() or lk64.device_pair_generation_active != (dpg == "on"):
            raise AssertionError(f"device_pair_generation {dpg}: not the expected regime")
        pd.testing.assert_frame_equal(res64, fr64, check_exact=False, rtol=1e-5, atol=1e-7)
        pat[dpg] = run({**base, "max_resident_pairs": 1024, "device_pair_generation": dpg})
    (von, fon), (_, foff) = pat["on"], pat["off"]
    if not fon[key + [c for c in fon if c.startswith("gamma_")]].equals(
            foff[key + [c for c in foff if c.startswith("gamma_")]]):
        raise AssertionError("virtual and materialised pairs or gammas differ")
    dp = max_rel_diff(fon["match_probability"], foff["match_probability"])
    if dp > VIRTUAL_RTOL:
        raise AssertionError(f"virtual vs materialised probabilities differ by {dp} relative")
    out["pattern"] = {"pairs": len(fon), "vs_resident_f64": "rtol 1e-5 / atol 1e-7",
                      "virtual_vs_materialised_max_rel_dp": dp}

    # the streamed-G regime: a custom comparison rules patterns out
    custom = json.loads(json.dumps(base))
    custom["comparison_columns"][4] = {
        "custom_name": "postcode_exact", "custom_columns_used": ["postcode"],
        "num_levels": 2, "comparison": {"kind": "custom", "fn": "chip_smoke_postcode_exact"}}
    r_lk, r_fr = run(custom)
    s_lk, s_fr = run({**custom, "max_resident_pairs": 1024, "pair_batch_size": 65_536})
    if s_lk._use_pattern_pipeline() or "em_streamed" not in s_lk.stage_seconds:
        raise AssertionError("the custom comparison's run did not take the streamed regime")
    dlam = abs(r_lk.params.params["λ"] - s_lk.params.params["λ"])
    if dlam > 1e-5:
        raise AssertionError(f"streamed vs resident lambda differs by {dlam}")
    np.testing.assert_allclose(s_fr["match_probability"], r_fr["match_probability"],
                               rtol=1e-3, atol=1e-5)
    out["streamed_g"] = {"pairs": len(s_fr), "lambda_abs_diff": dlam,
                         "max_abs_dp": float(np.abs(s_fr["match_probability"].to_numpy()
                                                    - r_fr["match_probability"].to_numpy()).max())}

    # checkpointed EM: invisible, and a resume after an injected fault at a
    # boundary equals the uninterrupted run bit for bit
    ck = {**base, "max_iterations": 8, "em_convergence": 1e-12, "checkpoint_interval": 2}
    ckpt_root = os.path.join(out_dir, f"checkpoints_{device}")
    import shutil

    shutil.rmtree(ckpt_root, ignore_errors=True)
    plain, _ = run(ck, "estimate_parameters")
    with_ck, _ = run(ck, "estimate_parameters", checkpoint_dir=os.path.join(ckpt_root, "a"))
    if params_state(with_ck) != params_state(plain):
        raise AssertionError("checkpointed EM differs from EM without checkpoints")
    resilience.faults.reset_plans()
    stopped_at = None
    try:
        run({**ck, "fault_plan": "segment@iter=4:kind=transient"}, "estimate_parameters",
            checkpoint_dir=os.path.join(ckpt_root, "b"))
    except resilience.InjectedFault as e:
        stopped_at = e.coords
    if stopped_at != {"iter": 4}:
        raise AssertionError(f"the injected segment fault did not stop the run: {stopped_at}")
    on_disk = resilience.load_checkpoint(os.path.join(ckpt_root, "b")).iteration
    resumed, _ = run(ck, "estimate_parameters", checkpoint_dir=os.path.join(ckpt_root, "b"),
                     resume=True)
    if params_state(resumed) != params_state(plain):
        raise AssertionError("EM resumed after the injected fault differs from the "
                             "uninterrupted run")
    out["checkpoint"] = {"bit_identical": True, "em_updates": len(plain.params.param_history),
                         "stopped_at": stopped_at, "checkpoint_iteration": on_disk,
                         "resumed_bit_identical": True}

    # the OOM fallback: resident -> streamed on the same device, logged
    resilience.faults.reset_plans()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        oom, _ = run({**base, "fault_plan": "resident_em@kind=oom"}, "estimate_parameters")
    degraded = [str(w.message) for w in caught if issubclass(w.category, DegradationWarning)]
    if not degraded or "em_streamed" not in oom.stage_seconds:
        raise AssertionError(f"the injected OOM did not take the streamed regime: {degraded}")
    res32, _ = run(base, "estimate_parameters")
    dlam = abs(oom.params.params["λ"] - res32.params.params["λ"])
    if dlam > 1e-5:
        raise AssertionError(f"OOM fallback lambda differs from resident by {dlam}")
    out["oom_fallback"] = {"warning": degraded[0], "lambda_abs_diff": dlam}

    # the pattern regime on the card against the CPU
    cpu_lk, cpu_fr = run({**base, "max_resident_pairs": 1024}, dev="cpu")
    if not np.array_equal(von._pattern_counts, cpu_lk._pattern_counts):
        raise AssertionError("pattern counts differ between the card and the CPU")
    dcpu = float(np.abs(fon["match_probability"].to_numpy()
                        - cpu_fr["match_probability"].to_numpy()).max())
    if dcpu > 1e-5:
        raise AssertionError(f"pattern regime probabilities card vs CPU differ by {dcpu}")
    out["card_vs_cpu"] = {"counts_equal": True, "max_abs_dp": dcpu}
    return out


# ----------------------------------------------------------------------
# Online serving: the main path's linker frozen into an index and queried
# ----------------------------------------------------------------------

SERVE_QUERIES = 10_000
SERVE_CHUNK = 1024  # the default menu's largest query bucket
SERVE_SERVICE_QUERIES = 2_000
SERVE_CLIENTS = 8  # closed-loop client threads of the service run
SERVE_COALESCE_MS = 2.0  # the service's batching window
SERVE_DEADLINE_MS = 100.0  # each submitted request's own deadline
SERVE_PARITY_ROWS = 1_000  # table rows queried for serve-equals-offline
SERVE_CPU_QUERIES = 1_000  # the same queries on a CPU engine
SERVE_CPU_ATOL = 1e-5
SERVE_BROWNOUT_TOP_K = 2
SERVE_OOC_CHUNK_ROWS = 262_144
SERVE_SHAPES = ((16, 32), (1024, 256), (1024, 2048))  # the kernel rows' (Q, C)


def make_queries(df, n: int, seed: int):
    """``n`` query records drawn from the table: each with a one-character
    typo in a non-null first_name, surname or city, ~1% with an unseen
    first name or surname, ~2% with one more field nulled. Returns the
    frame and each query's source row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, len(df), n)
    q = df.iloc[src].reset_index(drop=True).copy()
    q["unique_id"] = np.arange(n) + 10 * len(df)
    cols = {k: q[k].to_numpy(object).copy() for k in ("first_name", "surname", "city")}
    which = rng.integers(0, 3, n)
    for i in range(n):
        for k in range(3):
            name = ("first_name", "surname", "city")[(which[i] + k) % 3]
            if isinstance(cols[name][i], str):
                cols[name][i] = _typo(rng, cols[name][i])
                break
    unseen = np.flatnonzero(rng.random(n) < 0.01)
    fresh = _pool(rng, len(unseen), 11, 11)  # pool strings are 4-10 letters long
    for i, v in zip(unseen, fresh):
        cols[("first_name", "surname")[i % 2]][i] = v
    for k, v in cols.items():
        q[k] = v
    nulls = np.flatnonzero(rng.random(n) < 0.02)
    fields = ("first_name", "surname", "city", "postcode", "dob")
    for i in nulls:
        q.at[i, fields[int(rng.integers(0, len(fields)))]] = None
    return q, src, len(unseen), len(nulls)


def near_tie_runs(p, valid, tol):
    """Per query, the rank runs whose scores lie within ``tol`` of the
    run's first (the top-k is sorted, so ties are adjacent)."""
    k = p.shape[1]
    for q in range(p.shape[0]):
        r = 0
        while r < k:
            e = r + 1
            while e < k and valid[q, e] and abs(float(p[q, e]) - float(p[q, r])) <= tol:
                e += 1
            yield q, r, e
            r = e


def check_topk_close(want, got, tol, what):
    """Raise unless the counts and validity are equal, the probabilities
    within ``tol``, and the rows equal wherever the scores are not tied
    within ``tol`` (within a tied run the rows must be the same set,
    unless the run reaches rank k-1 and may continue past k)."""
    wp, wr, wv, wn = want
    gp, gr, gv, gn = got
    if not (np.array_equal(wn, gn) and np.array_equal(wv, gv)):
        raise AssertionError(f"{what}: candidate counts or validity differ")
    dp = float(np.abs(wp[wv].astype(np.float64) - gp[gv].astype(np.float64)).max(initial=0))
    if dp > tol:
        raise AssertionError(f"{what}: probabilities differ by {dp}")
    k, tied = wp.shape[1], 0
    for q, r, e in near_tie_runs(wp, wv, tol):
        a, b = wr[q, r:e][wv[q, r:e]], gr[q, r:e][gv[q, r:e]]
        if e - r == 1 or not wv[q, r]:
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: query {q} rank {r} rows differ outside a tie")
        elif e < k or not wv[q, k - 1]:
            tied += e - r
            if set(a.tolist()) != set(b.tolist()):
                raise AssertionError(f"{what}: query {q} tied ranks {r}-{e} hold other rows")
    return dp, tied


def device_bytes(state) -> int:
    """Bytes of every tensor in a device-state dict (tuples and FSParams
    included)."""
    total = 0
    for v in state.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            total += t.numel() * t.element_size()
    return total


def serve_pairs_offline(linker, rows, tf=False):
    """{(min uid, max uid): offline probability} of every pair of the
    linker's pair set with an endpoint in ``rows`` (table row = uid here):
    ``match_probability`` as the linker scores it, or with ``tf``
    ``tf_match_probability`` through the linker's own TF fold."""
    il, ir = linker._pairs.idx_l, linker._pairs.idx_r
    sel = np.isin(il, rows) | np.isin(ir, rows)
    G = linker._G[sel]
    p, _, _, z = linker._score_batched(G, want_z=tf)
    if tf:
        p = linker._tf_fold_pairs(z, il[sel], ir[sel], linker._tf_fold_ctx())
    uid = linker._table.unique_id
    a, b = uid[il[sel]], uid[ir[sel]]
    return {(int(min(x, y)), int(max(x, y))): v for x, y, v in zip(a, b, p)}


def check_serve_offline(out, index, rows, offline, what):
    """Every served (query row, match) probability equals the offline one
    (==), and the served pair set equals the offline set for those rows."""
    top_p, top_rows, top_valid, _ = out
    uid = index.unique_id
    served = set()
    for qi, row_ in enumerate(rows):
        for r in np.flatnonzero(top_valid[qi]):
            m = int(uid[top_rows[qi, r]])
            if m == int(row_):
                continue
            key = (min(int(row_), m), max(int(row_), m))
            if key not in offline:
                raise AssertionError(f"{what}: served pair {key} is not an offline pair")
            if offline[key] != top_p[qi, r]:
                raise AssertionError(f"{what}: pair {key} served {top_p[qi, r]!r}, "
                                     f"offline {offline[key]!r}")
            served.add(key)
    if served != set(offline):
        raise AssertionError(f"{what}: {len(set(offline) - served)} offline pairs not served")
    return len(served)


def serve_phase(torch, strings_cuda, native, tf, linker, tf_linker, df, out_dir):
    """The serving tier at the main path's size; returns (fields, captured
    kernel inputs at SERVE_SHAPES)."""
    import shutil
    import threading
    import warnings

    from splink_tpu_torch.obs.metrics import compile_requests
    from splink_tpu_torch.obs.reqtrace import PhaseProfile
    from splink_tpu_torch.serve import LinkageService, QueryEngine, load_index
    from splink_tpu_torch.serve.engine import candidate_gather, encode_query, score_fused
    from splink_tpu_torch.utils.logging_utils import DegradationWarning

    idx_dir = os.path.join(out_dir, "serve_index")
    shutil.rmtree(idx_dir, ignore_errors=True)
    t0 = time.perf_counter()
    built = linker.export_index()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built.save(idx_dir)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = load_index(idx_dir)
    load_s = time.perf_counter() - t0
    if index.content_fingerprint() != built.content_fingerprint():
        raise AssertionError("the loaded index's fingerprint differs from the built one's")
    mem0 = torch.cuda.memory_allocated()
    state = index.device_state()
    torch.cuda.synchronize()
    state_bytes = device_bytes(state)
    engine = QueryEngine(index, brownout_top_k=SERVE_BROWNOUT_TOP_K)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warmup_s = time.perf_counter() - t0
    builds_after_warmup = compile_requests()
    menu = engine.policy.warmup_combinations()
    if warm["combinations"] != len(menu) + len(engine.policy.query_buckets):
        raise AssertionError(f"warmup ran {warm}")
    fields = {
        "rows": index.n_rows, "rules": len(index.rules), "lanes": index.n_lanes,
        "export_s": export_s, "save_s": save_s, "load_s": load_s, "warmup_s": warmup_s,
        "warmup": warm, "device_state_bytes": state_bytes,
        "device_memory_after_state_bytes": torch.cuda.memory_allocated() - mem0,
        "largest_block": int(max(int(r.sizes.max()) for r in index.rules)),
        "top_k": engine.top_k, "brownout_top_k": engine.brownout_top_k,
        "menu": engine.policy.warmup_combinations(),
    }

    # -- the batch path: 10,000 typo'd queries in chunks of 1,024 ---------
    qdf, src, n_unseen, n_null = make_queries(df, SERVE_QUERIES, SEED + 3)
    zero_counts(strings_cuda, native, tf)
    chunks, per_shape, encode_ms, profile = [], {}, [], PhaseProfile()
    outs = []
    for start in range(0, SERVE_QUERIES, SERVE_CHUNK):
        part = qdf.iloc[start:start + SERVE_CHUNK]
        t0 = time.perf_counter()
        batch = engine.encode(part)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        need = max(int(index.candidate_counts(batch.qbuckets).max(initial=0)), engine.top_k)
        shape = (engine.policy.query_bucket(len(part)), engine.policy.candidate_bucket(need))
        t0 = time.perf_counter()
        outs.append(engine.query_arrays(part, profile=profile))
        ms = (time.perf_counter() - t0) * 1e3
        per_shape.setdefault(f"{shape[0]}x{shape[1]}", []).append(ms)
        chunks.append(shape)
    # the query_arrays calls only (each encodes its chunk again)
    batch_wall = sum(sum(v) for v in per_shape.values()) / 1e3
    launches = dict(strings_cuda.launches)
    variants = dict(strings_cuda.variant_launches)
    n_batches = len(chunks)
    want = {"jaro_winkler/u8/w1": 2 * n_batches, "levenshtein/u8/w1": n_batches}
    if variants != want:
        raise AssertionError(f"serve batch path launched {variants}, expected {want}")
    out = tuple(np.concatenate([o[i] for o in outs]) for i in range(4))
    top_p, top_rows, top_valid, n_cand = out
    if not (np.isfinite(top_p).all() and (top_p[top_valid] >= 0).all()
            and (top_p[top_valid] <= 1).all() and top_p.dtype == np.float32):
        raise AssertionError("served probabilities are not float32 in [0, 1]")
    uid = index.unique_id
    hit = (uid[top_rows] == df["unique_id"].to_numpy()[src][:, None]) & top_valid
    recall = float(hit.any(axis=1).mean())
    if recall < 0.5:
        raise AssertionError(f"only {recall:.3f} of the queries found their source record")
    fields["batch_path"] = {
        "queries": SERVE_QUERIES, "unseen": n_unseen, "nulled": n_null,
        "batches": n_batches, "wall_s": batch_wall,
        "queries_per_s": SERVE_QUERIES / batch_wall,
        "median_batch_ms": {k: float(np.median(v)) for k, v in per_shape.items()},
        "batches_per_shape": {k: len(v) for k, v in per_shape.items()},
        "median_encode_ms": float(np.median(encode_ms)),
        "execute_s": profile.execute_s, "transfer_s": profile.transfer_s,
        "launches": launches, "variant_launches": variants,
        "launches_per_batch": {k: v / n_batches for k, v in launches.items()},
        "queries_with_candidates": int((n_cand > 0).sum()),
        "source_in_top_k": recall,
    }

    # -- the programs alone at 1024 x 256 and 1024 x 2048 ------------------
    part = qdf.iloc[:SERVE_CHUNK]
    batch = engine.encode(part)
    dev = index.device_state()
    cols = index.settings["comparison_columns"]
    programs = {}
    for cap in (256, 2048):
        packed = torch.from_numpy(batch.packed.view(np.int32)).cuda()
        qb = torch.from_numpy(batch.qbuckets).cuda()
        encode_query(packed, qb, SERVE_CHUNK)

        def gather(cap=cap, qb=qb):
            return candidate_gather(qb, dev["starts"], dev["sizes"], dev["rows"],
                                    dev["row_bucket"], cap)

        cand, valid, _ = gather()

        def fused(packed=packed, cand=cand, valid=valid):
            return score_fused(index.layout, cols, engine.top_k, packed, dev["packed"],
                               cand, valid, dev["params"])

        programs[f"{SERVE_CHUNK}x{cap}"] = {
            "encode_query_ms": cuda_ms(torch, lambda: encode_query(packed, qb, SERVE_CHUNK)),
            "candidate_gather_ms": cuda_ms(torch, gather),
            "candidate_gather_call_ms": cuda_ms(torch, gather, device_only=False),
            "score_fused_ms": cuda_ms(torch, fused),
            "score_fused_call_ms": cuda_ms(torch, fused, device_only=False),
        }
    fields["programs"] = programs

    # -- kernel inputs at the serve shapes (captured after the counts) -----
    captured = {}
    for q_n, cap in SERVE_SHAPES:
        b = engine.encode(qdf.iloc[:q_n])
        strings_cuda.capture = {}
        with engine._swap_lock, engine._on_device():
            engine._dispatch(engine.top_k, cap, torch.from_numpy(b.packed.view(np.int32)).cuda(),
                             torch.from_numpy(b.qbuckets).cuda(), q_n)
        torch.cuda.synchronize()
        captured[(q_n, cap)], strings_cuda.capture = strings_cuda.capture, None

    # -- fused against unfused on the card ---------------------------------
    unfused = QueryEngine(index, fused=False)
    part = qdf.iloc[:2 * SERVE_CHUNK]
    a, b = engine.query_arrays(part), unfused.query_arrays(part)
    if not all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("fused and unfused serving differ on the card")

    # -- served against offline: table rows queried with a top-k above the
    # -- largest block --------------------------------------------------------
    rng = np.random.default_rng(SEED + 4)
    rows = np.sort(rng.choice(len(df), SERVE_PARITY_ROWS, replace=False))
    k_sub = fields["largest_block"] + 1
    sub_engine = QueryEngine(index, top_k=k_sub)
    n_off = check_serve_offline(sub_engine.query_arrays(df.iloc[rows]), index, rows,
                                serve_pairs_offline(linker, rows), "serve vs offline")

    # -- the TF engine over the TF path's linker ---------------------------
    t0 = time.perf_counter()
    tf_index = tf_linker.export_index()
    tf_export_s = time.perf_counter() - t0
    tf_engine = QueryEngine(tf_index)
    tf_warm = tf_engine.warmup()
    if not tf_engine.tf_active:
        raise AssertionError("the TF engine does not fold")
    zero_counts(strings_cuda, native, tf)
    t0 = time.perf_counter()
    for start in range(0, SERVE_QUERIES, SERVE_CHUNK):
        tf_engine.query_arrays(qdf.iloc[start:start + SERVE_CHUNK])
    tf_wall = time.perf_counter() - t0
    tf_variants = dict(strings_cuda.variant_launches)
    if tf_variants != want:
        raise AssertionError(f"TF serve path launched {tf_variants}, expected {want}")
    tf_sub = QueryEngine(tf_index, top_k=k_sub)
    n_tf_off = check_serve_offline(tf_sub.query_arrays(df.iloc[rows]), tf_index, rows,
                                   serve_pairs_offline(tf_linker, rows, tf=True),
                                   "TF serve vs offline tf_match_probability")
    fields["tf_engine"] = {"export_s": tf_export_s, "warmup": tf_warm, "wall_s": tf_wall,
                           "queries_per_s": SERVE_QUERIES / tf_wall,
                           "variant_launches": tf_variants,
                           "offline_pairs_equal": n_tf_off}
    fields["serve_vs_offline"] = {"rows": SERVE_PARITY_ROWS, "top_k": k_sub,
                                  "pairs_equal": n_off}

    # -- the same queries on a CPU engine over the same artifact ------------
    cpu_engine = QueryEngine(load_index(idx_dir, device="cpu"))
    t0 = time.perf_counter()
    cpu_out = cpu_engine.query_arrays(qdf.iloc[:SERVE_CPU_QUERIES])
    cpu_s = time.perf_counter() - t0
    card = tuple(a[:SERVE_CPU_QUERIES] for a in out)
    dp, tied = check_topk_close(card, cpu_out, SERVE_CPU_ATOL, "serve card vs CPU")
    fields["cuda_vs_cpu"] = {"queries": SERVE_CPU_QUERIES, "max_abs_dp": dp,
                             "ranks_in_ties": tied, "cpu_s": cpu_s}

    # -- the bucket CSR built on the card and on the host; the out-of-core
    # -- build at full size ------------------------------------------------
    fps, build_s = {}, {}
    saved = dict(linker.settings)
    try:
        for mode in ("on", "off"):
            linker.settings["device_blocking"] = mode
            t0 = time.perf_counter()
            fps[mode] = linker.export_index().content_fingerprint()
            build_s[mode] = time.perf_counter() - t0
        linker.settings["device_blocking"] = saved.get("device_blocking", "auto")
        ooc_dir = os.path.join(out_dir, "serve_build")
        shutil.rmtree(ooc_dir, ignore_errors=True)
        linker.settings.update(build_spill_dir=ooc_dir, build_spill_chunk_rows=SERVE_OOC_CHUNK_ROWS)
        t0 = time.perf_counter()
        ooc = linker.export_index()
        build_s["out_of_core"] = time.perf_counter() - t0
        fps["out_of_core"] = ooc.content_fingerprint()
        del ooc
    finally:
        linker.settings.clear()
        linker.settings.update(saved)
    fps["auto"] = index.content_fingerprint()
    if len(set(fps.values())) != 1:
        raise AssertionError(f"serving index fingerprints differ: {fps}")
    shutil.rmtree(os.path.join(out_dir, "serve_build"), ignore_errors=True)
    fields["fingerprints_equal"] = sorted(fps)
    fields["build_s"] = build_s

    # -- the service: closed-loop clients submitting single records ---------
    records = qdf.iloc[:SERVE_SERVICE_QUERIES].to_dict(orient="records")
    results = [None] * len(records)

    def client(t):
        for i in range(t, len(records), SERVE_CLIENTS):
            results[i] = svc.query(records[i], timeout=60, deadline_ms=SERVE_DEADLINE_MS)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DegradationWarning)
        svc = LinkageService(engine, deadline_ms=SERVE_COALESCE_MS)
        threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        svc_wall = time.perf_counter() - t0
        summary = svc.latency_summary()
        svc.close()
    if any(r is None for r in results):
        raise AssertionError("a service request did not resolve")
    differ = 0
    for i, res in enumerate(results):
        if res.shed or res.degraded:
            continue
        want_m = [(uid[top_rows[i, r]], float(top_p[i, r]))
                  for r in range(top_p.shape[1]) if top_valid[i, r]]
        differ += res.matches != want_m
    if differ:
        raise AssertionError(f"{differ} service answers differ from the batch path's")
    fields["service"] = {
        "clients": SERVE_CLIENTS, "queries": SERVE_SERVICE_QUERIES,
        "coalesce_window_ms": SERVE_COALESCE_MS, "request_deadline_ms": SERVE_DEADLINE_MS,
        "wall_s": svc_wall, "degradation_warnings": len(caught),
        "degraded": sum(r.degraded for r in results),
        **{k: summary[k] for k in ("served", "shed", "batches", "timeouts", "p50_ms",
                                   "p95_ms", "p99_ms", "mean_ms", "brownout_episodes")
           if k in summary},
        "queries_per_s": SERVE_SERVICE_QUERIES / svc_wall,
        "shed_reasons": sorted({r.reason for r in results if r.shed}),
    }
    if compile_requests() != builds_after_warmup:
        raise AssertionError("kernel libraries were built after warmup")
    fields["builds_after_warmup"] = compile_requests() - builds_after_warmup
    return fields, captured, {"engine": engine, "idx_dir": idx_dir, "qdf": qdf, "answers": out}


# ----------------------------------------------------------------------
# The serving fleet: the AOT library sidecar, the wire tier, the router,
# federation
# ----------------------------------------------------------------------

FLEET_CHILD_QUERIES = 1_024  # a cold replica's first answers
FLEET_WINDOW = 256  # futures in flight per submit window; records per submit_many frame
FLEET_SUBMIT_QUERIES = 5_000  # of the replay's 10,000, through submit; the rest submit_many
FLEET_LATENCY_QUERIES = 1_000  # closed-loop clients, over the wire and in process
FLEET_ROUTER_QUERIES = 1_500  # routed over two replicas, server A killed a third in
FLEET_DEADLINE_MS = 2_000.0  # each routed request's deadline
FLEET_PARTITION_MS = 1_500
FLEET_WAIT_S = 30.0  # bound on every wait of the phase
FLEET_CHILD_TIMEOUT_S = 400
FLEET_SHED_REASONS = {"connection_lost", "remote_unreachable", "breaker_open", "deadline",
                      "timeout", "queue_full", "closed", "no_replica", "batch_error"}


def aot_child(index_dir: str, aot_dir: str, queries: str, out_path: str,
              device: str = "cuda") -> int:
    """``chip_smoke.py --aot-child``: a fresh replica's cold start. Loads the
    index, builds a QueryEngine over it (with the sidecar at ``aot_dir``
    unless it is empty), restores, warms up and answers the pickled
    queries; writes its timestamps, build and restore counts, degradation
    events and whether a compiler is reachable to ``out_path`` and its
    answers beside it (``.npz``)."""
    t_start = time.time()
    import shutil

    import pandas as pd
    import torch

    from splink_tpu_torch.obs import events
    from splink_tpu_torch.obs.metrics import compile_stats
    from splink_tpu_torch.ops import strings_cuda
    from splink_tpu_torch.serve import QueryEngine, load_index

    class Sink:
        def __init__(self):
            self.degradations = []

        def emit(self, etype, **fields):
            if etype == "degradation":
                self.degradations.append({k: str(v) for k, v in fields.items()})

    sink = Sink()
    events.register_ambient(sink)
    t_import = time.time()
    index = load_index(index_dir, device=device)
    index.device_state()
    if device == "cuda":
        torch.cuda.synchronize()
    t_load = time.time()
    engine = QueryEngine(index, brownout_top_k=SERVE_BROWNOUT_TOP_K, aot_dir=aot_dir or None)
    restored = engine.restore_aot()
    t_restore = time.time()
    warm = engine.warmup()
    t_warm = time.time()
    qdf = pd.read_pickle(queries)
    out = engine.query_arrays(qdf)
    t_answer = time.time()
    try:
        nvcc = strings_cuda.cuda_tool("nvcc")
    except RuntimeError:
        nvcc = None
    np.savez(out_path + ".npz", *out)
    with open(out_path, "w") as fh:
        json.dump({
            "t_start": t_start, "t_import": t_import, "t_load": t_load,
            "t_restore": t_restore, "t_warm": t_warm, "t_answer": t_answer,
            "restored": restored, "warmup": warm, "stats": compile_stats(),
            "degradations": sink.degradations, "gxx": shutil.which("g++"), "nvcc": nvcc,
            "built": sorted(os.listdir(strings_cuda.build_dir())),
        }, fh)
    return 0


def _run_aot_child(name, idx_dir, aot_dir, queries, out_dir, device, compilers: bool):
    """Run one ``--aot-child`` with an empty build directory; returns its
    report (seconds measured from the spawn) and answers."""
    import shutil

    build = os.path.join(out_dir, f"fleet_build_{name}")
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    env = dict(os.environ, SPLINK_TPU_TORCH_BUILD_DIR=build)
    if not compilers:
        empty = os.path.join(out_dir, f"fleet_nobin_{name}")
        os.makedirs(empty, exist_ok=True)
        env.update(PATH=empty, CUDA_HOME=empty)
    out_path = os.path.join(out_dir, f"fleet_child_{name}.json")
    spawn = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--aot-child", idx_dir, aot_dir, queries,
         out_path, device],
        env=env, capture_output=True, text=True, timeout=FLEET_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"aot child {name} failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    with open(out_path) as fh:
        rep = json.load(fh)
    got = np.load(out_path + ".npz")
    answers = tuple(got[f"arr_{i}"] for i in range(4))
    rep["seconds"] = {
        "interpreter_and_imports": rep["t_import"] - spawn,
        "load": rep["t_load"] - rep["t_import"],
        "restore": rep["t_restore"] - rep["t_load"],
        "warmup": rep["t_warm"] - rep["t_restore"],
        "first_answer": rep["t_answer"] - rep["t_warm"],
        "start_to_first_answer": rep["t_answer"] - spawn,
    }
    shutil.rmtree(build, ignore_errors=True)
    return rep, answers


def _expected_matches(uid, answers, i):
    top_p, top_rows, top_valid, _ = answers
    return [(uid[top_rows[i, r]], float(top_p[i, r]))
            for r in range(top_p.shape[1]) if top_valid[i, r]]


def _check_results(results, expect, what):
    """Raise unless every delivered full-service answer equals its
    expected matches and candidate count and every shed names a known
    reason; returns (delivered, degraded, shed reasons)."""
    delivered, degraded, reasons = 0, 0, {}
    for i, res in enumerate(results):
        if res is None:
            raise AssertionError(f"{what}: request {i} did not resolve")
        if res.shed:
            if res.reason not in FLEET_SHED_REASONS:
                raise AssertionError(f"{what}: request {i} shed with reason {res.reason!r}")
            reasons[res.reason] = reasons.get(res.reason, 0) + 1
            continue
        if res.degraded:
            degraded += 1
            continue
        want_m, want_n = expect(i)
        if res.matches != want_m or res.n_candidates != want_n:
            raise AssertionError(f"{what}: answer {i} differs from the in-process one: "
                                 f"{res.matches[:3]} vs {want_m[:3]}")
        delivered += 1
    return delivered, degraded, reasons


def _closed_loop(call, records, clients):
    """Per-request client-side latencies (ms) of ``clients`` closed-loop
    threads calling ``call(record) -> QueryResult``; returns (lat, results)."""
    import threading

    lat = [None] * len(records)
    results = [None] * len(records)

    def client(t):
        for i in range(t, len(records), clients):
            t0 = time.perf_counter()
            results[i] = call(records[i])
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return np.asarray(lat, np.float64), results


def _percentiles(lat):
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return {"p50_ms": float(p50), "p95_ms": float(p95), "p99_ms": float(p99),
            "mean_ms": float(lat.mean())}


def _wait_for(cond, what, timeout=FLEET_WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def fleet_phase(torch, strings_cuda, native, tf, engine, idx_dir, qdf, answers, out_dir,
                device="cuda"):
    """The serving fleet over the serve phase's index, engine, queries and
    batch-path answers: cold starts from the AOT sidecar in child
    processes, the replay over the wire, two replicas behind a router with
    a kill and a partition, federation and an incident bundle. Returns
    (fields, kernel launches of the wire replay)."""
    import shutil
    import socket

    from splink_tpu_torch.obs.events import register_ambient, unregister_ambient
    from splink_tpu_torch.obs.exposition import render_samples
    from splink_tpu_torch.obs.fleet import FleetAggregator, FleetIncidentReporter
    from splink_tpu_torch.obs.flight import FlightRecorder
    from splink_tpu_torch.resilience import faults
    from splink_tpu_torch.serve import (
        LinkageService,
        QueryEngine,
        RemoteReplica,
        ReplicaRouter,
        WireServer,
        load_index,
    )
    from splink_tpu_torch.serve.aot import MENU_NAME, libraries

    uid = engine.index.unique_id
    n_libs = len(libraries(engine.device))
    fields = {}

    def expect(i):
        return _expected_matches(uid, answers, i), int(answers[3][i])

    # -- 1. cold start from the sidecar, in child processes ----------------
    aot_dir = os.path.join(out_dir, "fleet_aot")
    shutil.rmtree(aot_dir, ignore_errors=True)
    t0 = time.perf_counter()
    engine.save_aot(aot_dir)
    save_s = time.perf_counter() - t0
    with open(os.path.join(aot_dir, MENU_NAME)) as fh:
        menu = json.load(fh)
    queries = os.path.join(out_dir, "fleet_queries.pkl")
    qdf.iloc[:FLEET_CHILD_QUERIES].to_pickle(queries)
    want = tuple(a[:FLEET_CHILD_QUERIES] for a in answers)

    def same(got):
        return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(got, want))

    rep_a, got_a = _run_aot_child("A", idx_dir, aot_dir, queries, out_dir, device, False)
    if rep_a["gxx"] or rep_a["nvcc"]:
        raise AssertionError(f"child A could reach a compiler: {rep_a['gxx']}, {rep_a['nvcc']}")
    if rep_a["stats"]["compiles"] != 0 or rep_a["stats"]["aot_restores"] != n_libs:
        raise AssertionError(f"child A: {rep_a['stats']}, expected 0 builds and {n_libs} "
                             "restores")
    if rep_a["degradations"] or not same(got_a):
        raise AssertionError(f"child A: events {rep_a['degradations']}, answers equal "
                             f"{same(got_a)}")
    rep_b, got_b = _run_aot_child("B", idx_dir, "", queries, out_dir, device, True)
    if rep_b["stats"]["compiles"] < 1 or rep_b["stats"]["aot_restores"] != 0 or not same(got_b):
        raise AssertionError(f"child B: {rep_b['stats']}, answers equal {same(got_b)}")
    bad_aot = os.path.join(out_dir, "fleet_aot_corrupt")
    shutil.rmtree(bad_aot, ignore_errors=True)
    shutil.copytree(aot_dir, bad_aot)
    victim = "jaro_winkler" if "jaro_winkler" in menu["libraries"] else "host"
    blob_path = os.path.join(bad_aot, menu["libraries"][victim]["file"])
    with open(blob_path, "rb") as fh:
        blob = bytearray(fh.read())
    blob[len(blob) // 2] ^= 0x01
    with open(blob_path, "wb") as fh:
        fh.write(bytes(blob))
    rep_c, got_c = _run_aot_child("C", idx_dir, bad_aot, queries, out_dir, device, True)
    events_c = [e["to"] for e in rep_c["degradations"] if e.get("from") == "serve_aot"]
    if (events_c != ["corrupt_blob"] or rep_c["stats"]["aot_restores"] != n_libs - 1
            or rep_c["stats"]["compiles"] != 1 or not same(got_c)):
        raise AssertionError(f"child C: events {rep_c['degradations']}, {rep_c['stats']}, "
                             f"answers equal {same(got_c)}")
    shutil.rmtree(bad_aot, ignore_errors=True)
    fields["cold_start"] = {
        "sidecar": {"save_s": save_s, "libraries": {
            k: {"bytes": v["bytes"], "library": v["library"]}
            for k, v in menu["libraries"].items()}, "toolchain": menu["toolchain"]},
        "queries": FLEET_CHILD_QUERIES,
        **{name: {"seconds": r["seconds"], "stats": r["stats"], "restored": r["restored"],
                  "warmup": r["warmup"], "answers_equal": True,
                  "compiler_reachable": bool(r["gxx"] or r["nvcc"]),
                  "degradations": [e["to"] for e in r["degradations"]]}
           for name, r in (("A_sidecar_no_compiler", rep_a), ("B_no_sidecar", rep_b),
                           (f"C_corrupt_{victim}_blob", rep_c))},
        "saved_s": rep_b["seconds"]["start_to_first_answer"]
        - rep_a["seconds"]["start_to_first_answer"],
    }

    # -- 2. the replay over the wire ----------------------------------------
    records = qdf.to_dict(orient="records")
    svc = LinkageService(engine, deadline_ms=SERVE_COALESCE_MS, probe_queries=0, name="fleet")
    server = WireServer(svc).start()
    remote = RemoteReplica(server.address, pool_size=2, request_timeout_ms=FLEET_WAIT_S * 1e3,
                           name="remote:fleet")
    zero_counts(strings_cuda, native, tf)
    b0 = svc.latency_summary()["batches"]
    results = [None] * len(records)
    t0 = time.perf_counter()
    for start in range(0, FLEET_SUBMIT_QUERIES, FLEET_WINDOW):
        futs = [remote.submit(records[i])
                for i in range(start, min(start + FLEET_WINDOW, FLEET_SUBMIT_QUERIES))]
        for k, f in enumerate(futs):
            results[start + k] = f.result(timeout=FLEET_WAIT_S)
    submit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for start in range(FLEET_SUBMIT_QUERIES, len(records), FLEET_WINDOW):
        futs = remote.submit_many(records[start:start + FLEET_WINDOW])
        for k, f in enumerate(futs):
            results[start + k] = f.result(timeout=FLEET_WAIT_S)
    many_s = time.perf_counter() - t0
    batches = svc.latency_summary()["batches"] - b0
    launches = dict(strings_cuda.launches)
    variants = dict(strings_cuda.variant_launches)
    want_v = {"jaro_winkler/u8/w1": 2 * batches, "levenshtein/u8/w1": batches}
    if device == "cuda" and variants != want_v:
        raise AssertionError(f"the wire replay launched {variants}, expected {want_v}")
    delivered, degraded, reasons = _check_results(results, expect, "wire replay")
    for part, lo, hi in (("submit", 0, FLEET_SUBMIT_QUERIES),
                         ("submit_many", FLEET_SUBMIT_QUERIES, len(records))):
        if not any(r is not None and not r.shed for r in results[lo:hi]):
            raise AssertionError(f"the wire replay delivered nothing through {part}")
    fields["wire_replay"] = {
        "queries": len(records), "submit": FLEET_SUBMIT_QUERIES,
        "submit_many": len(records) - FLEET_SUBMIT_QUERIES, "window": FLEET_WINDOW,
        "submit_s": submit_s, "submit_many_s": many_s, "delivered_equal": delivered,
        "degraded": degraded, "shed": reasons, "batches": batches, "launches": launches,
        "variant_launches": variants,
        "launches_per_batch": {k: v / max(batches, 1) for k, v in launches.items()},
    }
    lat_recs = records[:FLEET_LATENCY_QUERIES]
    latency = {}
    for mode, call in (
        ("wire", lambda r: remote.submit(r).result(timeout=FLEET_WAIT_S)),
        ("in_process", lambda r: svc.query(r, timeout=FLEET_WAIT_S)),
        ("wire_again", lambda r: remote.submit(r).result(timeout=FLEET_WAIT_S)),
    ):
        t0 = time.perf_counter()
        lat, res = _closed_loop(call, lat_recs, SERVE_CLIENTS)
        wall = time.perf_counter() - t0
        ok, deg, shed = _check_results(res, expect, f"closed loop {mode}")
        latency[mode] = {**_percentiles(lat), "queries_per_s": len(lat_recs) / wall,
                         "delivered_equal": ok, "degraded": deg, "shed": shed}
    stats = svc.fleet_stats()
    fields["latency"] = {"clients": SERVE_CLIENTS, "queries": FLEET_LATENCY_QUERIES,
                         "coalesce_window_ms": SERVE_COALESCE_MS, **latency,
                         "remote_summary": {k: v for k, v in remote.latency_summary().items()
                                            if k in ("server", "network", "p50_ms", "p95_ms",
                                                     "p99_ms")},
                         "wire_phases": {k: {f: v.get(f) for f in ("observations",)}
                                         for k, v in remote.wire_phases().items() if v},
                         "fleet_stats": {"counters": stats["counters"],
                                         "health": stats["health"],
                                         "perf_phases": sorted((stats.get("perf") or {})
                                                               .get("phases", {}))}}
    remote.close()
    server.close()
    svc.close()

    # -- 3. two replicas behind a router: a kill, a restart, a partition --
    router_flight = FlightRecorder(1024, dump_dir=os.path.join(out_dir, "fleet_flight"),
                                   name="router")
    register_ambient(router_flight)
    t0 = time.perf_counter()
    engines, svcs, servers, remotes = [], [], [], []
    for name in ("a", "b"):
        eng = QueryEngine(load_index(idx_dir, device=device), brownout_top_k=SERVE_BROWNOUT_TOP_K)
        eng.warmup()
        engines.append(eng)
        svcs.append(LinkageService(eng, deadline_ms=SERVE_COALESCE_MS, name=f"replica-{name}"))
        servers.append(WireServer(svcs[-1]).start())
        remotes.append(RemoteReplica(servers[-1].address, pool_size=2, name=f"remote:{name}",
                                     request_timeout_ms=FLEET_WAIT_S * 1e3,
                                     breaker_cooldown_s=0.2))
    replicas_s = time.perf_counter() - t0
    router = ReplicaRouter(remotes, hedge_ms=0)
    rrecs = records[:FLEET_ROUTER_QUERIES]
    done = [0]

    def routed(r):
        res = router.submit(r, deadline_ms=FLEET_DEADLINE_MS).result(timeout=FLEET_WAIT_S)
        done[0] += 1
        return res

    import threading

    def killer():
        _wait_for(lambda: done[0] >= FLEET_ROUTER_QUERIES // 3, "a third of the replay")
        servers[0].kill()

    kt = threading.Thread(target=killer)
    kt.start()
    lat, res = _closed_loop(routed, rrecs, SERVE_CLIENTS)
    kt.join()
    ok, deg, shed = _check_results(res, expect, "router replay with server A killed")
    if lat.max() > FLEET_DEADLINE_MS:
        raise AssertionError(f"a routed request resolved {lat.max()} ms after submission, "
                             f"past its {FLEET_DEADLINE_MS} ms deadline")
    if router.failovers < 1:
        raise AssertionError(f"the router shows no failover: {router.health()}")
    kill = {"queries": len(rrecs), "deadline_ms": FLEET_DEADLINE_MS,
            "killed_after": FLEET_ROUTER_QUERIES // 3, "delivered_equal": ok, "degraded": deg,
            "shed": shed, "max_ms": float(lat.max()), **_percentiles(lat),
            "router": {k: router.health()[k] for k in ("dispatched", "hedges", "failovers")},
            "remote_a_sheds": remotes[0].sheds}
    # server A restarts on its port; the remote's reconnector re-admits it
    port_a = servers[0].port
    servers[0] = WireServer(svcs[0], port=port_a).start()
    _wait_for(lambda: not remotes[0].submit(rrecs[0]).result(timeout=FLEET_WAIT_S).shed,
              "remote A to reconnect after the restart")
    # a partition of B from its accept site: the next connection B accepts
    # fires the plan in B's own settings (no other server reads them)
    b_settings = engines[1].index.settings
    healed = []

    class HealSink:
        def emit(self, etype, **f):
            if etype == "wire_partition_heal":
                healed.append(f)

    heal_sink = HealSink()
    register_ambient(heal_sink)
    b_settings["fault_plan"] = f"wire_accept@kind=net_partition:delay_ms={FLEET_PARTITION_MS}"
    faults.reset_plans()
    t_part = time.monotonic()
    try:
        host, port = servers[1].address.rsplit(":", 1)
        probe = socket.create_connection((host, int(port)), timeout=5)
        _wait_for(lambda: servers[1].stats()["partitioned"], "the partition of B")
        probe.close()
        during = [router.submit(r, deadline_ms=FLEET_DEADLINE_MS).result(timeout=FLEET_WAIT_S)
                  for r in rrecs[:64]]
        ok_d, _, shed_d = _check_results(during, expect, "router during B's partition")
        _wait_for(lambda: bool(healed), "B's partition to heal")
        _wait_for(lambda: any(r.get("type") == "wire_reconnect"
                              and r.get("replica") == remotes[1].name
                              for r in router_flight.snapshot()),
                  "remote B's wire_reconnect in the flight recorder")
    finally:
        b_settings.pop("fault_plan", None)
        faults.reset_plans()
        unregister_ambient(heal_sink)
    heal_s = time.monotonic() - t_part
    after = [remotes[1].submit(r).result(timeout=FLEET_WAIT_S) for r in rrecs[:64]]
    ok_b, _, shed_b = _check_results(after, expect, "remote B after the heal")
    if not ok_b:
        raise AssertionError("remote B delivered nothing after the heal")
    fields["router"] = {
        "replicas_setup_s": replicas_s, "kill": kill,
        "partition": {"delay_ms": FLEET_PARTITION_MS, "heal": healed[0],
                      "trigger_to_reconnect_s": heal_s,
                      "routed_during": {"delivered_equal": ok_d, "shed": shed_d},
                      "remote_b_after": {"delivered_equal": ok_b, "shed": shed_b},
                      "remote_b_reconnects": remotes[1].reconnects,
                      "flight_transitions": sorted({r.get("type") for r in
                                                    router_flight.snapshot()})},
    }

    # -- 4. federation and an incident bundle --------------------------------
    agg = FleetAggregator(remotes=remotes)
    t0 = time.perf_counter()
    merged = agg.scrape(force=True)
    scrape_ms = (time.perf_counter() - t0) * 1e3
    raw = agg.raw_snapshots()
    if len(raw) != 2:
        raise AssertionError(f"the aggregator reached {len(raw)} of 2 replicas")
    for key, value in merged["counters"].items():
        if value != sum(s["counters"].get(key, 0) for s in raw):
            raise AssertionError(f"merged counter {key} is not the sum of the replicas'")
    for phase, h in (merged.get("perf") or {}).get("phases", {}).items():
        parts = [s["perf"]["phases"][phase] for s in raw
                 if phase in (s.get("perf") or {}).get("phases", {})]
        total = 0.0
        for part in parts:
            total += part["sum"]
        width = max(len(part["counts"]) for part in parts)
        counts = [sum(part["counts"][i] for part in parts if i < len(part["counts"]))
                  for i in range(width)]
        if h["sum"] != total or h["n"] != sum(x["n"] for x in parts) or h["counts"] != counts:
            raise AssertionError(f"merged histogram {phase} is not the union of the replicas'")
    text = render_samples(agg.prometheus_samples())
    for name in ("replica-a", "replica-b"):
        if f'replica="{name}"' not in text:
            raise AssertionError(f"the federated exposition lacks {name}")
    if "splink_fleet_hosts 2" not in text:
        raise AssertionError("the federated exposition does not count 2 hosts")
    reporter = FleetIncidentReporter(local_flight=router_flight, remotes=remotes,
                                     bundle_dir=os.path.join(out_dir, "fleet_incidents"),
                                     interval_s=3600.0)
    b_settings["fault_plan"] = "serve_batch@kind=transient:times=3"
    faults.reset_plans()
    try:
        for r in rrecs[:3]:
            res_b = svcs[1].query(r, timeout=FLEET_WAIT_S)
            if not res_b.shed or res_b.reason != "batch_error":
                raise AssertionError(f"an injected batch failure served: {res_b}")
        if svcs[1].breaker.state != "open":
            raise AssertionError(f"replica B's breaker is {svcs[1].breaker.state} after 3 "
                                 "failed batches")
        _wait_for(lambda: len(reporter.bundles) >= 1, "the incident bundle")
        time.sleep(0.5)  # a second bundle would be a rate-limit failure
    finally:
        b_settings.pop("fault_plan", None)
        faults.reset_plans()
    if len(reporter.bundles) != 1 or "incident_breaker_open_" not in reporter.bundles[0]:
        raise AssertionError(f"incident bundles {reporter.bundles}")
    with open(os.path.join(reporter.bundles[0], "manifest.json")) as fh:
        manifest = json.load(fh)
    fields["federation"] = {
        "scrape_ms": scrape_ms, "hosts": len(merged["hosts"]),
        "counters": merged["counters"], "merged_equal_union": True,
        "phases": sorted((merged.get("perf") or {}).get("phases", {})),
        "exposition_lines": len(text.splitlines()),
        "incident": {"trigger": manifest.get("trigger"), "files": manifest.get("files"),
                     "unreachable": manifest.get("unreachable")},
    }
    reporter.close()
    for obj in (*remotes, *servers, *svcs):
        obj.close()
    unregister_ambient(router_flight)
    router_flight.close()
    del engines, svcs, servers, remotes, router
    shutil.rmtree(os.path.join(out_dir, "fleet_incidents"), ignore_errors=True)
    shutil.rmtree(aot_dir, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    return fields, launches


# ----------------------------------------------------------------------
# The approximate tier: minhash-LSH blocking offline and served
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# Observability: run telemetry at the main path's size, profile_dir, the
# quality profile, the serve-time drift sketch and the drift monitor
# ----------------------------------------------------------------------

OBS_TIMING_ROUNDS = 11  # 1,024-query batches timed with the sketch on and off, in turns
OBS_DRIFT_WINDOW_S = 4.0  # the monitor's short window (the long one is 5x), on its own clock
OBS_DRIFT_CHUNK = 256  # service records per drained window
OBS_CLEAN_WINDOWS = 16
OBS_SHIFT_WINDOWS = 8
OBS_PROFILED_STAGES = {"gammas", "em"}  # the resident path's traced stages, overlap off
OBS_KERNEL_NAMES = ("jaro_winkler_kernel", "levenshtein_kernel")  # their __global__ names


def telemetry_record_checks(events, linker, n_pairs, total_bytes):
    """The run record's gates; returns the stages, the per-stage peak device
    bytes and the EM record count. ``total_bytes`` None (the CPU dry run)
    skips the memory gates: the CPU takes no snapshots."""
    result = linker._last_em_result
    iters = [e for e in events if e["type"] == "em_iteration"]
    n = int(result.n_updates)
    if [e["iteration"] for e in iters] != list(range(1, n + 1)):
        raise AssertionError(f"em_iteration records {[e['iteration'] for e in iters]}, "
                             f"expected 1..{n}")
    for e in iters:
        it = e["iteration"]
        m_h, u_h = result.m_history.astype(float), result.u_history.astype(float)
        delta = float(max(np.max(np.abs(m_h[it] - m_h[it - 1])),
                          np.max(np.abs(u_h[it] - u_h[it - 1]))))
        if e["lam"] != float(result.lam_history[it]) or e["delta"] != delta:
            raise AssertionError(f"em_iteration {it} differs from the history")
    if iters[-1]["converged"] != bool(result.converged):
        raise AssertionError("the last em_iteration's convergence flag differs")
    snap = [e for e in events if e["type"] == "metrics"][-1]
    if snap["counters"]["pairs_blocked"] != n_pairs:
        raise AssertionError(f"pairs_blocked {snap['counters']['pairs_blocked']} != {n_pairs}")
    G = linker._G
    want = {}
    for c, col in enumerate(linker.settings["comparison_columns"]):
        levels = int(col["num_levels"])
        want[col["col_name"]] = np.bincount(G[:, c].astype(np.int64) + 1,
                                            minlength=levels + 1).tolist()
    if snap["records"]["gamma_histogram"] != want:
        raise AssertionError("gamma_histogram differs from a host bincount of the gammas")
    stages = [e["name"] for e in events if e["type"] == "span" and e["kind"] == "stage"]
    memory = [e for e in events if e["type"] == "memory"]
    if total_bytes is None:
        return stages, {}, len(iters)
    if [e["stage"] for e in memory] != stages:
        raise AssertionError(f"memory snapshots {[e['stage'] for e in memory]} != stages "
                             f"{stages}")
    peaks = {}
    for e in memory:
        for d in e["devices"]:
            if not 0 < d["peak_bytes_in_use"] <= d["bytes_limit"] <= total_bytes:
                raise AssertionError(f"stage {e['stage']}: memory snapshot {d}")
        peaks[e["stage"]] = max(d["peak_bytes_in_use"] for d in e["devices"])
    return stages, peaks, len(iters)


def count_syncs(torch, fn):
    """Synchronizing CUDA operations fn() makes (``set_sync_debug_mode``'s
    warnings: reads back to the host, and host-to-device copies from
    pageable memory, which wait for the stream), as {"file:line": count}
    of the Python lines that made them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def kernel_ms(torch, fn, out_dir):
    """Milliseconds of CUDA kernel time in one fn() call: the sum of the
    kernel events of a torch.profiler trace (the device's busy time alone,
    without the gaps where it waits for the host's launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "kernel_ms_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.unlink(path)
    return sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3


def trace_kernel_events(path):
    """Names of the CUDA kernel events in one Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def obs_phase(torch, splink_tpu_torch, strings_cuda, native, tf, df, linker, sub, engine,
              index, qdf, answers, out_dir):
    """Returns (fields, launches of the sketching batch path). Runs on the
    linker's device; on the CPU (a dry run of the phase's logic) the gates
    that need the card (kernel launches, memory snapshots, kernel events in
    a trace, device times) are skipped."""
    import shutil

    from splink_tpu_torch.gammas import PairContext, _spec_gamma
    from splink_tpu_torch.obs import quality
    from splink_tpu_torch.obs.events import read_events, register_ambient, unregister_ambient
    from splink_tpu_torch.obs.quality import MATCH_PROBABILITY, capture_profile
    from splink_tpu_torch.serve import LinkageService, QueryEngine, load_index

    fields = {}
    dev = linker.device
    cuda = dev.type == "cuda"
    total_bytes = torch.cuda.get_device_properties(dev).total_memory if cuda else None
    n_pairs = linker._pairs.n_pairs

    # -- run telemetry at the main path's size: training and scoring (no
    # -- pandas frame), against the main path's telemetry-off run ----------
    tel_dir = os.path.join(out_dir, "obs_telemetry")
    shutil.rmtree(tel_dir, ignore_errors=True)

    def train_and_score(telemetry: bool):
        s = json.loads(json.dumps(SETTINGS))
        if telemetry:
            s.update(telemetry_dir=tel_dir, telemetry_memory=True)
        t0 = time.perf_counter()
        run = splink_tpu_torch.Splink(s, df=df, device=dev)
        run.estimate_parameters()
        with run._timed("score"):
            p = run._score_batched(run._G)[0]
        wall = time.perf_counter() - t0
        if telemetry:
            run._obs.finish()
            run.close_telemetry()
        return run, p, wall

    zero_counts(strings_cuda, native, tf)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tl, p_on, tel_wall = train_and_score(True)
    tel_launches = dict(strings_cuda.launches)
    if cuda:
        check_path_counts("the telemetry run", strings_cuda, native)
    if tl.params.param_history != linker.params.param_history or \
            tl.params.params != linker.params.params:
        raise AssertionError("the telemetry run's parameters or history differ from the "
                             "main path's")
    main_p = linker._score_batched(linker._G)[0]
    if not np.array_equal(p_on, main_p):
        raise AssertionError("the telemetry run's scores differ from the main path's")
    record = tl._obs.sink.path
    events = read_events(record)
    stages, peaks, n_records = telemetry_record_checks(events, tl, n_pairs, total_bytes)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "splink_tpu_torch.obs", "summarize", record],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"obs summarize exited {cli.returncode}: {cli.stderr[-2000:]}")
    missing = [s for s in stages if f"\n{s} " not in cli.stdout]
    if missing:
        raise AssertionError(f"obs summarize does not name the stages {missing}")
    # the same job with telemetry off and on, in turns after the gated run
    walls = {"on": [tel_wall], "off": []}
    for telemetry in (False, False, True):
        walls["on" if telemetry else "off"].append(train_and_score(telemetry)[2])
    compared = ("encode", "gamma_program", "blocking", "gammas", "em", "score")
    fields["telemetry"] = {
        "run": "estimate_parameters() and scoring, without the pandas frame",
        "pairs": n_pairs, "em_updates": n_records, "launches": tel_launches,
        "wall_s": tel_wall, "stage_s": tl.stage_seconds,
        "wall_s_in_turns": walls, "median_wall_s_on": float(np.median(walls["on"])),
        "median_wall_s_off": float(np.median(walls["off"])),
        "stages_s_on": sum(tl.stage_seconds.get(s, 0.0) for s in compared),
        "stages_s_off": sum(linker.stage_seconds.get(s, 0.0) for s in compared),
        "stages_compared": compared, "record_bytes": os.path.getsize(record),
        "record_events": len(events), "peak_device_bytes": peaks,
        "summarize_s": cli_s, "parameters_bit_identical": True,
    }
    del tl, p_on, main_p

    # -- profile_dir on the parity subset: one torch.profiler trace per
    # -- device-heavy stage, the card's kernels in the gammas trace ----------
    prof_dir = os.path.join(out_dir, "obs_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    t0 = time.perf_counter()
    pl = splink_tpu_torch.Splink(
        dict(json.loads(json.dumps(SETTINGS)), profile_dir=prof_dir, overlap_blocking=False,
             quality_profile=True), df=sub, device=dev)
    pl.get_scored_comparisons()
    prof_s = time.perf_counter() - t0
    traces = {d: sorted(os.listdir(os.path.join(prof_dir, d))) for d in os.listdir(prof_dir)}
    if set(traces) != OBS_PROFILED_STAGES or any(len(v) != 1 for v in traces.values()):
        raise AssertionError(f"profile_dir traces {traces}")
    kernel_events = {d: trace_kernel_events(os.path.join(prof_dir, d, v[0]))
                     for d, v in traces.items()}
    found = {k: sum(k in name for name in kernel_events["gammas"]) for k in OBS_KERNEL_NAMES}
    if cuda and not kernel_events["gammas"]:
        raise AssertionError("the gammas trace records no CUDA kernel event")
    if cuda and not all(found.values()):
        raise AssertionError(f"the gammas trace lacks a hand kernel: {found}")
    fields["profile_dir"] = {
        "rows": len(sub), "pairs": pl._pairs.n_pairs, "wall_s": prof_s,
        "traces": traces, "kernel_events": {d: len(v) for d, v in kernel_events.items()},
        "hand_kernel_events_in_gammas": found,
        "trace_bytes": {d: os.path.getsize(os.path.join(prof_dir, d, v[0]))
                        for d, v in traces.items()},
    }
    # a profiled artifact at this size: save, load, equal profile arrays
    wide_dir = os.path.join(out_dir, "obs_profiled_index")
    shutil.rmtree(wide_dir, ignore_errors=True)
    small = pl.export_index(wide_dir)
    again = load_index(wide_dir, device=dev)
    for name in ("gamma_hist", "score_hist", "gamma_hist_matched", "score_hist_matched"):
        if not np.array_equal(getattr(small.profile, name), getattr(again.profile, name)):
            raise AssertionError(f"profile {name} differs after a save and a load")
    if small.profile.to_meta() != again.profile.to_meta():
        raise AssertionError("profile meta differs after a save and a load")
    del pl, small, again

    # -- the quality profile over the main path's 16.1M training pairs ----
    fp0 = index.content_fingerprint()
    linker._sync_device()
    t0 = time.perf_counter()
    profile = capture_profile(linker)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quality._column_table_stats(linker._table, linker.settings)
    host_stats_s = time.perf_counter() - t0
    G = linker._G
    bins = profile.bins
    width = max(profile.num_levels) + 1
    fn = quality.make_profile_fn(tuple(profile.num_levels), bins)
    params = linker._em_init()
    chunk0 = torch.from_numpy(np.ascontiguousarray(G[:quality._PROFILE_CHUNK])).to(dev)
    chunk_ms = cuda_ms(torch, lambda: fn(chunk0, params)) if cuda else None
    chunk_kernel_ms = kernel_ms(torch, lambda: fn(chunk0, params), out_dir) if cuda else None
    n_chunks = -(-len(G) // quality._PROFILE_CHUNK)
    del chunk0
    # the host recount from the card's own G and p
    p = linker._score_batched(G)[0]
    matched = p >= MATCH_PROBABILITY
    sbin = np.clip((p * bins).astype(np.int64), 0, bins - 1)
    want = {"gamma_hist": np.zeros((len(profile.columns), width), np.int64),
            "gamma_hist_matched": np.zeros((len(profile.columns), width), np.int64),
            "score_hist": np.bincount(sbin, minlength=bins),
            "score_hist_matched": np.bincount(sbin[matched], minlength=bins)}
    for c in range(len(profile.columns)):
        g = G[:, c].astype(np.int64) + 1
        want["gamma_hist"][c] = np.bincount(g, minlength=width)
        want["gamma_hist_matched"][c] = np.bincount(g[matched], minlength=width)
    for name, arr in want.items():
        if not np.array_equal(getattr(profile, name), arr):
            raise AssertionError(f"capture_profile {name} differs from the host recount")
    index.profile = profile
    index._content_fp = None
    if index.content_fingerprint() != fp0:
        raise AssertionError("attaching the profile changed the content fingerprint")
    fields["quality_profile"] = {
        "pairs": profile.n_pairs, "matched_pairs": profile.n_matched_pairs,
        "capture_s": capture_s, "host_column_stats_s": host_stats_s,
        "device_ms_per_chunk": chunk_ms, "kernel_ms_per_chunk": chunk_kernel_ms,
        "chunks": n_chunks,
        "device_ms": chunk_ms * n_chunks if cuda else None,
        "host_recount_equal": True, "fingerprint_unchanged": True,
        "null_rates": profile.null_rates,
    }
    del p, matched, sbin

    # -- the drift sketch over the batch path: answers == the sketch-off
    # -- engine's, drained counts == a host oracle ---------------------------
    sk = QueryEngine(index, sketch=True)
    sk.warmup()
    if sk.sketch is None:
        raise AssertionError("sketch=True over a profiled index made no sketch")
    sk.drain_drift()
    zero_counts(strings_cuda, native, tf)
    outs = []
    t0 = time.perf_counter()
    for start in range(0, SERVE_QUERIES, SERVE_CHUNK):
        outs.append(sk.query_arrays(qdf.iloc[start:start + SERVE_CHUNK]))
    sk_wall = time.perf_counter() - t0
    sk_launches = dict(strings_cuda.launches)
    sk_variants = dict(strings_cuda.variant_launches)
    n_batches = len(outs)
    window = sk.drain_drift()
    got = tuple(np.concatenate([o[i] for o in outs]) for i in range(4))
    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, answers)):
        raise AssertionError("the sketching engine's answers differ from the sketch-off ones")
    want_variants = {"jaro_winkler/u8/w1": 4 * n_batches, "levenshtein/u8/w1": 2 * n_batches}
    if cuda and sk_variants != want_variants:
        raise AssertionError(f"sketching batch path launched {sk_variants}, expected "
                             f"{want_variants}")
    top_p, top_rows, top_valid, _ = got
    qi, ki = np.nonzero(top_valid & (top_p >= MATCH_PROBABILITY))
    rows_q = index.encode_queries(qdf).packed[qi]
    ctx = PairContext(index.layout, torch.from_numpy(rows_q.view(np.int32)),
                      torch.from_numpy(index.packed[top_rows[qi, ki]].view(np.int32)))
    gamma = np.stack([np.bincount(_spec_gamma(col, ctx, False).numpy().astype(np.int64) + 1,
                                  minlength=width)
                      for col in index.settings["comparison_columns"]])
    sb = np.clip((top_p * bins).astype(np.int64), 0, bins - 1)
    oracle = {"gamma": gamma,
              "score": np.bincount(sb[top_valid & (top_p >= MATCH_PROBABILITY)], minlength=bins),
              "score_all": np.bincount(sb[top_valid], minlength=bins)}
    for name, arr in oracle.items():
        if not np.array_equal(getattr(window, name), arr):
            raise AssertionError(f"drained sketch {name} differs from the host oracle")
    if window.counters["queries"] != SERVE_QUERIES:
        raise AssertionError(f"sketch counted {window.counters['queries']} queries")
    # a 1,024-query batch with and without the sketch, in turns; the
    # sketch's update alone on the card
    part = qdf.iloc[:SERVE_CHUNK]
    on, off = [], []
    for i in range(2 * OBS_TIMING_ROUNDS):
        eng = (sk, engine)[(i + i // 2) % 2]
        t0 = time.perf_counter()
        eng.query_arrays(part)
        (on if eng is sk else off).append((time.perf_counter() - t0) * 1e3)
    b = sk.encode(part)
    packed = torch.from_numpy(b.packed.view(np.int32)).to(dev)
    tp, tr, tv = (torch.from_numpy(np.ascontiguousarray(a[:SERVE_CHUNK])).to(dev)
                  for a in (top_p, top_rows, top_valid))
    ref_packed = index.device_state()["packed"]

    def update():
        sk.sketch.update(packed, ref_packed, tr, tv, tp)

    update_ms = cuda_ms(torch, update) if cuda else None
    update_call_ms = cuda_ms(torch, update, device_only=False) if cuda else None
    update_kernel_ms = kernel_ms(torch, update, out_dir) if cuda else None
    # synchronizing operations: the sketch's update makes none (it reads
    # nothing back and copies nothing from the host); a served batch's, and
    # where they are
    syncs = {}
    if cuda:
        count_syncs(torch, lambda: None)  # the debug mode's own first use
        sites = {"sketch_update": count_syncs(torch, update),
                 "query_arrays_1024_sketch_off": count_syncs(
                     torch, lambda: engine.query_arrays(part)),
                 "query_arrays_1024_sketch_on": count_syncs(
                     torch, lambda: sk.query_arrays(part))}
        syncs = {k: sum(v.values()) for k, v in sites.items()}
        syncs["sites"] = sites
        if syncs["sketch_update"] or (syncs["query_arrays_1024_sketch_on"]
                                      != syncs["query_arrays_1024_sketch_off"]):
            raise AssertionError(f"the drift sketch synchronizes: {syncs}")
    sk.drain_drift()
    fields["sketch"] = {
        "queries": SERVE_QUERIES, "batches": n_batches, "wall_s": sk_wall,
        "answers_equal_sketch_off": True, "host_oracle_equal": True,
        "matched_winners": int(len(qi)), "launches": sk_launches,
        "variant_launches": sk_variants,
        "launches_per_batch": {k: v / n_batches for k, v in sk_launches.items()},
        "median_batch_ms_on": float(np.median(on)), "median_batch_ms_off": float(np.median(off)),
        "batch_ms_on": on, "batch_ms_off": off,
        "update_device_ms": update_ms, "update_call_ms": update_call_ms,
        "update_kernel_ms": update_kernel_ms,
        "synchronizing_ops": syncs,
        "counters": {k: v for k, v in window.counters.items() if k != "nulls"},
    }
    del packed, tp, tr, tv

    # -- the drift monitor: a service over the sketching engine, on the
    # -- monitor's own clock; a clean replay, then city shifted ----------------
    class Capture:
        def __init__(self):
            self.events = []

        def emit(self, type, **fields):
            if type.startswith("drift_"):
                self.events.append({"type": type, **fields})

    flight_dir = os.path.join(out_dir, "obs_flight")
    shutil.rmtree(flight_dir, ignore_errors=True)
    saved = {k: index.settings.get(k) for k in ("telemetry_dir", "drift_window_s")}
    index.settings.update(telemetry_dir=flight_dir, drift_window_s=OBS_DRIFT_WINDOW_S)
    cap = Capture()
    register_ambient(cap)
    try:
        svc = LinkageService(sk, deadline_ms=SERVE_COALESCE_MS, name="obs-drift")
        clock = [0.0]
        svc._drift._clock = lambda: clock[0]
        rng = np.random.default_rng(SEED + 5)
        cities = qdf["city"].dropna().to_numpy(object)

        def replay(w, shift):
            part = qdf.iloc[(w * OBS_DRIFT_CHUNK) % SERVE_QUERIES:][:OBS_DRIFT_CHUNK]
            if shift:
                part = part.assign(city=rng.choice(cities, len(part)))
            futs = [svc.submit(r) for r in part.to_dict(orient="records")]
            res = [f.result(timeout=60) for f in futs]
            if any(r.shed for r in res):
                raise AssertionError("a drift replay request was shed")
            clock[0] += 1.0
            svc._drift_tick(force=True)

        t0 = time.perf_counter()
        for w in range(OBS_CLEAN_WINDOWS):
            replay(w, False)
        clean = svc.drift_snapshot()
        alert_psi = clean["alert_psi"]
        clean_max = max(clean["short"]["max_psi"], clean["long"]["max_psi"])
        if clean["alerts"] or not clean_max < alert_psi or cap.events and any(
                e["type"] == "drift_alert" for e in cap.events):
            raise AssertionError(f"a clean replay alerted or reached PSI {clean_max}")
        for w in range(OBS_SHIFT_WINDOWS):
            replay(OBS_CLEAN_WINDOWS + w, True)
        shifted = svc.drift_snapshot()
        drift_s = time.perf_counter() - t0
        svc.close()
    finally:
        unregister_ambient(cap)
        index.settings.update(saved)
    alerts = [e for e in cap.events if e["type"] == "drift_alert"]
    channels = [a["channel"] for a in shifted["alerts"]]
    if len(alerts) != 1 or "gamma:city" not in channels or not shifted["alert_active"]:
        raise AssertionError(f"city drift: {len(alerts)} drift_alert event(s), snapshot "
                             f"alerts {channels}")
    dumps = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) else []
    if not dumps:
        raise AssertionError("the drift alert dumped no flight recorder into telemetry_dir")
    with open(os.path.join(flight_dir, dumps[-1])) as fh:
        if not any(json.loads(line).get("type") == "drift_alert" for line in fh):
            raise AssertionError("the flight dump holds no drift_alert record")
    fields["drift_monitor"] = {
        "window_s": OBS_DRIFT_WINDOW_S, "records_per_window": OBS_DRIFT_CHUNK,
        "clean_windows": OBS_CLEAN_WINDOWS, "shifted_windows": OBS_SHIFT_WINDOWS,
        "clean_max_psi": clean_max, "clean_channels": clean["short"]["channels"],
        "alert_psi": alert_psi, "alert_channels": channels,
        "shifted_short_channels": shifted["short"]["channels"],
        "drift_window_events": sum(e["type"] == "drift_window" for e in cap.events),
        "flight_dumps": dumps, "seconds": drift_s,
    }
    index.profile = None
    index._content_fp = None
    return fields, sk_launches


APPROX_BASE = 50_000  # bench.py's n_base: 100,000 rows with the twins
APPROX_PARITY_BASE = 5_000  # the corpus held on the card against the CPU
APPROX_SERVE_POLICY = ((1024,), (256, 2048, 16384))
APPROX_TOP_K = 8
APPROX_RECALL_MIN = 0.8  # planted twins found at the budget (the reference: 0.89)


def analysis_phase(torch, strings_cuda):
    """The three measured analysis layers on the card over every registered
    kernel, against the committed ``cuda`` tier: any finding raises.
    Returns the phase's fields."""
    from splink_tpu_torch.analysis import num_audit, perf_audit, trace_audit

    fields = {}
    t0 = time.perf_counter()
    findings, fields["kernels_audited"] = trace_audit.run_audit(device="cuda")
    fields["trace_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    num_findings, fields["num_audited"] = num_audit.run_num_audit(device="cuda")
    fields["num_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    measured = {}
    perf_findings, fields["perf_cells"] = perf_audit.run_perf_audit(
        device="cuda", measured_out=measured)
    fields["perf_s"] = time.perf_counter() - t0
    findings = findings + num_findings + perf_findings
    if findings:
        raise AssertionError("analysis findings on the card:\n"
                             + "\n".join(f.format() for f in findings))
    records = {name: spec.cache[("record", "cuda")]
               for name, spec in sorted(trace_audit.REGISTRY.items())}
    # the hand kernels' registry entries launch the hand kernels: the
    # records carry the launches, and one more call adds one to each count
    launched = {}
    for kernel in KERNELS:
        ops = [op[0] for op in records[kernel].ops]
        if f"strings_cuda.{kernel}/u8/w1" not in ops:
            raise AssertionError(f"registry entry {kernel} did not launch its kernel: {ops[-3:]}")
        before = strings_cuda.launches[kernel]
        fn, args, kwargs = trace_audit.REGISTRY[kernel].built("cuda")
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        launched[kernel] = strings_cuda.launches[kernel] - before
        if launched[kernel] != 1:
            raise AssertionError(f"{kernel}: {launched[kernel]} launches from one call")
    fields["registry_launches"] = launched
    fields["execute_ms"] = {cell: rec["execute_ms"] for cell, rec in measured.items()}
    fields["syncs"] = {name: trace_audit.sync_count(r) for name, r in records.items()}
    fields["syncs_recorded"] = {name: len(r.syncs) for name, r in records.items()}
    # the phases after this one need the card's memory, not the audits'
    # memoised inputs (the full-size cells hold ~0.1 GB)
    for spec in trace_audit.REGISTRY.values():
        spec.cache.clear()
    trace_audit.shared_fs_inputs.cache_clear()
    trace_audit.shared_gamma_program.cache_clear()
    return fields


def approx_settings(n_base: int, **over):
    """The main path's comparison columns, blocked on the names alone, with
    the approximate tier at bench.py's settings: threshold 0.2 and a budget
    of 8 pairs per base record."""
    s = json.loads(json.dumps(SETTINGS))
    s.update(blocking_rules=["l.first_name = r.first_name", "l.surname = r.surname"],
             approx_blocking=True, approx_threshold=0.2, approx_pair_budget=8 * n_base)
    s.update(over)
    return s


def make_typo_corpus(n_base: int, seed: int):
    """bench.py's approximate-blocking corpus (bench_approx) over
    make_people's rows: the names suffixed by ``i % 1000`` and ``i % 997``
    (near-unique keys), then one twin of each base row whose first_name AND
    surname carry a '#' at a seeded position, so the exact rules cannot
    pair a twin with its source. The true matches are (k, k + n_base)."""
    import pandas as pd

    base, _ = make_people(n_base, seed)
    k = np.arange(n_base)
    # str() of each value, as bench.py's astype(str) gave (a null is "None")
    base["first_name"] = [f"{v}{i}" for v, i in zip(base["first_name"], k % 1000)]
    base["surname"] = [f"{v}{i}" for v, i in zip(base["surname"], k % 997)]
    twins = base.copy()
    twins["unique_id"] = twins["unique_id"] + n_base
    crng = np.random.default_rng(seed + 1)

    def corrupt(v):
        i = int(crng.integers(0, len(v)))
        return v[:i] + "#" + v[i + 1:]

    twins["first_name"] = [corrupt(v) for v in twins["first_name"]]
    twins["surname"] = [corrupt(v) for v in twins["surname"]]
    return pd.concat([base, twins], ignore_index=True)


def twin_recall(i, j, n_base: int) -> float:
    """Share of the planted twins (k, k + n_base) among the pairs."""
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    hit = (j - i == n_base) & (i < n_base)
    return float(len(np.unique(i[hit])) / n_base)


def weighted_parted_lanes(torch, minhash, lsh, settings, table):
    """The TF-weighted signatures on the card against the CPU, lane by lane
    (one row per band, so a key is a bijection of its lane). Raises unless
    every lane that parts was decided by two race values within 2 float32
    ulp; returns the parted lanes."""
    cfg = lsh.ApproxConfig.from_settings(settings, table)
    cols = lsh.column_arrays(table, cfg.cols)
    idf = minhash.idf_weights(*minhash.gram_df_table(cols, cfg.q, device="cpu"))
    lanes = cfg.bands * cfg.rows_per_band
    keys = {dev: minhash.band_key_arrays(cols, cfg.q, lanes, 1, idf=idf, device=dev)[0]
            for dev in ("cuda", "cpu")}
    parted = np.argwhere(keys["cuda"] != keys["cpu"])
    a, b = minhash.hash_params(lanes)
    salts = minhash.column_salts(len(cols))
    out = []
    for row, lane in parted[:64]:
        race = []
        for c, (bytes_, lengths) in enumerate(cols):
            h, valid = minhash._gram_hashes(minhash._upload_chars(bytes_[row:row + 1], "cpu"),
                                            torch.from_numpy(lengths[row:row + 1]), cfg.q,
                                            int(salts[c]))
            hk = (minhash._mul32(h, int(a[lane])) + int(b[lane])) & 0xFFFFFFFF
            hk = hk ^ (hk >> 13)
            hk = minhash._mul32(hk, 0x85EBCA6B)
            hk = hk ^ (hk >> 16)
            e = (minhash._neg_log_f32(hk) / torch.from_numpy(idf)[h >> 16])[valid]
            race += e.tolist()
        first, second = sorted(race)[:2]
        gap = (second - first) / float(np.spacing(np.float32(second)))
        if gap > 2:
            raise AssertionError(f"weighted lane ({row}, {lane}) parts card vs CPU with its "
                                 f"race decided by {gap} ulp")
        out.append({"row": int(row), "lane": int(lane), "race_gap_ulp": gap})
    if len(parted) > 64:
        raise AssertionError(f"{len(parted)} weighted lanes part card vs CPU")
    return out


def approx_phase(torch, splink_tpu_torch, strings_cuda, native, tf, out_dir):
    """The approximate tier at bench.py's size; returns (fields, launches of
    its main path)."""
    import shutil

    from splink_tpu_torch import blocking
    from splink_tpu_torch.approx import lsh, minhash
    from splink_tpu_torch.blocking_device import iter_device_pairs
    from splink_tpu_torch.obs.metrics import compile_requests
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index

    fields = {"smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    t0 = time.perf_counter()
    df = make_typo_corpus(APPROX_BASE, SEED + 7)
    fields["data_gen_s"] = time.perf_counter() - t0
    settings = approx_settings(APPROX_BASE)
    budget = settings["approx_pair_budget"]

    # -- the main path: training and scoring through the public entry point
    zero_counts(strings_cuda, native, tf)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    linker = splink_tpu_torch.Splink(json.loads(json.dumps(settings)), df=df)
    df_e = linker.get_scored_comparisons()
    e2e_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(strings_cuda.launches)
    variants = dict(strings_cuda.variant_launches)
    check_path_counts("the approximate path", strings_cuda, native, tier="host")
    run = dict(lsh.last_run)
    if run.get("device") != "cuda:0" and run.get("device") != "cuda":
        raise AssertionError(f"the approximate tier ran on {run.get('device')}")
    pairs = linker._pairs
    emitted = run["emitted"]
    n_exact = pairs.n_pairs - emitted
    if not 0 < emitted <= budget:
        raise AssertionError(f"{emitted} approximate pairs emitted under a budget of {budget}")
    p = check_unit_interval(df_e, "match_probability", np.float32)
    if len(df_e) != pairs.n_pairs:
        raise AssertionError("the scored frame is not the pair set")
    for col in SETTINGS["comparison_columns"]:
        g = df_e[f"gamma_{col['col_name']}"].to_numpy()
        if g.min() < -1 or g.max() >= col["num_levels"]:
            raise AssertionError(f"approximate path gamma_{col['col_name']} outside its levels")
    uid_l, uid_r = df_e["unique_id_l"].to_numpy(), df_e["unique_id_r"].to_numpy()
    twin = (uid_r - uid_l == APPROX_BASE) & (uid_l < APPROX_BASE)
    fields["main_path"] = {
        "rows": len(df), "exact_pairs": int(n_exact), "approx_pairs": int(emitted),
        "budget": budget, "wall_s": e2e_s, "stage_s": linker.stage_seconds,
        "em_updates": int(linker._last_em_result.n_updates),
        "launches": launches, "variant_launches": variants,
        "native_calls": dict(native.calls), "peak_device_mem_gb": peak_gb,
        "planted_median_p": float(np.median(p[twin])) if twin.any() else None,
        "other_p99": float(np.quantile(p[~twin], 0.99)),
        "tier_seconds": run["seconds"],
        **{k: run[k] for k in ("candidates", "exact_overlap_removed", "survivors",
                               "emitted", "oversize_buckets_dropped", "budget_fill")},
    }
    table = linker._table

    # -- the stages alone: the DF table, the plan, one verification chunk,
    # -- and every survivor unbudgeted (recall, and the budget's prefix) ---
    columns = lsh.column_arrays(table, ("first_name", "surname"))
    t0 = time.perf_counter()
    minhash.gram_df_table(columns, settings.get("approx_q") or 2, device="cuda")
    torch.cuda.synchronize()
    df_table_s = time.perf_counter() - t0
    plan = lsh.build_approx_plan(linker.settings, table)
    unb = dict(linker.settings, approx_pair_budget=1 << 40)
    t0 = time.perf_counter()
    ui, uj, uc, us, ustats = lsh.generate_approx_candidates(unb, table, plan=plan)
    unbudgeted_s = time.perf_counter() - t0
    order = lsh.rank_order(*(torch.from_numpy(a).cuda() for a in (ui, uj, uc, us)))
    top = order[:budget].cpu().numpy()
    if not (np.array_equal(pairs.idx_l[n_exact:], ui[top])
            and np.array_equal(pairs.idx_r[n_exact:], uj[top])):
        raise AssertionError("the emitted approximate pairs are not the best-first top of "
                             "every survivor")
    if ustats["survivors"] != run["survivors"] or ustats["candidates"] != run["candidates"]:
        raise AssertionError(f"unbudgeted run counts {ustats} differ from the budgeted run's")
    _, ci, cj = next(iter_device_pairs(plan.device_plan, lsh.VERIFY_CHUNK_CUDA))
    it = torch.from_numpy(ci.astype(np.int64)).cuda()
    jt = torch.from_numpy(cj.astype(np.int64)).cuda()
    aux = [(minhash._upload_chars(b, "cuda"), minhash._upload(ln, "cuda"),
            minhash._upload(m.view(np.int32), "cuda"), minhash._upload(c, "cuda"))
           for b, ln, m, c in lsh._verify_aux(table, plan.config)]
    bc = minhash._upload(plan.band_codes, "cuda")
    verify_ms = cuda_ms(torch, lambda: lsh.verify_pairs(it, jt, bc, aux, plan.config.q, True))
    fields["stages"] = {
        "df_table_s": df_table_s, "plan_s": plan.seconds,
        "unbudgeted_candidates_s": unbudgeted_s, "unbudgeted_seconds": ustats["seconds"],
        "verify_chunk_pairs": int(it.shape[0]), "verify_chunk_device_ms": verify_ms,
        "verify_calls": ustats["seconds"]["verify_calls"],
    }
    head = (pairs.idx_l[:n_exact], pairs.idx_r[:n_exact])
    fields["recall"] = {
        "at_budget": twin_recall(ui[top], uj[top], APPROX_BASE),
        "unbudgeted": twin_recall(ui, uj, APPROX_BASE),
        "exact_tier": twin_recall(*head, APPROX_BASE),
    }
    if fields["recall"]["at_budget"] < APPROX_RECALL_MIN:
        raise AssertionError(f"recall at the budget {fields['recall']}")
    del ui, uj, uc, us, order, it, jt, aux, bc, plan, linker, df_e

    # -- parity: the 5,000-base corpus on the card and on the CPU ----------
    small = make_typo_corpus(APPROX_PARITY_BASE, SEED + 8)
    parity = {}
    for name, over in (("unweighted", {}), ("weighted", {"approx_tf_weighting": True})):
        s = approx_settings(APPROX_PARITY_BASE, **over)
        parted = []
        if over:
            table = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=small,
                                            device="cpu")._ensure_encoded()
            parted = weighted_parted_lanes(torch, minhash, lsh, s, table)
        if parted:
            parity[name] = {"parted_lanes": parted, "frames_compared": False}
            continue
        gpu, _, cpu, dp, pvariants = cuda_vs_cpu(splink_tpu_torch, strings_cuda, s, small)
        parity[name] = {"pairs": gpu._pairs.n_pairs, "max_abs_dp": dp,
                        "approx_emitted": lsh.last_run["emitted"], "parted_lanes": [],
                        "variant_launches": pvariants, "frames_compared": True}
    fields["parity"] = parity

    # -- serving: an index over the base rows answers the garbled twins ----
    base = small.iloc[:APPROX_PARITY_BASE].reset_index(drop=True)
    twins = small.iloc[APPROX_PARITY_BASE:].reset_index(drop=True)
    s = approx_settings(APPROX_PARITY_BASE)
    trainer = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=base)
    trainer.estimate_parameters()
    model = os.path.join(out_dir, "approx_model.json")
    trainer.save_model_as_json(model, overwrite=True)
    ref = splink_tpu_torch.load_from_json(model, df=base)
    t0 = time.perf_counter()
    index = ref.export_index()
    export_s = time.perf_counter() - t0
    policy = BucketPolicy(*APPROX_SERVE_POLICY)
    engine = QueryEngine(index, top_k=APPROX_TOP_K, policy=policy)
    warm = engine.warmup()
    builds = compile_requests()
    approx_out = []
    t0 = time.perf_counter()
    served = engine.query_arrays(twins, approx_out=approx_out)
    serve_s = time.perf_counter() - t0
    top_p, top_rows, top_valid, n_cand = served
    tagged = approx_out[0]
    if not tagged.all():
        raise AssertionError(f"{int((~tagged).sum())} garbled queries were not served "
                             "through the fallback")
    found = (index.unique_id[top_rows] == np.arange(APPROX_PARITY_BASE)[:, None]) & top_valid
    serve_recall = float(found.any(axis=1).mean())
    if serve_recall < APPROX_RECALL_MIN:
        raise AssertionError(f"the fallback found {serve_recall} of the twins' sources")
    res = engine.query(twins.head(64))
    if not res["approx"].all() or engine.query(base.head(64))["approx"].any():
        raise AssertionError("the query frame's approx column is wrong")
    combined = splink_tpu_torch.load_from_json(model, df=small)
    combined.settings["approx_pair_budget"] = 1 << 40
    off = combined.manually_apply_fellegi_sunter_weights()
    offline = dict(zip(zip(off["unique_id_l"].to_numpy().tolist(),
                           off["unique_id_r"].to_numpy().tolist()),
                       off["match_probability"].to_numpy()))
    checked = 0
    for q in range(APPROX_PARITY_BASE):
        for r in np.flatnonzero(top_valid[q]):
            key = (int(index.unique_id[top_rows[q, r]]), q + APPROX_PARITY_BASE)
            if key in offline:
                if offline[key] != top_p[q, r]:
                    raise AssertionError(f"served {top_p[q, r]!r} for {key}, offline "
                                         f"{offline[key]!r}")
                checked += 1
    if checked < 0.9 * APPROX_PARITY_BASE:
        raise AssertionError(f"only {checked} served pairs were offline pairs")
    idx_dir = os.path.join(out_dir, "approx_index")
    shutil.rmtree(idx_dir, ignore_errors=True)
    index.save(idx_dir)
    again = QueryEngine(load_index(idx_dir), top_k=APPROX_TOP_K, policy=policy)
    again.warmup()
    if again.index.content_fingerprint() != index.content_fingerprint():
        raise AssertionError("the loaded approximate index's fingerprint differs")
    reloaded = again.query_arrays(twins)
    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(served, reloaded)):
        raise AssertionError("the saved-and-loaded index answers differently")
    builds_after = compile_requests() - builds
    if builds_after:
        raise AssertionError(f"{builds_after} kernel-library builds after warmup")
    shutil.rmtree(idx_dir, ignore_errors=True)
    fields["serve"] = {
        "reference_rows": index.n_rows, "queries": len(twins), "bands": index.approx.bands,
        "export_s": export_s, "warmup": warm, "wall_s": serve_s,
        "queries_per_s": len(twins) / serve_s, "approx_tagged": int(tagged.sum()),
        "source_in_top_k": serve_recall, "median_candidates": float(np.median(n_cand)),
        "served_equals_offline_pairs": checked, "reload_bit_identical": True,
        "builds_after_warmup": builds_after,
    }
    return fields, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import pandas

    import splink_tpu_torch
    from splink_tpu_torch import (
        blocking,
        blocking_device,
        case_compiler,
        data,
        gammas,
        native,
        pairgen,
        resilience,
    )
    from splink_tpu_torch import term_frequencies as tf
    from splink_tpu_torch.ops import qgram, strings, strings_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         pandas=pandas.__version__,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         host_mem_available_gb=os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 1e9,
         host_cpus=os.cpu_count())

    t0 = time.perf_counter()
    libs = strings_cuda.build()
    build_s = time.perf_counter() - t0
    usage = res_usage(strings_cuda.cuda_tool, libs)
    emit("build", seconds=build_s,
         libraries={k: os.path.relpath(v) for k, v in libs.items()},
         flags=strings_cuda.NVCC_FLAGS, res_usage=usage)
    for name, variants in strings_cuda.VARIANT_WORDS.items():
        for w in (*variants, 0):
            for kind in ("u8", "u32"):
                if f"{name}/{kind}/w{w}" not in usage:
                    raise AssertionError(f"cuobjdump reports no {name}/{kind}/w{w}: {usage}")
    zero_frames = [f"levenshtein/u8/w{w}" for w in strings_cuda.VARIANT_WORDS["levenshtein"]]
    zero_frames += [f"jaro_winkler/{k}/w{w}" for w in (1, 2) for k in ("u8", "u32")]
    for variant in zero_frames:
        frame = usage[variant]["stack_bytes"]
        if frame != 0:
            raise AssertionError(f"{variant}: stack frame {frame} bytes, expected 0")
    host_lib = native.library_path()
    built_before = os.path.exists(host_lib)
    t0 = time.perf_counter()
    native.build()
    emit("native_build", seconds=time.perf_counter() - t0, built_before=built_before,
         command=native.build_command(os.path.relpath(host_lib)), flags=native.CXX_FLAGS)

    # -- kernels vs plain versions on random pairs and the edge cases ----
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checked = []
    t0 = time.perf_counter()
    for width in CHECK_WIDTHS:
        n = KERNEL_CHECK_PAIRS if width <= 32 else WIDE_CHECK_PAIRS
        for wide in (False, True):
            check_kernels(torch, strings, strings_cuda, random_pairs(torch, n, width, wide, gen),
                          gen)
            dtype = torch.int32 if wide else torch.uint8
            checked.append(f"{n}x{width}-" + ",".join(
                "{}-{}-w{}".format(k, *strings_cuda.kernel_variant(k, width, dtype))
                for k in KERNELS))
    check_kernels(torch, strings, strings_cuda, edge_pairs(torch), gen)
    checked.append("edge_cases")
    # a uniform large batch beside the main path's own shapes (below)
    big = random_pairs(torch, KERNEL_CHECK_PAIRS, 24, False, gen)
    for density in MASK_DENSITIES:
        mask = torch.rand(KERNEL_CHECK_PAIRS, generator=gen, device="cuda") < density
        check_masked(torch, strings_cuda.jaro_winkler_cuda(*big, mask=mask),
                     strings.jaro_winkler_plain(*big, mask=mask),
                     f"2M x 24 at density {density}")
        checked.append(f"jaro_winkler-masked-2000000x24-density{density}-kept{int(mask.sum())}")
    check_s = time.perf_counter() - t0
    at_2m = {
        name: measure(torch, name, getattr(strings, plain), getattr(strings_cuda, wrap), big, ops)
        for name, (_, plain, wrap, ops) in KERNELS.items()
    }
    del big
    emit("kernels", checked=checked, seconds=check_s, jaro_winkler="torch.equal",
         levenshtein="exact",
         at_2M_pairs_w24={k: {f: v[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms")}
                          for k, v in at_2m.items()})

    # -- the main path at full size ----------------------------------------
    t0 = time.perf_counter()
    df, dup_of = make_people(N_ROWS, SEED)
    gen_s = time.perf_counter() - t0
    zero_counts(strings_cuda, native, tf)
    strings_cuda.capture = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    linker = splink_tpu_torch.Splink(json.loads(json.dumps(SETTINGS)), df=df)
    df_e = linker.get_scored_comparisons()
    wall = time.perf_counter() - t0
    launches = dict(strings_cuda.launches)
    main_variants = dict(strings_cuda.variant_launches)
    native_calls = dict(native.calls)
    captured, strings_cuda.capture = strings_cuda.capture, None
    check_path_counts("the main path", strings_cuda, native)
    p = df_e["match_probability"].to_numpy()
    n_pairs = linker._pairs.n_pairs
    # one masked w1 launch per Jaro-Winkler column and batch, nothing else
    jw_cols = [c for c in SETTINGS["comparison_columns"]
               if c["comparison"]["kind"] == "jaro_winkler"]
    want_jw = len(jw_cols) * -(-n_pairs // int(linker.settings["pair_batch_size"]))
    jw_variants = {k: v for k, v in main_variants.items() if k.startswith("jaro_winkler/")}
    if jw_variants != {"jaro_winkler/u8/w1/masked": want_jw}:
        raise AssertionError(f"main path Jaro-Winkler launches {jw_variants}, expected "
                             f"{want_jw} masked w1 launches")
    if len(df_e) != n_pairs or p.dtype != np.float32 or not np.isfinite(p).all():
        raise AssertionError("scored frame has the wrong length, dtype or non-finite values")
    if (p < 0).any() or (p > 1).any():
        raise AssertionError("match_probability outside [0, 1]")
    for c, col in enumerate(SETTINGS["comparison_columns"]):
        g = df_e[f"gamma_{col['col_name']}"].to_numpy()
        if g.min() < -1 or g.max() >= col["num_levels"]:
            raise AssertionError(f"gamma_{col['col_name']} outside its levels")
    planted = dup_of[df_e["unique_id_r"].to_numpy()] == df_e["unique_id_l"].to_numpy()
    med_dup = float(np.median(p[planted]))
    p99_other = float(np.quantile(p[~planted], 0.99))
    if not (med_dup > 0.9 and med_dup > p99_other):
        raise AssertionError(
            f"planted duplicates median {med_dup} vs non-duplicate p99 {p99_other}"
        )
    result = linker._last_em_result
    emit("main_path", rows=N_ROWS, pairs=n_pairs, data_gen_s=gen_s, wall_s=wall,
         stage_s=linker.stage_seconds, blocking_tier="device",
         blocking_device=dict(blocking_device.last_run), em_updates=int(result.n_updates),
         em_converged=bool(result.converged), launches=launches,
         variant_launches=main_variants, native_calls=native_calls,
         planted_pairs=int(planted.sum()), planted_median_p=med_dup,
         other_p99=p99_other, lambda_=float(linker.params.params["λ"]),
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    main_dtypes = [(c, str(t)) for c, t in df_e.dtypes.items()]
    del df_e

    # -- the native host library against its plain versions at the main
    # -- path's shapes --------------------------------------------------------
    emit("native", **native_phase(native, blocking, df, linker._table))

    # -- the device sort-join tier against the host join at the main path's
    # -- size ------------------------------------------------------------------
    zero_counts(strings_cuda, native, tf)
    out_dir = os.path.join(strings_cuda.build_dir(), "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    emit("blocking_device", **blocking_device_phase(torch, blocking, blocking_device,
                                                    linker.settings, linker._table, out_dir))

    # -- the term-frequency path at full size: the fold in scoring, then the
    # -- ex-post aggregation on the card ---------------------------------------
    zero_counts(strings_cuda, native, tf)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tf_linker = splink_tpu_torch.Splink(json.loads(json.dumps(TF_SETTINGS)), df=df)
    tf_e = tf_linker.get_scored_comparisons()
    tf_adj = tf_linker.make_term_frequency_adjustments(tf_e)
    tf_wall = time.perf_counter() - t0
    t0 = time.perf_counter()  # the part of tf_adjust that checks the frame's alignment
    if not tf_linker._df_e_aligned_with_pairs(tf_e):
        raise AssertionError("the scored frame is not aligned with its pairs")
    aligned_check_s = time.perf_counter() - t0
    tf_launches = dict(strings_cuda.launches)
    tf_variants = dict(strings_cuda.variant_launches)
    tf_native_calls = dict(native.calls)
    aggregations = dict(tf.device_aggregations)
    check_path_counts("the term-frequency path", strings_cuda, native)
    if aggregations != {"cuda": len(TF_COLUMNS)}:
        raise AssertionError(f"device aggregations {aggregations}, expected "
                             f"{len(TF_COLUMNS)} on cuda")
    tf_jw = {k: v for k, v in tf_variants.items() if k.startswith("jaro_winkler/")}
    if tf_jw != {"jaro_winkler/u8/w1/masked": want_jw}:
        raise AssertionError(f"term-frequency path Jaro-Winkler launches {tf_jw}")
    if tf_linker._pairs.n_pairs != n_pairs or len(tf_adj) != n_pairs:
        raise AssertionError("the term-frequency path scored another pair set")
    cols = list(tf_adj.columns)
    if cols[:3] != ["tf_adjusted_match_prob", "match_probability", "tf_match_probability"]:
        raise AssertionError(f"term-frequency frame columns {cols[:3]}")
    tf_p = check_unit_interval(tf_adj, "tf_match_probability", np.float32)
    check_unit_interval(tf_adj, "tf_adjusted_match_prob", np.float64)
    table = tf_linker._table
    il, ir = tf_linker._pairs.idx_l, tf_linker._pairs.idx_r
    disagree_counts = {}
    for col in TF_COLUMNS:
        adj = check_unit_interval(tf_adj, f"{col}_adj", np.float64)
        tid = table.strings[col].token_ids
        tl, tr = tid[il], tid[ir]
        disagree = (tl != tr) | (tl < 0)
        if not (adj[disagree] == 0.5).all():
            raise AssertionError(f"{col}_adj is not exactly 0.5 on every disagreeing pair")
        disagree_counts[col] = int(disagree.sum())
    planted_tf = dup_of[tf_adj["unique_id_r"].to_numpy()] == tf_adj["unique_id_l"].to_numpy()
    emit("term_frequencies", rows=N_ROWS, pairs=n_pairs, columns=TF_COLUMNS, wall_s=tf_wall,
         stage_s=tf_linker.stage_seconds, launches=tf_launches, variant_launches=tf_variants,
         native_calls=tf_native_calls, device_aggregations=aggregations,
         disagreeing_pairs=disagree_counts, alignment_check_s=aligned_check_s,
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         planted_median_tf_p=float(np.median(tf_p[planted_tf])),
         planted_median_tf_adjusted=float(np.median(
             tf_adj["tf_adjusted_match_prob"].to_numpy()[planted_tf])),
         other_p99_tf_p=float(np.quantile(tf_p[~planted_tf], 0.99)))

    # the device aggregation on the card against the CPU, on the main path's
    # surname token ids and probabilities
    tid = table.strings["surname"].token_ids
    agg_in = (tid[il], tid[ir], tf_adj["match_probability"].to_numpy(),
              float(tf_linker.params.params["λ"]), table.strings["surname"].n_tokens)
    agg = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        agg[dev] = tf.compute_token_adjustment_device(*agg_in, device=dev)
        agg[f"{dev}_s"] = time.perf_counter() - t0
    (g_adj, g_lam, g_cnt), (c_adj, c_lam, c_cnt) = agg["cuda"], agg["cpu"]
    if not np.array_equal(g_cnt, c_cnt):
        raise AssertionError("device aggregation counts differ between cuda and cpu")
    rel = {}
    for name, g, c in (("lambda", g_lam, c_lam), ("adj", g_adj, c_adj)):
        rel[name] = float(np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-300)))
        if rel[name] > TF_RTOL:
            raise AssertionError(f"device aggregation {name} cuda vs cpu differs by "
                                 f"{rel[name]} relative")
    agg_times = {k: agg[k] for k in ("cuda_s", "cpu_s")}
    del tf_e, tf_adj, agg, agg_in
    # -- the masked kernel on the main path's first batch; each kernel at
    # -- the main path's shapes: equality, times, bound ---------------------
    jw_batch = captured["jaro_winkler"]  # first_name, first batch, survivor mask
    surv = jw_batch[4]
    check_masked(torch, strings_cuda.jaro_winkler_cuda(*jw_batch[:4], mask=surv),
                 strings.jaro_winkler_plain(*jw_batch[:4], mask=surv),
                 f"main path batch {tuple(jw_batch[0].shape)}, {int(surv.sum())} survivors")
    jw_survivors = tuple(a[surv].contiguous() for a in jw_batch[:4])

    def row(name, kernel, args, forms, launched, fn=None, **extra):
        replaces, plain, wrap, ops = KERNELS[kernel]
        return {
            "name": name, "route": "cuda",
            "source": f"splink_tpu_torch/csrc/{kernel}.cu", "replaces": replaces,
            "launches": launched,
            **measure(torch, name, getattr(strings, plain),
                      fn or getattr(strings_cuda, wrap), args, ops),
            "library_ms": None,
            "res_usage": {k: usage[k] for k in forms},
            **extra,
        }

    jw_w1 = ["jaro_winkler/u8/w1"]
    rows = [
        row("jaro_winkler", "jaro_winkler", jw_batch, jw_w1, launches["jaro_winkler"],
            form="w1, masked: the main path's first batch and its survivor mask",
            variant_launches=jw_variants, tf_path_launches=tf_launches["jaro_winkler"]),
        row("jaro_winkler/dense_survivors", "jaro_winkler", jw_survivors, jw_w1,
            launches["jaro_winkler"],
            form="w1, dense: the same batch's survivors compacted first (the CPU's form)"),
        {"name": "jaro_winkler/dense_2M_w24", "route": "cuda",
         "source": "splink_tpu_torch/csrc/jaro_winkler.cu",
         "replaces": KERNELS["jaro_winkler"][0], "launches": launches["jaro_winkler"],
         **at_2m["jaro_winkler"], "library_ms": None, "res_usage": {k: usage[k] for k in jw_w1},
         "form": "w1, dense: 2M uniform pairs of width 24"},
        row("levenshtein", "levenshtein", captured["levenshtein"], ["levenshtein/u8/w1"],
            launches["levenshtein"], at_2M_pairs_w24=at_2m["levenshtein"],
            form="w1: the main path's first batch",
            tf_path_launches=tf_launches["levenshtein"]),
    ]
    s1, _, l1, l2 = captured["levenshtein"]
    emit("kernel_timing", kernels=[r["name"] for r in rows],
         jaro_winkler_int_ops={
             "this_kernel": jw_ops(torch, jw_batch[0], *jw_batch[2:4], mask=surv),
             "window_scan_count": jw_ops_window_scan(torch, jw_batch[0], *jw_batch[2:4],
                                                     mask=surv)},
         levenshtein_int_ops={"this_kernel": lev_ops(torch, s1, l1, l2),
                              "one_word_count": lev_ops_one_word(torch, s1, l1, l2)})

    # -- the whole two-phase step of one column on the first batch, masked
    # -- (the card's form) and compacted first (the CPU's form) -------------
    column = jw_cols[0]["col_name"]
    thresholds = tuple(jw_cols[0]["comparison"]["thresholds"])
    pc, aux = first_batch(torch, gammas, linker, column)
    step = {}
    masked_form = gammas._survivor_levels
    for form in ("masked", "compacted", "compacted", "masked"):
        gammas._survivor_levels = getattr(gammas, f"_survivor_levels_{form}")
        ms, lvl = two_phase_step_ms(torch, gammas, pc, aux, thresholds)
        step.setdefault(form, []).append(ms)
        step[f"{form}_levels"] = lvl
    gammas._survivor_levels = masked_form
    if not torch.equal(step.pop("masked_levels"), step.pop("compacted_levels")):
        raise AssertionError("two-phase levels differ between the masked and compacted forms")
    from splink_tpu_torch.ops import jw_bound

    emit("two_phase_step", column=column, pairs=int(pc.len_l.shape[0]),
         survivors=int(surv.sum()), host_ms_to_synchronize=step,
         bound_only_host_ms=bound_ms(torch, jw_bound, pc, aux))
    del pc, aux, jw_survivors

    # -- parity: a 20,000-row subset on the card and on the CPU -------------
    sub = df[df["blk"] < SUBSET_ROWS // 32].reset_index(drop=True)
    gpu, gdf, cpu, dp, _ = cuda_vs_cpu(splink_tpu_torch, strings_cuda, SETTINGS, sub)
    emit("parity", rows=len(sub), pairs=gpu._pairs.n_pairs, max_abs_dp=dp["match_probability"],
         em_updates={"cuda": gpu._last_em_result.n_updates,
                     "cpu": cpu._last_em_result.n_updates})
    tgpu, _, _, tdp, _ = cuda_vs_cpu(splink_tpu_torch, strings_cuda, TF_SETTINGS, sub)
    emit("term_frequencies_parity", rows=len(sub), pairs=tgpu._pairs.n_pairs, max_abs_diff=tdp,
         aggregation_main_path={"column": "surname", "pairs": n_pairs,
                                "segments": int(g_cnt.size), "counts_equal": True,
                                "max_rel_diff": rel, "cuda_s": agg_times["cuda_s"],
                                "cpu_s": agg_times["cpu_s"]})

    # -- wide: columns of max_string_length 64 and 96, on the card and the CPU
    wdf = make_addresses(SUBSET_ROWS, SEED + 1)
    wg, wgdf, _, wdp, wide_variants = cuda_vs_cpu(splink_tpu_torch, strings_cuda,
                                                  WIDE_SETTINGS, wdf)
    wdp = wdp["match_probability"]
    multi_word = {k: v for k, v in wide_variants.items()
                  if v > 0 and re.search(r"/w(\d+)", k).group(1) != "1"}
    for name in KERNELS:
        if not any(k.startswith(name + "/") for k in multi_word):
            raise AssertionError(f"the wide run launched no multi-word {name} kernel: "
                                 f"{wide_variants}")
    wide_cols = ("address", "notes", "employer")
    for form in ("jaro_winkler/u8/w2/masked", "jaro_winkler/u8/w0/masked"):
        if not wide_variants.get(form):
            raise AssertionError(f"the wide run launched no {form}: {wide_variants}")
    emit("wide", rows=len(wdf), pairs=wg._pairs.n_pairs,
         widths={c: wg._table.strings[c].width for c in wide_cols},
         variant_launches=wide_variants, max_abs_dp=wdp,
         gamma_levels={c: np.unique(wgdf[f"gamma_{c}"]).tolist() for c in wide_cols})
    # Jaro-Winkler's W = 2 form against the generic one (timed for the first
    # time) at the wide phase's width 64; their launches are the wide run's
    # (their path: columns of width 33-64 and wider ones)
    w64 = random_pairs(torch, WIDE_CHECK_PAIRS, 64, False, gen)

    def generic(s1, s2, l1, l2, mask=None):
        out = torch.empty(s1.shape[0], dtype=torch.float32, device=s1.device)
        return strings_cuda._launch("jaro_winkler", out, s1, s2, l1, l2, 0.1, 0.7,
                                    mask=mask, words=0)

    launched = lambda w: sum(v for k, v in wide_variants.items()  # noqa: E731
                             if k.startswith(f"jaro_winkler/u8/w{w}"))
    two_words = row("jaro_winkler/w2_w64", "jaro_winkler", w64, ["jaro_winkler/u8/w2"],
                    launched(2), form="w2, dense: uniform pairs of width 64",
                    launches_from="wide phase")
    generic_row = row("jaro_winkler/generic_w64", "jaro_winkler", w64, ["jaro_winkler/u8/w0"],
                      launched(0), fn=generic,
                      form="w0 (generic), dense: the same pairs of width 64",
                      launches_from="wide phase")
    if not two_words["ms"] < generic_row["ms"]:
        raise AssertionError(f"the W = 2 form ({two_words['ms']} ms) is not faster than the "
                             f"generic one ({generic_row['ms']} ms) at width 64")
    rows[3:3] = [two_words, generic_row]
    del w64

    # -- model JSON round trip on the card ------------------------------------
    path = os.path.join(out_dir, "model.json")
    gpu.save_model_as_json(path, overwrite=True)
    again = splink_tpu_torch.load_from_json(path, df=sub)
    rdf = again.manually_apply_fellegi_sunter_weights()
    if not np.array_equal(rdf["match_probability"].to_numpy(), gdf["match_probability"].to_numpy()):
        raise AssertionError("reloaded model scores differ from the trained linker's")
    emit("roundtrip", pairs=len(rdf), bit_identical=True)
    del gpu, gdf, again, rdf

    # -- the kinds path at full size: every comparison kind ported last ----
    zero_counts(strings_cuda, native, tf)
    strings_cuda.capture = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    klinker = splink_tpu_torch.Splink(json.loads(json.dumps(KINDS_SETTINGS)), df=df)
    kdf = klinker.get_scored_comparisons()
    kinds_wall = time.perf_counter() - t0
    kinds_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kinds_launches = dict(strings_cuda.launches)
    kinds_variants = dict(strings_cuda.variant_launches)
    kinds_captured, strings_cuda.capture = strings_cuda.capture, None
    check_path_counts("the kinds path", strings_cuda, native)
    kinds = [c["comparison"]["kind"] for c in klinker.settings["comparison_columns"]]
    if kinds != ["dmetaphone", "qgram_jaccard", "qgram_cosine", "numeric_abs", "case_sql"]:
        raise AssertionError(f"kinds path comparison kinds {kinds}")
    k_pairs = klinker._pairs.n_pairs
    if k_pairs != n_pairs or len(kdf) != n_pairs:
        raise AssertionError(f"the kinds path scored {k_pairs} pairs, the main path {n_pairs}")
    # the CASE column launches each dense kernel once a batch, nothing else
    n_batches = -(-n_pairs // int(klinker.settings["pair_batch_size"]))
    want_variants = {"jaro_winkler/u8/w1": n_batches, "levenshtein/u8/w1": n_batches}
    if kinds_variants != want_variants:
        raise AssertionError(f"kinds path launches {kinds_variants}, expected {want_variants}")
    kp = kdf["match_probability"].to_numpy()
    if kp.dtype != np.float32 or not np.isfinite(kp).all() or (kp < 0).any() or (kp > 1).any():
        raise AssertionError("kinds path match_probability not finite float32 in [0, 1]")
    kinds_levels = {}
    for col in KINDS_SETTINGS["comparison_columns"]:
        g = kdf[f"gamma_{col['col_name']}"].to_numpy()
        levels = np.unique(g).tolist()
        if g.min() < -1 or g.max() >= col["num_levels"] or len(levels) < col["num_levels"]:
            raise AssertionError(f"kinds path gamma_{col['col_name']} levels {levels}")
        kinds_levels[col["col_name"]] = levels
    k_planted = dup_of[kdf["unique_id_r"].to_numpy()] == kdf["unique_id_l"].to_numpy()
    k_med = float(np.median(kp[k_planted]))
    k_p99 = float(np.quantile(kp[~k_planted], 0.99))
    if not k_med > k_p99:
        raise AssertionError(f"kinds path planted median {k_med} vs other p99 {k_p99}")
    emit("kinds", rows=N_ROWS, pairs=k_pairs, batches=n_batches, wall_s=kinds_wall,
         stage_s=klinker.stage_seconds, launches=kinds_launches,
         variant_launches=kinds_variants, native_calls=dict(native.calls),
         peak_device_mem_gb=kinds_peak_gb, gamma_levels=kinds_levels,
         em_updates=int(klinker._last_em_result.n_updates),
         planted_median_p=k_med, other_p99=k_p99,
         host_s=kinds_host_seconds(data, qgram, df, klinker._table),
         batch_device_times=kinds_batch_timing(torch, gammas, qgram, case_compiler, klinker))
    del kdf
    # the dense launches' inputs of the CASE column's first batch: kernel
    # against plain version; the kernel table's kinds rows
    jw_dense, lev_substr = kinds_captured["jaro_winkler"], kinds_captured["levenshtein"]
    rows += [
        row("jaro_winkler/kinds_case_dense", "jaro_winkler", jw_dense, jw_w1,
            kinds_launches["jaro_winkler"], path="kinds",
            form="w1, dense: jaro_winkler_sim(city_l, city_r), the kinds path's first batch"),
        row("levenshtein/kinds_case_substr", "levenshtein", lev_substr, ["levenshtein/u8/w1"],
            kinds_launches["levenshtein"], path="kinds",
            form="w1: levenshtein(substr(city_l,1,4), substr(city_r,1,4)), first batch"),
    ]
    del jw_dense, lev_substr, kinds_captured

    # -- kinds parity: the subset on the card and on the CPU, and the model's
    # -- JSON round trip on the card ------------------------------------------
    kgpu, kgdf, kcpu, kdp, kparity_variants = cuda_vs_cpu(
        splink_tpu_torch, strings_cuda, KINDS_SETTINGS, sub)
    for k in KERNELS:
        if not any(v > 0 for name, v in kparity_variants.items() if name.startswith(k + "/")):
            raise AssertionError(f"the kinds parity run launched no {k} kernel")
    kpath = os.path.join(out_dir, "kinds_model.json")
    kgpu.save_model_as_json(kpath, overwrite=True)
    kagain = splink_tpu_torch.load_from_json(kpath, df=sub)
    krdf = kagain.manually_apply_fellegi_sunter_weights()
    if not np.array_equal(krdf["match_probability"].to_numpy(),
                          kgdf["match_probability"].to_numpy()):
        raise AssertionError("kinds path: reloaded model scores differ from the trained linker's")
    emit("kinds_parity", rows=len(sub), pairs=kgpu._pairs.n_pairs, gamma_equal=True,
         max_abs_dp=kdp["match_probability"], variant_launches=kparity_variants,
         em_updates={"cuda": kgpu._last_em_result.n_updates,
                     "cpu": kcpu._last_em_result.n_updates},
         roundtrip_bit_identical=True)

    # -- online serving at the main path's size: the trained linker frozen
    # -- into an index, batches, the service, the TF engine, the gates --------
    t0 = time.perf_counter()
    serve, serve_captured, serve_ctx = serve_phase(torch, strings_cuda, native, tf, linker,
                                                   tf_linker, df, out_dir)
    serve_launches = serve["batch_path"]["launches"]
    for (q_n, cap), args in serve_captured.items():
        for kernel in KERNELS:
            rows.append(row(
                f"{kernel}/serve_{q_n}x{cap}", kernel, args[kernel], [f"{kernel}/u8/w1"],
                serve_launches[kernel], path="serve",
                launches_per_batch=serve["batch_path"]["launches_per_batch"][kernel],
                form=f"w1, dense: serve batch of {q_n} queries x {cap} candidate slots "
                     f"({'first_name' if kernel == 'jaro_winkler' else 'city'})"))
    del serve_captured
    emit("serve", phase_s=time.perf_counter() - t0, **serve)

    # -- the serving fleet over the serve phase's index: cold starts from the
    # -- AOT sidecar, the wire, two replicas behind a router, federation ------
    t0 = time.perf_counter()
    fleet, fleet_launches = fleet_phase(torch, strings_cuda, native, tf, serve_ctx["engine"],
                                        serve_ctx["idx_dir"], serve_ctx["qdf"],
                                        serve_ctx["answers"], out_dir)
    emit("fleet", phase_s=time.perf_counter() - t0, smi=smi, **fleet)
    for r in rows:
        if r["name"] in KERNELS:
            r["fleet_path_launches"] = fleet_launches[r["name"]]

    # -- observability: run telemetry at the main path's size, profile_dir,
    # -- the quality profile, the drift sketch and the drift monitor ----------
    t0 = time.perf_counter()
    obs, obs_launches = obs_phase(torch, splink_tpu_torch, strings_cuda, native, tf, df, linker,
                                  sub, serve_ctx["engine"], serve_ctx["engine"].index,
                                  serve_ctx["qdf"], serve_ctx["answers"], out_dir)
    del serve_ctx
    emit("obs", phase_s=time.perf_counter() - t0, smi=smi, **obs)
    for r in rows:
        if r["name"] in KERNELS:
            r["obs_path_launches"] = obs_launches[r["name"]]

    # -- the measured analysis layers on the card: trace, num and perf
    # -- audits over every registered kernel, against the committed cuda tier
    zero_counts(strings_cuda, native, tf)
    t0 = time.perf_counter()
    analysis = analysis_phase(torch, strings_cuda)
    analysis_launches = dict(strings_cuda.launches)
    if not all(analysis_launches[k] for k in KERNELS):
        raise AssertionError(f"analysis path launched {analysis_launches}")
    emit("analysis", phase_s=time.perf_counter() - t0, smi=smi,
         path_launches=analysis_launches, **analysis)
    for r in rows:
        if r["name"] in KERNELS:
            r["analysis_path_launches"] = analysis_launches[r["name"]]

    # -- the approximate tier at bench.py's size: minhash-LSH blocking into
    # -- the main path's columns, parity with the CPU, the serving fallback
    t0 = time.perf_counter()
    approx, approx_launches = approx_phase(torch, splink_tpu_torch, strings_cuda, native, tf,
                                           out_dir)
    emit("approx", phase_s=time.perf_counter() - t0, **approx)
    for r in rows:
        if r["name"] in KERNELS:
            r["approx_path_launches"] = approx_launches[r["name"]]

    # -- jobs past max_resident_pairs at full size: device pair generation,
    # -- the overlap PatternStream, the score stream ----------------------------
    t0 = time.perf_counter()
    big, big_dup = make_people(LARGE_ROWS, SEED, groups=LARGE_GROUPS)
    big_gen_s = time.perf_counter() - t0
    large, large_counts, large_params = large_phase(
        torch, splink_tpu_torch, strings_cuda, native, gammas, pairgen,
        lambda: zero_counts(strings_cuda, native, tf), big, big_dup, main_dtypes)
    emit("large", data_gen_s=big_gen_s, **large)

    # -- the durable pair store: the large job written and trained from it,
    # -- kill and resume, the spill-fed streamed EM ---------------------------
    emit("spill", **spill_phase(torch, splink_tpu_torch, big, large_counts, large_params,
                                df, out_dir))
    del big, big_dup
    for r in rows:
        if r["name"] in KERNELS:
            r["large_path_launches"] = large["large_path_launches"][r["name"]]

    # -- every regime on the card at the subset's size -----------------------
    emit("regimes_parity", **regimes_parity(splink_tpu_torch, resilience, sub, out_dir))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spill-child"]:
        sys.exit(spill_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--aot-child"]:
        sys.exit(aot_child(*sys.argv[2:7]))
    sys.exit(main())
