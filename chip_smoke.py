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
streamed EM to the streamed-G path bit for bit. Every phase prints one
JSON line; any failed check raises. The last lines are the
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
    sys.exit(main())
