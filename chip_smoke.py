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
subset, and the device aggregation on the main path's own token ids. Every
phase prints one JSON line; any failed check raises. The last lines are the
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


def make_people(n: int, seed: int):
    """Seeded people table: names from pools of random 4-10 letter strings
    (5,000 first names, 20,000 surnames), ~10% planted duplicates carrying a
    one-character typo in a name or the city and sharing their source's
    block, ~2% nulls per column; ``blk`` uniform over n // 32 groups."""
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
    cols["blk"] = rng.integers(0, n // 32, n_base)
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
    for k in strings_cuda.launches:
        strings_cuda.launches[k] = 0
    strings_cuda.variant_launches.clear()
    for k in native.calls:
        native.calls[k] = 0
    tf.device_aggregations.clear()


def check_path_counts(what, strings_cuda, native):
    """Raise unless the path just driven launched every CUDA kernel and went
    through the native library for its encode and its blocking."""
    for k, v in strings_cuda.launches.items():
        if v <= 0:
            raise AssertionError(f"{what} launched no {k} kernel")
    for k in ("encode_fixed_width", "self_join_pairs"):
        if native.calls[k] <= 0:
            raise AssertionError(f"{what} did not call the native {k}")


def check_unit_interval(df, col, dtype):
    v = df[col].to_numpy()
    if v.dtype != dtype or not np.isfinite(v).all() or (v < 0).any() or (v > 1).any():
        raise AssertionError(f"{col}: {v.dtype}, finite {bool(np.isfinite(v).all())}, "
                             f"range [{np.nanmin(v)}, {np.nanmax(v)}], expected {dtype} in [0, 1]")
    return v


# ----------------------------------------------------------------------
# Main
# ----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import pandas

    import splink_tpu_torch
    from splink_tpu_torch import blocking, gammas, native
    from splink_tpu_torch import term_frequencies as tf
    from splink_tpu_torch.ops import strings, strings_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         pandas=pandas.__version__,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)

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
         stage_s=linker.stage_seconds, em_updates=int(result.n_updates),
         em_converged=bool(result.converged), launches=launches,
         variant_launches=main_variants, native_calls=native_calls,
         planted_pairs=int(planted.sum()), planted_median_p=med_dup,
         other_p99=p99_other, lambda_=float(linker.params.params["λ"]),
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del df_e

    # -- the native host library against its plain versions at the main
    # -- path's shapes --------------------------------------------------------
    emit("native", **native_phase(native, blocking, df, linker._table))

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
    out_dir = os.path.join(strings_cuda.build_dir(), "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.json")
    gpu.save_model_as_json(path, overwrite=True)
    again = splink_tpu_torch.load_from_json(path, df=sub)
    rdf = again.manually_apply_fellegi_sunter_weights()
    if not np.array_equal(rdf["match_probability"].to_numpy(), gdf["match_probability"].to_numpy()):
        raise AssertionError("reloaded model scores differ from the trained linker's")
    emit("roundtrip", pairs=len(rdf), bit_identical=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
