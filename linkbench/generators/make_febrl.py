"""Seeded person records in the shape of FEBRL's data set generator: the
ten fields of its records, originals and duplicates, up to a set number
of duplicates an original under a Zipf distribution, and each duplicate
changed in up to a set number of its fields, at most once a field.

FEBRL draws each field from a frequency table of real Australian values;
those tables are not here, so each field's values come from a seeded pool
with a skewed frequency (the shapes are the configuration's ``records``
and ``assumed``). Fields are drawn independently of each other, as FEBRL
draws them.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("given_name", "surname", "street_number", "address_1", "address_2",
          "suburb", "postcode", "state", "date_of_birth", "soc_sec_id")

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
DIGITS = np.frombuffer(b"0123456789", np.uint8)
ONSETS = ("", "b", "br", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p",
          "r", "s", "sh", "st", "t", "th", "v", "w", "z")
VOWELS = ("a", "e", "i", "o", "u", "ie", "ea", "y")
CODAS = ("", "", "n", "r", "l", "s", "t", "ck", "nd", "rt", "x", "m")
STREET_TYPES = ("street", "road", "avenue", "place", "crescent", "close", "drive",
                "court", "parade", "circuit", "lane", "terrace")
SITES = ("village", "estate", "park", "gardens", "homestead", "towers", "flats")
STATES = ("nsw", "vic", "qld", "wa", "sa", "tas", "act", "nt")
# shares of Australia's population by state or territory (ABS, rounded)
STATE_SHARES = (0.32, 0.26, 0.20, 0.10, 0.07, 0.02, 0.02, 0.01)


def words(rng, k: int, syllables=(2, 3)) -> np.ndarray:
    """``k`` distinct seeded words of ``syllables`` onset-vowel-coda syllables."""
    syl = np.array([o + v + c for o in ONSETS for v in VOWELS for c in CODAS], dtype=object)
    out: dict[str, None] = {}
    while len(out) < k:
        n = rng.choice(syllables, k)
        picks = rng.integers(0, len(syl), (k, max(syllables)))
        for row, m in zip(picks, n):
            out.setdefault("".join(syl[row[:m]]), None)
            if len(out) == k:
                break
    return np.array(list(out), dtype=object)


def zipf_draw(rng, values: np.ndarray, s: float, n: int) -> np.ndarray:
    """``n`` draws from ``values`` with probability proportional to
    rank ** -s (the ranks in a seeded order)."""
    p = 1.0 / np.arange(1, len(values) + 1) ** s
    return values[rng.permutation(len(values))][rng.choice(len(values), n, p=p / p.sum())]


def sized_draw(rng, values: np.ndarray, sigma: float, n: int) -> np.ndarray:
    """``n`` values, each of ``values`` taking a share in proportion to the
    quantiles of a log-normal of ``sigma`` (the same set of shares for
    every seed, given to the values in a seeded order, so the group sizes
    and the pairs they give do not change with the seed)."""
    k = len(values)
    q = (np.arange(k) + 0.5) / k
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf(x) for x in q])
    share = np.exp(sigma * z)
    sizes = np.floor(share / share.sum() * n).astype(np.int64)
    sizes[np.argsort(-share)[: n - sizes.sum()]] += 1
    out = np.repeat(values[rng.permutation(k)], sizes)
    return out[rng.permutation(n)]


def digit_strings(codes: np.ndarray, width: int) -> np.ndarray:
    """Whole numbers under 10 ** ``width`` as strings of ``width`` digits."""
    text = (np.asarray(codes, np.int64) + 10 ** width).astype(f"U{width + 1}")
    digits = text.view("U1").reshape(-1, width + 1)[:, 1:].copy()
    return digits.view(f"U{width}").ravel().astype(object)


def typos(rng, values: np.ndarray) -> np.ndarray:
    """Each value with one random insertion, deletion, substitution or
    transposition of neighbours (a digit for a value of digits, else a
    letter); a value of one character takes an insertion."""
    n = len(values)
    if n == 0:
        return values
    raw = np.array(values, dtype=bytes)
    width = raw.dtype.itemsize + 1
    chars = np.zeros((n, width + 1), np.uint8)
    chars[:, : width - 1] = raw.view(np.uint8).reshape(n, width - 1)
    length = (chars != 0).sum(axis=1)
    op = np.where(length < 2, 0, rng.integers(0, 4, n))  # insert, delete, substitute, swap
    u = rng.random(n)
    digits = np.all((chars[:, :width - 1] == 0) | ((chars[:, :width - 1] >= 48)
                                                    & (chars[:, :width - 1] <= 57)), axis=1)
    new = np.where(digits, DIGITS[rng.integers(0, 10, n)], LETTERS[rng.integers(0, 26, n)])
    at = np.where(op == 0, np.floor(u * (length + 1)), np.floor(u * length)).astype(np.int64)
    at = np.where(op == 3, np.minimum(at, length - 2), at)
    t = np.arange(width)[None, :]
    i = at[:, None]
    src = np.select([(op == 0)[:, None] & (t > i), (op == 1)[:, None] & (t >= i),
                     (op == 3)[:, None] & (t == i), (op == 3)[:, None] & (t == i + 1)],
                    [t - 1, t + 1, t + 1, t - 1], t)
    out = np.take_along_axis(chars, src, axis=1)[:, :width]
    put = (op == 0) | (op == 2)
    out[put, at[put]] = new[put]
    return out.view(f"S{width}").ravel().astype(f"U{width}").astype(object)


def originals(rng, n: int, pools: dict) -> dict:
    """``n`` original records, each field drawn on its own."""
    cols = {}
    for name in ("given_name", "surname", "address_1", "address_2", "suburb"):
        values, s = pools[name]
        cols[name] = zipf_draw(rng, values, s, n)
    cols["street_number"] = np.minimum(np.exp(rng.random(n) * np.log(1000)), 999).astype(
        np.int64).astype(str).astype(object)
    codes, sigma = pools["postcode"]
    cols["postcode"] = sized_draw(rng, codes, sigma, n)
    cols["state"] = np.array(STATES, dtype=object)[rng.choice(len(STATES), n, p=STATE_SHARES)]
    day = np.datetime64("1920-01-01") + rng.integers(0, 90 * 365, n).astype("timedelta64[D]")
    year = day.astype("datetime64[Y]")
    month = day.astype("datetime64[M]")
    ymd = ((year.astype(np.int64) + 1970) * 10000 + (month - year).astype(np.int64) * 100
           + 100 + (day - month).astype(np.int64) + 1)
    cols["date_of_birth"] = ymd.astype(str).astype(object)
    # distinct 7-digit numbers: a seeded affine bijection of 0..8,999,999
    a = int(rng.choice([7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]))
    ids = (a * np.arange(n, dtype=np.int64) + int(rng.integers(0, 9_000_000))) % 9_000_000
    cols["soc_sec_id"] = digit_strings(1_000_000 + ids, 7)
    return cols


def generate(n: int, seed: int, records: dict):
    """A pandas DataFrame of ``n`` records (``unique_id`` the row number)
    under ``records`` (the configuration's duplicate model and pools)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_orig = int(round(n * records["originals_share"]))
    n_dup = n - n_orig
    pools = {}
    for name, (k, s) in records["zipf_pools"].items():
        if name == "address_1":
            stems = words(rng, k, (2, 3))
            kinds = np.array(STREET_TYPES, dtype=object)[rng.integers(0, len(STREET_TYPES), k)]
            pools[name] = (np.unique(stems + " " + kinds), s)
        elif name == "address_2":
            stems = words(rng, k, (2,))
            kinds = np.array(SITES, dtype=object)[rng.integers(0, len(SITES), k)]
            pools[name] = (np.unique(stems + " " + kinds), s)
        else:
            pools[name] = (words(rng, k), s)
    k, sigma = records["postcodes"]
    pools["postcode"] = (digit_strings(np.sort(rng.choice(np.arange(200, 10_000), k, False)),
                                       4), sigma)
    cols = originals(rng, n_orig, pools)
    for name, share in records["original_missing"].items():
        cols[name][rng.random(n_orig) < share] = None

    # duplicates: originals in a seeded order, each with 1..max duplicates
    # (Zipf), until there are n_dup
    most = int(records["max_duplicates_per_original"])
    p = 1.0 / np.arange(1, most + 1)
    counts = rng.choice(np.arange(1, most + 1), n_orig, p=p / p.sum())
    order = rng.permutation(n_orig)
    counts = counts[order]
    used = int(np.searchsorted(np.cumsum(counts), n_dup)) + 1
    counts = counts[:used]
    counts[-1] -= int(counts.sum()) - n_dup
    src = np.repeat(order[:used], counts)
    for name in FIELDS:
        cols[name] = np.concatenate([cols[name], cols[name][src]])

    # each duplicate: 1..max_modifications_per_record fields, at most one
    # change a field: a typo, the value missing, or another value of the field
    per_record = rng.integers(1, int(records["max_modifications_per_record"]) + 1, n_dup)
    ranks = np.argsort(rng.random((n_dup, len(FIELDS))), axis=1)
    chosen = ranks < per_record[:, None]
    kinds = list(records["modification_kinds"])
    shares = np.array([records["modification_kinds"][k] for k in kinds])
    kind = rng.choice(len(kinds), (n_dup, len(FIELDS)), p=shares / shares.sum())
    for f, name in enumerate(FIELDS):
        col = cols[name]
        rows = n_orig + np.flatnonzero(chosen[:, f])
        present = np.not_equal(col[rows], None)
        k_of = kind[rows - n_orig, f]
        typo_rows = rows[present & (k_of == kinds.index("typo"))]
        col[typo_rows] = typos(rng, col[typo_rows])
        col[rows[k_of == kinds.index("missing")]] = None
        other = rows[k_of == kinds.index("replace")]
        col[other] = col[rng.integers(0, n_orig, len(other))]
    cols["unique_id"] = np.arange(n)
    return pd.DataFrame(cols)
