"""Offline dataset preprocessing, with numpy and the standard library only.

Counterpart of ``sessionrec_tpu/data/preprocess.py``, in its function
names and order, writing the common ``train.txt`` / ``test.txt`` /
``num_items.txt`` format byte for byte as the JAX package's pandas
pipelines write it:

* diginetica  — time-join eventdate+timeframe, filter, truncate to 20,
  last-7-days test split
* gowalla     — cols [0,1,4], 1-day session gap, top-30,000 items
* lastfm      — cols [0,1,2], 8-hour gap, top-40,000 items
* yoochoose   — the stage-1 script (plain Python, as in the JAX package),
  with its 1/4 and 1/64 train slices.

This is host code: it touches no device.  A frame is a dict of equal-length
numpy arrays (``userId``, ``sessionId``, ``itemId``, ``timestamp`` in int64
nanoseconds); rows are selected by masks and index arrays, never by a loop
over rows.  The pandas semantics that decide the bytes are kept:

* ``factorize`` and ``groupby(sort=False)`` number and list groups in the
  order of their first appearance (``_first_order``);
* ``nlargest(n)`` keeps, among counts tied at the cut, the group that
  appears first (a stable descending sort);
* ``Series.sort_values()`` of one column is numpy's unstable quicksort of
  the values in their group order (``_sort_endtimes``: pandas sorts
  datetimes as ``datetime64``, and so does this module, since numpy may
  sort int64 ties in another order); sorts over two columns are stable
  (``np.lexsort``);
* ``shift()`` makes row 0 start a session; an immediate repeat is removed
  only inside a session;
* ``split_by_time`` compares strictly; ``train_test_split`` with fewer
  than 5 sessions takes them all as test (``index[-0:]``).

Raw files are parsed as ``pd.read_csv`` parses them: ``csv`` quoting (a
field that starts with a quote may hold tabs and newlines), pandas'
default missing-value strings, columns that are all integers (or all
numbers) compared as numbers.  Timestamps follow ``pd.to_datetime(...,
format="mixed")`` for ISO 8601 (``YYYY-MM-DD[(T| )HH:MM[:SS[.f]]]`` with
``Z``, ``z`` or a ``±HH[:MM]`` offset): aware ones are taken in UTC, and a
mix of naive and aware strings, or of two offsets, raises as pandas does.
Other date formats, which pandas hands to dateutil, raise here, as do
missing values in diginetica's columns.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path

import numpy as np

DAY_NS = 86_400 * 10 ** 9
HOUR_NS = 3_600 * 10 ** 9

# pandas' default missing-value strings (pandas/_libs/parsers.pyx
# STR_NA_VALUES)
_NA = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"])
_INT = re.compile(r"\s*[+-]?[0-9]+\s*", re.ASCII)
_TS = re.compile(
    r"\s*([0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"(?:[T ][0-9]{2}:[0-9]{2}(?::[0-9]{2}(?:\.[0-9]{1,9})?)?)?)"
    r"(?:\s*([Zz])|([+-])([0-9]{2})(?::?([0-9]{2}))?)?\s*", re.ASCII)
# the layout of nearly every check-in log: YYYY-MM-DDTHH:MM:SSZ
_ISO_Z = "0000-00-00T00:00:00Z"


# ---------------------------------------------------------------------------
# frames: dicts of equal-length arrays
# ---------------------------------------------------------------------------

def _take(df, rows):
    return {k: v[rows] for k, v in df.items()}


def _first_order(keys):
    """``(uniques in order of first appearance, each row's group number in
    that order, count of each group)`` of a key array
    (``pd.factorize`` and ``groupby(sort=False)``)."""
    uniq, first, inv, cnt = np.unique(keys, return_index=True,
                                      return_inverse=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], rank[inv.reshape(-1)], cnt[order]


def _group_max(keys, values):
    """``(group keys, max of values)`` per group, in order of first
    appearance, and each row's group number."""
    uniq, code, _ = _first_order(keys)
    mx = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
    np.maximum.at(mx, code, values)
    return uniq, mx, code


def _sort_endtimes(end):
    """The order of ``Series.sort_values()`` over session end times: the
    quicksort that pandas calls on the ``datetime64`` values."""
    return np.argsort(end.astype("datetime64[ns]"), kind="quicksort")


# ---------------------------------------------------------------------------
# generic steps (sessionrec_tpu/data/preprocess.py:45-150)
# ---------------------------------------------------------------------------

def get_session_id(df, interval):
    uid, ts = df["userId"], df["timestamp"]
    new = np.ones(len(uid), bool)
    new[1:] = (uid[1:] != uid[:-1]) | (ts[1:] - ts[:-1] > interval)
    return np.cumsum(new) - 1


def group_sessions(df, interval):
    return dict(df, sessionId=get_session_id(df, interval))


def filter_short_sessions(df, min_len=2):
    _, code, cnt = _first_order(df["sessionId"])
    return _take(df, cnt[code] >= min_len)


def filter_infreq_items(df, min_support=5):
    _, code, cnt = _first_order(df["itemId"])
    return _take(df, cnt[code] >= min_support)


def filter_until_all_long_and_freq(df, min_len=2, min_support=5):
    while True:
        df_long = filter_short_sessions(df, min_len)
        df_freq = filter_infreq_items(df_long, min_support)
        if len(df_freq["itemId"]) == len(df["itemId"]):
            break
        df = df_freq
    return df


def _cumcount(keys):
    """``groupby(keys).cumcount()``: each row's position among the rows of
    its group, in row order."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.ones(len(sk), bool)
    start[1:] = sk[1:] != sk[:-1]
    idx = np.arange(len(sk))
    first = np.maximum.accumulate(np.where(start, idx, 0))
    pos = np.empty(len(sk), np.int64)
    pos[order] = idx - first
    return pos


def truncate_long_sessions(df, max_len=20, is_sorted=False):
    if not is_sorted:
        df = _take(df, np.lexsort((df["timestamp"], df["sessionId"])))
    return _take(df, _cumcount(df["sessionId"]) < max_len)


def update_id(df, field):
    return dict(df, **{field: _first_order(df[field])[1]})


def remove_immediate_repeats(df):
    sid, item = df["sessionId"], df["itemId"]
    keep = np.ones(len(sid), bool)
    keep[1:] = (sid[1:] != sid[:-1]) | (item[1:] != item[:-1])
    return _take(df, keep)


def reorder_sessions_by_endtime(df):
    _, end, code = _group_max(df["sessionId"], df["timestamp"])
    new_id = np.empty(len(end), np.int64)
    new_id[_sort_endtimes(end)] = np.arange(len(end))
    df = dict(df, sessionId=new_id[code])
    return _take(df, np.lexsort((df["timestamp"], df["sessionId"])))


def keep_top_n_items(df, n):
    _, code, cnt = _first_order(df["itemId"])
    if n >= len(cnt):
        return df
    top = np.zeros(len(cnt), bool)
    top[np.argsort(-cnt, kind="stable")[:n]] = True
    return _take(df, top[code])


def split_by_time(df, timedelta):
    if not len(df["timestamp"]):
        return df, df
    max_time = df["timestamp"].max()
    _, end, code = _group_max(df["sessionId"], df["timestamp"])
    split_time = max_time - timedelta
    return (_take(df, (end < split_time)[code]),
            _take(df, (end > split_time)[code]))


def train_test_split(df, test_split=0.2):
    sids, end, _ = _group_max(df["sessionId"], df["timestamp"])
    num_tests = int(len(end) * test_split)
    test_sids = sids[_sort_endtimes(end)][-num_tests:]
    is_test = np.isin(df["sessionId"], test_sids)
    return _take(df, ~is_test), _take(df, is_test)


def save_sessions(df, filepath):
    df = reorder_sessions_by_endtime(df)
    sid = df["sessionId"]
    items = df["itemId"].tolist()
    cuts = (np.flatnonzero(sid[1:] != sid[:-1]) + 1).tolist()
    bounds = zip([0] + cuts, cuts + [len(items)])
    lines = [",".join(map(str, items[a:b])) + "\n" for a, b in bounds
             if b > a]
    with open(filepath, "w") as f:
        f.write("".join(lines))


def save_dataset(dataset_dir, df_train, df_test):
    dataset_dir = Path(dataset_dir)
    # drop test items unseen in train, re-filter short test sessions
    df_test = _take(df_test, np.isin(df_test["itemId"], df_train["itemId"]))
    df_test = filter_short_sessions(df_test)

    print(f"No. of Clicks: {len(df_train['itemId']) + len(df_test['itemId'])}")
    print(f"No. of Items: {len(np.unique(df_train['itemId']))}")

    uniques, train_ids, _ = _first_order(df_train["itemId"])
    df_train = dict(df_train, itemId=train_ids)
    # every test item is one of uniques (filtered above)
    srt = np.argsort(uniques)
    df_test = dict(df_test, itemId=srt[np.searchsorted(
        uniques, df_test["itemId"], sorter=srt)])

    dataset_dir.mkdir(parents=True, exist_ok=True)
    save_sessions(df_train, dataset_dir / "train.txt")
    save_sessions(df_test, dataset_dir / "test.txt")
    with open(dataset_dir / "num_items.txt", "w") as f:
        f.write(str(len(uniques)))


# ---------------------------------------------------------------------------
# reading raw files as pd.read_csv and pd.to_datetime(format="mixed") do
# ---------------------------------------------------------------------------

def _read_columns(path, usecols, delimiter, header):
    """The fields of columns ``usecols`` of a delimited text file, one list
    per column, None where a row is too short or the field is one of
    pandas' missing-value strings; blank lines are skipped, quoting is
    ``csv``'s (as pandas' C parser's).  Raises where no row reaches the
    last column, as pandas does."""
    cols = [[] for _ in usecols]
    widest = 0
    with open(path, encoding="utf-8-sig", newline="") as f:
        rows = csv.reader(f, delimiter=delimiter)
        if header:
            next(rows, None)
        for row in rows:
            if not row:
                continue
            widest = max(widest, len(row))
            for c, k in zip(cols, usecols):
                v = row[k] if k < len(row) else None
                c.append(None if v in _NA else v)
    if cols[0] and widest <= max(usecols):
        raise ValueError(f"{path}: rows have {widest} fields, column "
                         f"{max(usecols)} was asked for")
    return cols


def _keys(col):
    """The values of a parsed column as pandas would compare them: ints
    where every present field is an integer, floats where every one is a
    number, else the strings; None stays None."""
    present = [v for v in col if v is not None]
    if all(_INT.fullmatch(v) for v in present):
        return [None if v is None else int(v) for v in col]
    try:
        return [None if v is None else float(v) for v in col]
    except ValueError:
        return col


def _parse_times(col):
    """int64 nanoseconds (UTC for aware strings) of ISO 8601 strings, and
    a mask of the missing ones; raises on what the module docstring
    excludes and where pandas raises."""
    present = np.array([v is not None for v in col], bool)
    strs = [v for v in col if v is not None]
    out = np.zeros(len(col), np.int64)
    if not strs:
        return out, ~present
    arr = np.array(strs)
    if arr.dtype.itemsize == 4 * len(_ISO_Z) and _all_iso_z(arr):
        ns = arr.astype("U19").astype("datetime64[ns]").astype(np.int64)
    else:
        ns = _parse_general(strs)
    out[present] = ns
    return out, ~present


def _all_iso_z(arr):
    """Every string of a fixed-width (20) array is YYYY-MM-DDTHH:MM:SSZ."""
    cp = arr.view(np.uint32).reshape(len(arr), len(_ISO_Z))
    want = np.array([ord(c) for c in _ISO_Z], np.uint32)
    digit = want == ord("0")
    return bool(np.all((cp[:, ~digit] == want[~digit]))
                and np.all((cp[:, digit] >= ord("0"))
                           & (cp[:, digit] <= ord("9"))))


def _parse_general(strs):
    bases, offsets = [], []
    for s in strs:
        m = _TS.fullmatch(s)
        if m is None:
            raise ValueError(f"unsupported timestamp {s!r}")
        base, z, sign, hh, mm = m.groups()
        bases.append(base)
        if z:
            offsets.append(0)
        elif sign:
            off = (int(hh) * 60 + int(mm or 0)) * 60
            offsets.append(-off if sign == "-" else off)
        else:
            offsets.append(None)
    zones = set(offsets)
    if len(zones) > 1:
        raise ValueError("Mixed timezones detected: naive and aware, or "
                         "several offsets, as pandas refuses them")
    ns = np.array(bases, dtype="datetime64[ns]").astype(np.int64)
    off = zones.pop()
    return ns - (off or 0) * 10 ** 9


# ---------------------------------------------------------------------------
# per-dataset pipelines
# ---------------------------------------------------------------------------

def preprocess_diginetica(dataset_dir, csv_file):
    print(f"reading {csv_file}...")
    sid, item, frame, date = _read_columns(csv_file, [0, 2, 3, 4], ";",
                                           header=True)
    if any(v is None for col in (sid, item, frame, date) for v in col):
        raise ValueError(f"{csv_file}: missing values in sessionId, itemId, "
                         "timeframe or eventdate")
    frame = _keys(frame)
    if not all(isinstance(v, int) for v in frame):
        raise ValueError(f"{csv_file}: timeframe must be integer ms")
    eventdate, _ = _parse_times(date)
    df = {"sessionId": np.array(_keys(sid)), "itemId": np.array(_keys(item)),
          "timestamp": eventdate + np.array(frame, np.int64) * 10 ** 6}
    df = _take(df, np.lexsort((df["timestamp"], df["sessionId"])))
    df = filter_short_sessions(df)
    df = truncate_long_sessions(df, is_sorted=True)
    df = filter_infreq_items(df)
    df = filter_short_sessions(df)
    df_train, df_test = split_by_time(df, 7 * DAY_NS)
    save_dataset(dataset_dir, df_train, df_test)


def preprocess_gowalla_lastfm(dataset_dir, csv_file, usecols, interval, n):
    print(f"reading {csv_file}...")
    user, ts, item = _read_columns(csv_file, sorted(usecols), "\t",
                                   header=False)
    ts, ts_missing = _parse_times(ts)
    keep = ~ts_missing & np.array(
        [u is not None and i is not None for u, i in zip(user, item)], bool)
    rows = np.flatnonzero(keep).tolist()
    user, item = _keys(user), _keys(item)
    df = {"userId": np.array([user[r] for r in rows]), "timestamp": ts[keep],
          "itemId": np.array([item[r] for r in rows])}
    df = update_id(df, "userId")
    df = update_id(df, "itemId")
    df = _take(df, np.lexsort((df["timestamp"], df["userId"])))
    df = group_sessions(df, interval)
    df = remove_immediate_repeats(df)
    df = truncate_long_sessions(df, is_sorted=True)
    df = keep_top_n_items(df, n)
    df = filter_until_all_long_and_freq(df)
    df_train, df_test = train_test_split(df, test_split=0.2)
    save_dataset(dataset_dir, df_train, df_test)


def preprocess_gowalla(dataset_dir, csv_file):
    # cols [0,1,4], 1-day gap, top-30000 (src/preprocess.py:43-50)
    preprocess_gowalla_lastfm(dataset_dir, csv_file, usecols=[0, 1, 4],
                              interval=DAY_NS, n=30000)


def preprocess_lastfm(dataset_dir, csv_file):
    # cols [0,1,2], 8-hour gap, top-40000 (src/preprocess.py:51-57)
    preprocess_gowalla_lastfm(dataset_dir, csv_file, usecols=[0, 1, 2],
                              interval=8 * HOUR_NS, n=40000)


# ---------------------------------------------------------------------------
# yoochoose: stage 1 (SR-GNN-style; datasets/preprocess_yoochoose.py), the
# JAX package's plain-Python pipeline as it stands
# ---------------------------------------------------------------------------

def preprocess_yoochoose_stage1(dataset_dir, clicks_dat):
    """Parse yoochoose-clicks.dat, filter, split test = last day, renumber
    items in encounter order starting from 0, write 1/4 and 1/64 slices.

    As the JAX package's stage 1: no truncation (``--max-len`` caps
    sessions at load time), 0-based ids in train-encounter order, and
    ``num_items`` = max item id + 1, the catalog size.
    """
    import operator
    from datetime import datetime

    dataset_dir = Path(dataset_dir)
    print(f"reading {clicks_dat}...")
    sess_clicks = {}
    sess_date = {}
    with open(clicks_dat) as f:
        reader = csv.DictReader(f, fieldnames=["session_id", "timestamp",
                                               "item_id", "category"])
        curid = -1
        curdate = None
        for data in reader:
            sessid = data["session_id"]
            if curdate and curid != sessid:
                sess_date[curid] = datetime.strptime(
                    curdate[:19], "%Y-%m-%dT%H:%M:%S").timestamp()
            curid = sessid
            sess_clicks.setdefault(sessid, []).append(data["item_id"])
            curdate = data["timestamp"]
        if curdate:
            sess_date[curid] = datetime.strptime(
                curdate[:19], "%Y-%m-%dT%H:%M:%S").timestamp()

    # filter length-1 sessions
    for s in list(sess_clicks):
        if len(sess_clicks[s]) == 1:
            del sess_clicks[s]
            sess_date.pop(s, None)

    # count item support, keep >= 5, re-filter short sessions
    iid_counts = {}
    for s in sess_clicks:
        for iid in sess_clicks[s]:
            iid_counts[iid] = iid_counts.get(iid, 0) + 1
    for s in list(sess_clicks):
        filseq = [i for i in sess_clicks[s] if iid_counts[i] >= 5]
        if len(filseq) < 2:
            del sess_clicks[s]
            sess_date.pop(s, None)
        else:
            sess_clicks[s] = filseq

    # test = sessions of the last day (preprocess_yoochoose.py:114)
    dates = list(sess_date.items())
    maxdate = max(d for _, d in dates)
    splitdate = maxdate - 86400
    tra_sess = sorted([(s, d) for s, d in dates if d < splitdate],
                      key=operator.itemgetter(1))
    tes_sess = sorted([(s, d) for s, d in dates if d > splitdate],
                      key=operator.itemgetter(1))

    # renumber items starting at 0 in train-encounter order
    # (preprocess_yoochoose.py:137-148); sessions pass through whole
    item_dict = {}
    item_ctr = 0
    train_seqs = []
    for s, _ in tra_sess:
        outseq = []
        for i in sess_clicks[s]:
            if i not in item_dict:
                item_dict[i] = item_ctr
                item_ctr += 1
            outseq.append(item_dict[i])
        if len(outseq) >= 2:
            train_seqs.append(outseq)
    test_seqs = []
    for s, _ in tes_sess:
        outseq = [item_dict[i] for i in sess_clicks[s] if i in item_dict]
        if len(outseq) >= 2:
            test_seqs.append(outseq)

    print(f"train sessions: {len(train_seqs)}, test sessions: "
          f"{len(test_seqs)}, items: {item_ctr}")

    def write(split_dir, train):
        split_dir.mkdir(parents=True, exist_ok=True)
        with open(split_dir / "train.txt", "w") as f:
            for seq in train:
                f.write(",".join(map(str, seq)) + "\n")
        with open(split_dir / "test.txt", "w") as f:
            for seq in test_seqs:
                f.write(",".join(map(str, seq)) + "\n")
        # catalog size = max id + 1 (0-based ids)
        num_items = max((max(s) for s in train + test_seqs), default=-1) + 1
        with open(split_dir / "num_items.txt", "w") as f:
            f.write(str(num_items))

    # full + 1/4 + 1/64 slices of the train tail (preprocess_yoochoose.py:230-241)
    write(dataset_dir / "yoochoose_full", train_seqs)
    write(dataset_dir / "yoochoose1_4", train_seqs[-(len(train_seqs) // 4):])
    write(dataset_dir / "yoochoose1_64", train_seqs[-(len(train_seqs) // 64):])


def run(dataset: str, input_path: str, output_dir: str):
    if dataset == "diginetica":
        preprocess_diginetica(output_dir, input_path)
    elif dataset == "gowalla":
        preprocess_gowalla(output_dir, input_path)
    elif dataset == "lastfm":
        preprocess_lastfm(output_dir, input_path)
    elif dataset in ("yoochoose", "yoochoose_stage1"):
        preprocess_yoochoose_stage1(output_dir, input_path)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
