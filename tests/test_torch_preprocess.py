"""The port's offline preprocessing (sessionrec_tpu_torch/data/preprocess.py,
numpy only) against the JAX package's pandas pipelines: the same raw logs,
made from a seed, give byte-identical train.txt, test.txt and
num_items.txt and the same printed lines, for diginetica, gowalla, lastfm
and yoochoose stage 1.  Each fixture holds one of the pandas semantics
that decide the bytes, and asserts that its trap is really in the data."""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke as cs
from sessionrec_tpu import cli as jax_cli
from sessionrec_tpu.data import preprocess as jp
from sessionrec_tpu_torch import cli as torch_cli
from sessionrec_tpu_torch.data import preprocess as tp

ROOT = Path(__file__).resolve().parents[1]
FILES = ("train.txt", "test.txt", "num_items.txt")


def _files(out):
    return {f: (Path(out) / f).read_bytes() for f in FILES}


def _both(tmp_path, capsys, fn, raw, jax_args=(), torch_args=()):
    """Run ``fn`` of both packages on ``raw`` (with their own extra
    arguments: the JAX package takes intervals as ``pd.Timedelta``, the
    port as int64 nanoseconds); return the port's files after asserting
    they and the printed lines equal the JAX package's."""
    outs = {}
    for name, mod, args in (("jax", jp, jax_args), ("torch", tp, torch_args)):
        out = tmp_path / name
        getattr(mod, fn)(out, raw, *args)
        outs[name] = (_files(out), capsys.readouterr().out
                      .replace(str(out), "OUT"))
    assert outs["torch"] == outs["jax"]
    return outs["torch"][0]


def _lines(data):
    return data.decode().splitlines()


def _checkins(rng, n_users, n_items, n_bursts, span_s, zipf=1.1,
              long_every=0):
    """(user, unix seconds, item) of bursts of check-ins: minute-resolution
    times (so session end times tie), Zipf item popularity, immediate
    repeats, and every ``long_every``-th burst 30 check-ins long."""
    p = np.arange(1, n_items + 1, dtype=float) ** -zipf
    rows = []
    for b in range(n_bursts):
        u = int(rng.integers(0, n_users))
        t = int(rng.integers(0, span_s // 60)) * 60
        length = 30 if long_every and b % long_every == 0 else \
            int(rng.integers(1, 7))
        for _ in range(length):
            item = int(rng.choice(n_items, p=p / p.sum()))
            rows.append((u, t, item))
            if rng.random() < 0.1:
                rows.append((u, t + 60, item))          # immediate repeat
            t += 60 * int(rng.integers(1, 90))
    return rows


def _iso(t, fmt="Z"):
    s = np.datetime_as_string(np.datetime64(int(t), "s"), unit="s")
    return {"Z": s + "Z", "+02:00": s + "+02:00", "frac": s + ".250Z",
            "naive": s}[fmt]


def _gowalla_file(path, rows, fmt="Z"):
    """gowalla's layout (user, time, lat, lon, location; user then time
    descending), with an empty location field and quote-led latitude
    fields that hold a tab and an escaped quote."""
    rows = sorted(rows, key=lambda r: (r[0], -r[1]))
    lines = []
    for i, (u, t, item) in enumerate(rows):
        lat = '"1.5\t2 ""q"""' if i % 97 == 3 else f"{i % 90}.123"
        loc = "" if i % 211 == 5 else str(item)
        lines.append(f"{u}\t{_iso(t, fmt)}\t{lat}\t-7.5\t{loc}\n")
    Path(path).write_text("".join(lines))
    return path


def _port_frame(raw, usecols=(0, 1, 4), interval=tp.DAY_NS):
    """The port's gowalla frame up to the top-n cut, to find the traps."""
    user, ts, item = tp._read_columns(raw, list(usecols), "\t", False)
    ts, miss = tp._parse_times(ts)
    keep = ~miss & np.array([u is not None and i is not None
                             for u, i in zip(user, item)])
    df = {"userId": np.array([u for u, k in zip(user, keep) if k]),
          "timestamp": ts[keep],
          "itemId": np.array([i for i, k in zip(item, keep) if k])}
    df = tp.update_id(tp.update_id(df, "userId"), "itemId")
    df = tp._take(df, np.lexsort((df["timestamp"], df["userId"])))
    df = tp.remove_immediate_repeats(tp.group_sessions(df, interval))
    return tp.truncate_long_sessions(df, is_sorted=True)


@pytest.fixture
def gowalla_raw(tmp_path):
    rng = np.random.default_rng(0)
    rows = _checkins(rng, 60, 80, 700, 20 * 86400, long_every=50)
    return _gowalla_file(tmp_path / "gowalla.txt", rows)


def test_gowalla_matches_jax(tmp_path, capsys, gowalla_raw):
    text = gowalla_raw.read_text()
    assert '"1.5\t2 ""q"""' in text and "\t\n" in text
    df = _port_frame(gowalla_raw)
    _, end, _ = tp._group_max(df["sessionId"], df["timestamp"])
    assert len(np.unique(end)) < len(end)                # tied end times
    rep = (np.diff(df["sessionId"]) != 0) | (np.diff(df["itemId"]) != 0)
    assert rep.all()                    # repeats gone inside sessions ...
    raw_items = [ln.split("\t")[4] for ln in text.splitlines()]
    assert any(a == b != "" for a, b in zip(raw_items, raw_items[1:]))
    out = _both(tmp_path, capsys, "preprocess_gowalla", gowalla_raw)
    lens = [len(s.split(",")) for s in _lines(out["train.txt"])]
    assert max(lens) == 20 and min(lens) >= 2            # truncated to 20


def test_ties_at_the_top_n_cut_keep_the_first_appearing(tmp_path, capsys,
                                                        gowalla_raw):
    """A cut inside a run of equal counts (of items frequent enough to
    survive the later filters): the first-appearing items of the run stay,
    as ``nlargest(keep="first")`` keeps them."""
    df = _port_frame(gowalla_raw)
    _, _, cnt = tp._first_order(df["itemId"])
    desc = np.sort(cnt)[::-1]
    cuts = [n for n in range(1, len(desc)) if desc[n - 1] == desc[n] >= 5]
    assert cuts, "no cut that falls among tied counts"
    n = cuts[len(cuts) // 2]
    _both(tmp_path, capsys, "preprocess_gowalla_lastfm", gowalla_raw,
          ([0, 1, 4], pd.Timedelta(days=1), n), ([0, 1, 4], tp.DAY_NS, n))


def test_lastfm_matches_jax(tmp_path, capsys):
    """lastfm-1K's layout: string user ids, artist MBIDs (some empty),
    artist and track names with quotes; timestamps with one offset, and
    with fractional seconds."""
    rng = np.random.default_rng(1)
    rows = _checkins(rng, 40, 90, 600, 10 * 86400)
    for fmt in ("+02:00", "frac"):
        lines = []
        for i, (u, t, item) in enumerate(sorted(rows)):
            mbid = "" if i % 150 == 7 else f"mbid-{item:04d}"
            name = f'"The ""Band"" {item}"' if i % 13 == 0 else f"band {item}"
            lines.append(f"user_{u:06d}\t{_iso(t, fmt)}\t{mbid}\t{name}\t"
                         f"trk\t\"a \t track\"\n")
        raw = tmp_path / f"lastfm_{fmt[0]}.tsv"
        raw.write_text("".join(lines))
        sub = tmp_path / fmt.strip("+:")
        sub.mkdir()
        out = _both(sub, capsys, "preprocess_lastfm", raw)
        assert out["train.txt"] and out["test.txt"]


def _diginetica_file(path, sessions):
    lines = ["sessionId;userId;itemId;timeframe;eventdate"]
    for sid, day, items in sessions:
        for j, (item, frame) in enumerate(items):
            lines.append(f"{sid};NA;{item};{frame};2016-05-{day:02d}")
    Path(path).write_text("\n".join(lines) + "\n")
    return path


def test_diginetica_matches_jax_with_a_session_ending_at_the_split(
        tmp_path, capsys):
    """Sessions end on days 1..20; the last ends on day 20 at frame 5000,
    one on day 13 at frame 5000 too: exactly at max - 7 days, so in
    neither split (strict comparisons).  Frames repeat, so end times tie;
    one session runs past 20 items."""
    rng = np.random.default_rng(2)
    sessions = []
    for sid in range(400):
        day = int(rng.integers(1, 20))
        n = 25 if sid == 17 else int(rng.integers(1, 7))
        frames = np.sort(rng.integers(0, 40, n)) * 1000
        sessions.append((sid, day, [(int(rng.integers(0, 50)), int(f))
                                    for f in frames]))
    sessions.append((900, 20, [(1, 0), (2, 5000)]))
    sessions.append((901, 13, [(3, 1000), (4, 5000)]))
    raw = _diginetica_file(tmp_path / "train-item-views.csv", sessions)
    out = _both(tmp_path, capsys, "preprocess_diginetica", raw)
    assert out["test.txt"] and out["train.txt"]


@pytest.mark.parametrize("n_users", [1, 2, 3])
def test_fewer_than_five_sessions_make_everything_test(tmp_path, capsys,
                                                       n_users):
    rows = [(u, 3600 * j + 86400 * 3 * u, j % 2) for u in range(n_users)
            for j in range(12)]
    raw = _gowalla_file(tmp_path / "g.txt", rows)
    out = _both(tmp_path, capsys, "preprocess_gowalla", raw)
    assert out == {"train.txt": b"", "test.txt": b"", "num_items.txt": b"0"}


@pytest.mark.parametrize("fmts", [("Z", "naive"), ("Z", "+02:00")])
def test_mixed_time_zones_raise_as_pandas_does(tmp_path, fmts):
    rows = [(0, 60 * j, j % 3) for j in range(10)]
    raw = tmp_path / "g.txt"
    _gowalla_file(raw, rows)
    text = raw.read_text().splitlines(True)
    other = _gowalla_file(tmp_path / "h.txt", rows, fmts[1]).read_text()
    raw.write_text("".join(text[:5]) + "".join(other.splitlines(True)[5:]))
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="ixed"):
            mod.preprocess_gowalla(tmp_path / "out", raw)


def test_yoochoose_stage1_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    rows = []
    for sid in range(300):
        day = int(rng.integers(0, 20))
        n = int(rng.integers(25, 40)) if sid % 17 == 0 else \
            int(rng.integers(1, 6))
        for j in range(n):
            rows.append(f"{sid},2014-04-{day + 1:02d}T10:{j:02d}:00.000Z,"
                        f"{int(rng.integers(100, 140))},0")
    raw = tmp_path / "yoochoose-clicks.dat"
    raw.write_text("\n".join(rows) + "\n")
    outs = {}
    for name, mod in (("jax", jp), ("torch", tp)):
        mod.preprocess_yoochoose_stage1(tmp_path / name, raw)
        outs[name] = {split: _files(tmp_path / name / split)
                      for split in ("yoochoose_full", "yoochoose1_4",
                                    "yoochoose1_64")}
        outs[name]["printed"] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 31), n_users=st.integers(1, 12),
       n_items=st.integers(2, 15), n_bursts=st.integers(1, 80),
       span_days=st.integers(1, 5))
def test_random_small_logs_match_jax(tmp_path_factory, seed, n_users,
                                     n_items, n_bursts, span_days):
    tmp = tmp_path_factory.mktemp("hyp")
    rng = np.random.default_rng(seed)
    rows = _checkins(rng, n_users, n_items, n_bursts, span_days * 86400)
    raw = _gowalla_file(tmp / "g.txt", rows)
    outs = {}
    for name, mod, gap in (("jax", jp, pd.Timedelta(hours=8)),
                           ("torch", tp, 8 * tp.HOUR_NS)):
        mod.preprocess_gowalla_lastfm(tmp / name, raw, [0, 1, 4], gap,
                                      max(1, n_items // 2))
        outs[name] = _files(tmp / name)
    assert outs["torch"] == outs["jax"]


def test_cli_preprocess_matches_jax_and_needs_no_pandas(tmp_path, capsys,
                                                        gowalla_raw):
    """``cli preprocess`` of the port in a subprocess with pandas blocked,
    in process, and the JAX package's ``cmd_preprocess``: the same files."""
    jax_cli.main(["preprocess", "--dataset", "gowalla", "--input",
                  str(gowalla_raw), "--output-dir", str(tmp_path / "jax")])
    torch_cli.main(["preprocess", "--dataset", "gowalla", "--input",
                    str(gowalla_raw), "--output-dir", str(tmp_path / "cli")])
    code = ("import sys; sys.modules['pandas'] = None; "
            "from sessionrec_tpu_torch.cli import main; main(sys.argv[1:])")
    proc = subprocess.run(
        [sys.executable, "-c", code, "preprocess", "--dataset", "gowalla",
         "--input", str(gowalla_raw), "--output-dir", str(tmp_path / "sub")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    capsys.readouterr()
    want = _files(tmp_path / "jax")
    assert _files(tmp_path / "cli") == want
    assert _files(tmp_path / "sub") == want
    blocked = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['pandas'] = None; "
         "import sessionrec_tpu.data.preprocess"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=120)
    assert blocked.returncode != 0          # the block does bite


def test_chip_smoke_digest_is_the_jax_packages(tmp_path, capsys):
    """chip_smoke.py's preprocess phase holds the port's files to
    PRE_SHA256: recompute it through the JAX package on the log of seed 0
    (and the log's own digest)."""
    raw = tmp_path / "checkins.txt"
    cs.gowalla_log(np, raw, 0)
    assert hashlib.sha256(raw.read_bytes()).hexdigest() == cs.PRE_LOG_SHA256
    jp.preprocess_gowalla(tmp_path / "jax", raw)
    capsys.readouterr()
    assert cs.preprocess_digest(tmp_path / "jax") == cs.PRE_SHA256
