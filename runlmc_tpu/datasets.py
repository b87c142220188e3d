"""Benchmark dataset loaders: fx2007, weather, synth.

Behavioral parity with the reference's benchlib loaders
(benchmarks/benchlib/standard_tester.py:69-167): same holdout windows,
same missing-data handling, same train/test splits. Data files are read
from ``RUNLMC_DATA`` (default: the reference checkout's data directory,
mounted read-only) — the loaders only *read* there. The fx2007 and
weather loaders need pandas; importing this module does not.
"""

import os

import numpy as np

DEFAULT_DATA_DIR = os.environ.get("RUNLMC_DATA", "/root/reference/data")


def fx2007(datadir=None):
    """Foreign-exchange 2007 benchmark (Nguyen & Bonilla 2014): D=13
    currency outputs over 2007 trading days; CAD/JPY/AUD have held-out
    windows. Returns (xss, yss, test_xss, test_yss, test_cols, cols)."""
    import pandas as pd

    datadir = datadir or DEFAULT_DATA_DIR
    files = ["2007-2009.csv", "2010-2013.csv", "2014-2017.csv"]
    fx = pd.concat(
        [
            pd.read_csv(os.path.join(datadir, "fx", f), index_col=1)
            for f in files
        ]
    )
    fx = fx.drop(["Wdy", "Jul.Day"], axis=1)
    fx = fx.rename(columns={c: c[:3] for c in fx.columns})
    fx = fx.loc["2007/01/01":"2008/01/01"]

    holdout = {
        "CAD": slice(49, 99),
        "JPY": slice(99, 149),
        "AUD": slice(149, 199),
    }
    for col in fx.columns:
        holdout.setdefault(col, slice(0, 0))

    all_ixs = np.arange(len(fx))
    xss, yss, test_xss, test_yss = [], [], [], []
    for col in fx.columns:
        keep = np.ones(len(fx), dtype=bool)
        keep[fx[col].isnull().values] = False
        keep[holdout[col]] = False
        sel = np.flatnonzero(keep)
        xss.append(all_ixs[sel].astype(float))
        # the paper models USD-per-currency = 1 / (currency per USD)
        yss.append(np.reciprocal(fx[col].values[sel]))
        test_xss.append(all_ixs[holdout[col]].astype(float))
        test_yss.append(np.reciprocal(fx.iloc[holdout[col]][col].values))
    test_cols = ["CAD", "JPY", "AUD"]
    return xss, yss, test_xss, test_yss, test_cols, list(fx.columns)


def weather(datadir=None):
    """Weather-sensor benchmark: D=4 air-temperature series (~15.8k
    points), with held-out time windows for 'cam' and 'chi' and NaN
    drops. Returns (xss, yss, test_xss, test_yss, sensors)."""
    import pandas as pd

    datadir = datadir or DEFAULT_DATA_DIR
    sensors = ["bra", "cam", "chi", "sot"]
    holdout = [None, (10.2, 10.8), (13.5, 14.2), None]
    xss, yss, test_xss, test_yss = [], [], [], []
    for sensor, hold in zip(sensors, holdout):
        y = pd.read_csv(
            os.path.join(datadir, "weather", sensor + "y.csv"),
            header=None,
            names=["WSPD", "WD", "GST", "ATMP"],
            usecols=["ATMP"],
        )
        x = pd.read_csv(
            os.path.join(datadir, "weather", sensor + "x.csv"),
            header=None,
            names=["time"],
        )
        y.loc[y["ATMP"] == -1, "ATMP"] = np.nan
        y = y.dropna()
        xy = pd.concat([x, y], axis=1, join="inner")
        if hold is None:
            test_xss.append(np.array([]))
            test_yss.append(np.array([]))
            xss.append(xy["time"].values)
            yss.append(xy["ATMP"].values)
        else:
            sel = xy["time"].between(*hold)
            test_xss.append(xy.loc[sel, "time"].values)
            test_yss.append(xy.loc[sel, "ATMP"].values)
            xss.append(xy.loc[~sel, "time"].values)
            yss.append(xy.loc[~sel, "ATMP"].values)
    return xss, yss, test_xss, test_yss, sensors


def synth(datadir=None):
    """Synthetic D=5, P=2 benchmark; the last output's upper-right
    quadrant is held out. Returns (xss, yss, test_xss, test_yss)."""
    datadir = datadir or DEFAULT_DATA_DIR
    xss = list(np.load(os.path.join(datadir, "synth", "xss.npy")))
    yss = list(np.load(os.path.join(datadir, "synth", "yss.npy")))
    sel = np.all(xss[-1] >= 0.5, axis=1)
    e2 = np.zeros((0, 2))
    test_xss = [e2] * 4 + [xss[-1][sel]]
    test_yss = [np.zeros(0)] * 4 + [np.asarray(yss[-1]).ravel()[sel]]
    xss[-1] = xss[-1][~sel, :]
    yss[-1] = np.asarray(yss[-1]).ravel()[~sel]
    yss[:-1] = [np.asarray(y).ravel() for y in yss[:-1]]
    return xss, yss, test_xss, test_yss


def toy_sinusoid(n=1500, seed=0):
    """2-output sin/-sin toy (parity: standard_tester.py toy_sinusoid)."""
    rng = np.random.default_rng(seed)
    xss = [rng.uniform(-10, 10, size=n) for _ in range(2)]
    yss = [
        np.sin(xss[0]) + rng.standard_normal(n) * 1e-2,
        -np.sin(xss[1]) + rng.standard_normal(n) * 1e-2,
    ]
    return xss, yss
