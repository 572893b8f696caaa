"""
Generic file I/O dispatch by extension (cf. reference
``pisa/utils/fileio.py:486,542``): .json(.bz2), .csv, .pkl, .hdf5/.h5,
.dat/.txt (whitespace tables), .cfg (returns resolved path for the config
parser).
"""

from __future__ import annotations

import bz2
import csv
import os
import pickle

import numpy as np

from pisa_tpu.utils.resources import find_resource

__all__ = ["from_file", "to_file", "expand", "read_csv"]


def expand(path):
    return os.path.expanduser(os.path.expandvars(path))


def from_file(fname, fmt=None, **kwargs):
    """Load a file based on its extension."""
    path = find_resource(fname)
    ext = (fmt or os.path.splitext(path.replace(".bz2", ""))[1][1:]).lower()

    if ext == "json":
        from pisa_tpu.utils.jsons import from_json

        return from_json(path)
    if ext == "csv":
        return read_csv(path)
    if ext in ("pkl", "pckl", "pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext in ("hdf5", "h5", "hdf"):
        from pisa_tpu.utils.hdf import from_hdf

        return from_hdf(path, **kwargs)
    if ext in ("dat", "txt"):
        return np.loadtxt(path, **kwargs)
    raise ValueError(f"Unhandled extension {ext!r} for file {fname!r}")


def read_csv(path):
    """Read a headed CSV table (plain or ``.bz2``) into a dict of column
    name -> 1-D numpy array, in file order. Numeric columns are float64;
    a column that does not parse as numbers is kept as strings."""
    opener = bz2.open if str(path).endswith(".bz2") else open
    with opener(path, "rt", newline="") as f:
        header = next(csv.reader([f.readline()]))
        body = f.read()
    try:
        table = np.loadtxt(
            body.splitlines(), delimiter=",", dtype=np.float64, ndmin=2
        )
        if table.size == 0:
            table = np.empty((0, len(header)))
        return {name: table[:, i] for i, name in enumerate(header)}
    except ValueError:
        rows = list(csv.reader(body.splitlines()))
    columns = list(zip(*rows)) if rows else [()] * len(header)
    out = {}
    for name, col in zip(header, columns):
        try:
            out[name] = np.asarray(col, dtype=np.float64)
        except ValueError:
            out[name] = np.asarray(col)
    return out


def to_file(obj, fname, fmt=None, **kwargs):
    """Write `obj` based on the target extension."""
    path = expand(fname)
    ext = (fmt or os.path.splitext(path.replace(".bz2", ""))[1][1:]).lower()
    if ext == "json":
        from pisa_tpu.utils.jsons import to_json

        return to_json(obj, path, **kwargs)
    if ext == "csv":
        return _write_csv(obj, path)
    if ext in ("pkl", "pckl", "pickle"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=4)
        return None
    if ext in ("hdf5", "h5", "hdf"):
        from pisa_tpu.utils.hdf import to_hdf

        return to_hdf(obj, path, **kwargs)
    raise ValueError(f"Unhandled extension {ext!r} for file {fname!r}")


def _write_csv(columns, path):
    """Write a dict of equal-length 1-D columns as a headed CSV table."""
    names = list(columns)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(names)
        writer.writerows(zip(*(np.asarray(columns[n]) for n in names)))
