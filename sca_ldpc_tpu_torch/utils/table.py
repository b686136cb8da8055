"""Tables of records without pandas: the rows a ``DataFrame`` would hold,
written to CSV byte for byte as ``DataFrame.to_csv(index=False)`` writes
them, appended with the header only when the file is new.

A table is ``(columns, rows)``: column names and a list of rows, each a list
of values in column order.  Each column is formatted as pandas formats the
dtype it would infer for it: all bools -> ``True``/``False``; all integers
-> ``int``; numbers with a float (or a missing value among numbers) ->
``float64``, written with ``repr`` (``1.0``, ``1e-05``), missing as empty;
anything else -> object, each value with ``str``, a missing one empty.  Fields are
quoted as the ``csv`` module's minimal quoting does, lines end in ``\\n``.
"""

import csv
import io
import math
import numbers
import os

import numpy as np


def table(records, columns=None):
    """``(columns, rows)`` of a list of dicts, as ``pandas.DataFrame(records)``
    orders them: the keys in first-seen order, a missing key ``None``."""
    if columns is None:
        columns = []
        for rec in records:
            columns.extend(k for k in rec if k not in columns)
    return list(columns), [[rec.get(c) for c in columns] for rec in records]


def with_columns(tab, **values):
    """The table with constant columns set (``df[name] = value``): an
    existing column is overwritten in place, a new one appended."""
    columns, rows = list(tab[0]), [list(r) for r in tab[1]]
    for name, value in values.items():
        if name in columns:
            i = columns.index(name)
            for r in rows:
                r[i] = value
        else:
            columns.append(name)
            for r in rows:
                r.append(value)
    return columns, rows


def _missing(v):
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_bool(v):
    return isinstance(v, (bool, np.bool_))


def _is_int(v):
    return isinstance(v, numbers.Integral) and not _is_bool(v)


def _is_number(v):
    return isinstance(v, numbers.Real) and not _is_bool(v)


def _column_formatter(values):
    present = [v for v in values if not _missing(v)]
    if present and len(present) == len(values) and all(_is_bool(v) for v in values):
        return lambda v: str(bool(v))
    if present and len(present) == len(values) and all(_is_int(v) for v in values):
        return lambda v: str(int(v))
    if present and all(_is_number(v) for v in present):
        return lambda v: "" if _missing(v) else repr(float(v))
    return lambda v: "" if _missing(v) else str(v)


def formatted(tab):
    """The table's values as the strings ``to_csv`` writes."""
    columns, rows = tab
    fmts = [_column_formatter([r[i] for r in rows]) for i in range(len(columns))]
    return [[f(v) for f, v in zip(fmts, r)] for r in rows]


def csv_text(tab, header=True):
    """What ``DataFrame.to_csv(index=False, header=header)`` returns."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    if header:
        writer.writerow(tab[0])
    writer.writerows(formatted(tab))
    return buf.getvalue()


def append_csv(path, tab):
    """Append the table to the CSV at ``path``, with the header only when the
    file is new (the JAX package's ``df.to_csv(path, mode="w" if header else
    "a", index=False, header=header)``)."""
    header = not os.path.exists(path)
    with open(path, "w" if header else "a", newline="") as f:
        f.write(csv_text(tab, header=header))


def text_table(tab):
    """The table as right-aligned text columns, for a log line."""
    columns, _rows = tab
    cells = [list(columns)] + formatted(tab)
    widths = [max(len(r[i]) for r in cells) for i in range(len(columns))]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(r, widths)) for r in cells)


def drop_config_rows(path, label, weight):
    """Drop the rows of one sweep config (``label`` as text, ``weight`` as a
    number) from the CSV at ``path``; the other lines stay as they were.
    Returns the number of rows dropped."""
    if not os.path.exists(path):
        return 0
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    if not lines:
        return 0
    head, rows = lines[0], lines[1:]
    i_label, i_weight = head.index("label"), head.index("weight")

    def number(text):
        try:
            return float(text)
        except ValueError:
            return None

    keep = [r for r in rows if not (r[i_label] == str(label) and number(r[i_weight]) == weight)]
    if len(keep) == len(rows):
        return 0
    buf = io.StringIO()
    csv.writer(buf, lineterminator="\n").writerows([head] + keep)
    with open(path, "w", newline="") as f:
        f.write(buf.getvalue())
    return len(rows) - len(keep)
