"""HP-opt sweep report, the port of the repo's
`scripts/print_plot_hp_opt_results.py`: `python -m
iltpu_torch.analysis.hp_opt_report outputs/all_GAIL/sweep.jsonl`. numpy and
the port only: no pandas, no matplotlib.

It loads the `{trial, params, min_score, method, per_env}` records that
`python -m iltpu_torch.train_all --sweep` writes into iltpu's columns
(`trial`, `min_score`, `method`, then `param:<name>` and `env:<name>` in the
order their keys first appear across the records; a missing entry is
missing), prints the `--top` trials in pandas's order for
`sort_values("min_score", ascending=False)` with each cell as pandas
prints it, and draws iltpu's figure through `iltpu_torch.utils.plotting`:
`min_score` against each parameter in small multiples (`cols = min(n, 4)`,
`rows = ceil(n / cols)`), the unused slots off, and a parallel-coordinates
panel in the last row (each parameter min-max normalised, each trial
coloured by its `min_score` through viridis), `figsize=(3.5 cols, 3 (rows +
1))` at 120 dpi. With no parameter it draws nothing.

Usage:
  python -m iltpu_torch.analysis.hp_opt_report outputs/all_GAIL/sweep.jsonl \\
      [--out hp_opt.png] [--top 10]
"""

import argparse
import json
import math
from typing import Dict, List, Tuple

import numpy as np

from iltpu_torch.utils.plotting import Figure, viridis

DPI = 120
DIGITS = 6  # pandas's display.precision


def load_sweep(path: str) -> Tuple[List[str], List[Dict]]:
    """(columns, rows): each row a dict over every column, None where the
    record lacks the entry."""
    records, columns = [], {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            row = {"trial": rec["trial"], "min_score": rec["min_score"],
                   "method": rec.get("method", "?")}
            row.update({f"param:{k}": v for k, v in rec["params"].items()})
            row.update({f"env:{k}": v for k, v in rec.get("per_env", {}).items()})
            columns.update(dict.fromkeys(row))
            records.append(row)
    columns = list(columns)
    return columns, [{c: r.get(c) for c in columns} for r in records]


def kind(values) -> str:
    """The dtype pandas infers for a column: 'bool' and 'int' without a
    missing entry, 'float' for numbers (a missing one NaN), 'str' for
    strings, else 'object'."""
    present = [v for v in values if v is not None]
    if len(present) == len(values) and all(isinstance(v, bool) for v in present):
        return "bool"
    if any(isinstance(v, bool) for v in present):
        return "object"
    if len(present) == len(values) and all(isinstance(v, int) for v in present):
        return "int"
    if all(isinstance(v, (int, float)) for v in present):
        return "float"
    if all(isinstance(v, str) for v in present):
        return "str"
    return "object"


def floats(values) -> np.ndarray:
    return np.array([np.nan if v is None else float(v) for v in values], np.float64)


def _trim_zeros(cells: List[str]) -> List[str]:
    """pandas's `_trim_zeros_float`: trailing zeros trimmed equally from every
    number with a decimal point, one digit after the point kept."""
    def decimal(x):
        return "." in x and x.lstrip(" +-").replace(".", "", 1).isdigit()

    while any(decimal(x) for x in cells) and all(x.endswith("0") for x in cells if decimal(x)):
        cells = [x[:-1] if decimal(x) else x for x in cells]
    return [x + "0" if decimal(x) and x.endswith(".") else x for x in cells]


def float_cells(v: np.ndarray) -> List[str]:
    """pandas's fixed-width float cells: 6 decimals, trimmed, a space for
    the sign; scientific where a value would show as 0 or a long column
    holds one above 1e6."""
    def fmt(spec):
        return _trim_zeros(["NaN" if np.isnan(x) else format(x, spec) for x in v])

    cells = fmt(f" .{DIGITS}f")
    a = np.abs(v[~np.isnan(v)])
    too_long = bool(cells) and max(len(c) for c in cells) > DIGITS + 6
    if ((a < 10.0 ** -DIGITS) & (a > 0)).any() or (too_long and (a > 1e6).any()):
        cells = fmt(f" .{DIGITS}e")
    return cells


def cells(values, column_kind: str) -> List[str]:
    """A column's printed cells, as pandas's `to_string`."""
    if column_kind == "float":
        return float_cells(floats(values))
    if column_kind == "int":
        return [format(v, " d") for v in values]
    return ["NaN" if v is None else str(v) for v in values]


def rank(rows: List[Dict]) -> List[int]:
    """pandas's `sort_values("min_score", ascending=False)` order
    (`nargsort`): reverse, numpy's default argsort, reverse; NaN last."""
    score = floats([r["min_score"] for r in rows])
    idx = np.arange(len(rows))
    nan = np.isnan(score)
    order = idx[~nan][::-1][np.argsort(score[~nan][::-1], kind="quicksort")][::-1]
    return [int(i) for i in np.concatenate([order, idx[nan]])]


def table(columns: List[str], rows: List[Dict], top: int) -> str:
    """The `top` rows as pandas's `to_string(index=False)`: each column's
    dtype from every row, its cells formatted over the rows shown, a
    numeric column's header led by a space, right-justified."""
    out = []
    for c in columns:
        column_kind = kind([r[c] for r in rows])
        head = (" " if column_kind in ("bool", "int", "float") else "") + c
        shown = cells([r[c] for r in rows[:top]], column_kind)
        width = max([len(head)] + [len(s) for s in shown])
        out.append([head.rjust(width)] + [s.rjust(width) for s in shown])
    return "\n".join(" ".join(line) for line in zip(*out))


def numeric(values) -> np.ndarray:
    """iltpu's `_numeric`: the floats of a column that converts (bools 0/1,
    missing NaN); else the codes of its sorted distinct strings (a missing
    entry -1 in a string column, 'nan' in any other)."""
    try:
        return floats(values)
    except (ValueError, TypeError):
        pass
    if kind(values) == "str":
        present = [v for v in values if v is not None]
        uniq = sorted(set(present))
        return np.array([-1.0 if v is None else float(uniq.index(v)) for v in values])
    strs = ["nan" if v is None else str(v) for v in values]
    return np.unique(strs, return_inverse=True)[1].astype(float)


def parallel_coordinates(columns: Dict[str, list], score: np.ndarray):
    """The last panel's numbers: (trials, params) of each parameter min-max
    normalised (0 where it is constant), and each trial's colour position
    (score - min) / (max - min), 0.5 for all where the scores are equal."""
    norm = []
    for values in columns.values():
        v = numeric(values)
        lo, hi = np.nanmin(v), np.nanmax(v)
        norm.append((v - lo) / (hi - lo) if hi > lo else np.zeros_like(v))
    s_lo, s_hi = score.min(), score.max()
    where = (score - s_lo) / (s_hi - s_lo) if s_hi > s_lo else np.full_like(score, 0.5)
    return np.stack(norm, axis=1), where


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("sweep", help="path to sweep.jsonl")
    p.add_argument("--out", default="hp_opt.png")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    columns, rows = load_sweep(args.sweep)
    ranked = [rows[i] for i in rank(rows)]
    print(table(columns, ranked, args.top))

    params = [c for c in columns if c.startswith("param:")]
    plot(rows, params, args.out)
    return columns, ranked


def plot(rows: List[Dict], params: List[str], out: str):
    n = len(params)
    if n == 0:
        return
    cols = min(n, 4)
    grid_rows = math.ceil(n / cols)
    fig = Figure(3.5 * cols, 3 * (grid_rows + 1), DPI)
    axes = fig.grid(grid_rows + 1, cols)
    score = floats([r["min_score"] for r in rows])
    values = {param: [r[param] for r in rows] for param in params}
    # small multiples: the objective against each parameter
    for i, param in enumerate(params):
        ax = axes[i // cols][i % cols]
        ax.scatter(numeric(values[param]), score, s=14, alpha=0.7)
        ax.set_xlabel(param.removeprefix("param:"))
        ax.set_ylabel("min score")
    for i in range(n, grid_rows * cols):
        axes[i // cols][i % cols].axis("off")
    # parallel coordinates across every parameter, coloured by the objective
    ax = axes[grid_rows][0]
    for j in range(1, cols):
        axes[grid_rows][j].axis("off")
    mat, where = parallel_coordinates(values, score)
    for t, color in enumerate(viridis(where)):
        ax.plot(range(n), mat[t], color=color, alpha=0.6, lw=1)
    ax.set_xticks(range(n), [param.removeprefix("param:") for param in params])
    ax.set_title("parallel coordinates (color = min score)")
    fig.save(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
