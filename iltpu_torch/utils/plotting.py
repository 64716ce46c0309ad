"""Metric line plots without matplotlib: the port's `lineplot` of
`iltpu/utils/plotting.py`, which the card's machine cannot run.

`lineplot(x, y, filename)` writes `<filename>.png` at iltpu's size (a 6 x 4
inch figure at 100 dpi: 600 x 400 RGBA, white): the mean of each `y[i]` as
a `#1f77b4` line 2 px wide over a +-1 (population) std band in the same
colour at alpha 0.3, an axes frame with about 5 ticks on round numbers
each way, tick labels, both axis labels and the title, in a 5 x 7 ASCII
bitmap font kept here (no font file). The PNG is the signature, `IHDR`,
one `IDAT` (`zlib`, filter type 0 on each row) and `IEND`. Rasterising is
numpy array work; nothing loops over pixels. `Figure` (below) holds a grid
of axes for the seed-sweep and HP-opt reports (`iltpu_torch/analysis/`).
"""

import math
import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

WIDTH, HEIGHT = 600, 400  # iltpu's figsize=(6, 4) at dpi=100
LEFT, RIGHT, TOP, BOTTOM = 80, 585, 40, 345  # the axes' box in pixels (rows grow down)
BLUE = np.array([0x1F, 0x77, 0xB4], np.uint8)
BAND = np.round(0.3 * BLUE + 0.7 * 255.0).astype(np.uint8)  # alpha 0.3 over white
INK = np.array([0, 0, 0], np.uint8)
MARGIN = 0.05  # matplotlib's default data margins
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# A 5 x 7 font for ASCII 32-126, in order: each glyph 7 rows of 5 bits (bit
# 4 the leftmost pixel), two hex digits a row.
_GLYPHS = """
00000000000000 04040404040004 0A0A0A00000000 0A0A1F0A1F0A0A 040F140E051E04 18190204081303
0C12140815120D 0C040800000000 02040808080402 08040202020408 0004150E150400 0004041F040400
000000000C0408 0000001F000000 00000000000C0C 00010204081000 0E11131519110E 040C040404040E
0E11010204081F 1F02040201110E 02060A121F0202 1F101E0101110E 0608101E11110E 1F010204080808
0E11110E11110E 0E11110F01020C 000C0C000C0C00 000C0C000C0408 02040810080402 00001F001F0000
08040201020408 0E110102040004 0E11010D15150E 0E1111111F1111 1E11111E11111E 0E11101010110E
1C12111111121C 1F10101E10101F 1F10101E101010 0E11101711110F 1111111F111111 0E04040404040E
0702020202120C 11121418141211 1010101010101F 111B1515111111 11111915131111 0E11111111110E
1E11111E101010 0E11111115120D 1E11111E141211 0F10100E01011E 1F040404040404 1111111111110E
11111111110A04 1111111515150A 11110A040A1111 1111110A040404 1F01020408101F 0E08080808080E
00100804020100 0E02020202020E 040A1100000000 0000000000001F 08040200000000 00000E010F110F
1010161911111E 00000E1010110E 01010D1311110F 00000E111F100E 0609081C080808 000F11110F010E
10101619111111 04000C0404040E 0200060202120C 10101214181412 0C04040404040E 00001A15151111
00001619111111 00000E1111110E 00001E111E1010 00000D130F0101 00001619101010 00000E100E011E
08081C08080906 0000111111130D 00001111110A04 0000111115150A 0000110A040A11 000011110F010E
00001F0204081F 02040408040402 04040404040404 08040402040408 00000815020000
""".split()
# (95, 7, 5): glyph, row, column
FONT = (np.array([[int(g[2 * r:2 * r + 2], 16) for r in range(7)] for g in _GLYPHS])[..., None]
        >> np.arange(4, -1, -1)) & 1


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """`text` in the bitmap font: a boolean (7 scale, 6 scale len - scale)
    mask, one blank column between glyphs; characters outside ASCII 32-126
    draw as '?'."""
    codes = np.array([ord(c) - 32 if 32 <= ord(c) < 127 else ord("?") - 32 for c in text], int)
    glyphs = np.pad(FONT[codes], ((0, 0), (0, 0), (0, 1)))  # (n, 7, 6)
    mask = glyphs.transpose(1, 0, 2).reshape(7, -1)[:, :-1].astype(bool)
    return np.kron(mask, np.ones((scale, scale), bool)) if scale > 1 else mask


def _stamp(img: np.ndarray, mask: np.ndarray, row: int, col: int, color) -> None:
    """Paint `mask` with its top-left corner at (row, col), clipped to the image."""
    r0, c0 = max(row, 0), max(col, 0)
    r1, c1 = min(row + mask.shape[0], img.shape[0]), min(col + mask.shape[1], img.shape[1])
    if r0 < r1 and c0 < c1:
        img[r0:r1, c0:c1][mask[r0 - row:r1 - row, c0 - col:c1 - col]] = color


def draw_text(img, text: str, row: float, col: float, scale: int = 1, anchor: str = "cc",
              vertical: bool = False, color=INK) -> None:
    """Draw `text` anchored at (row, col): `anchor` is two letters, the row's
    (t top, c centre, b bottom) and the column's (l left, c centre, r right);
    `vertical` turns it a quarter to read upwards, as a y label."""
    if not text:
        return
    mask = text_mask(text, scale)
    if vertical:
        mask = np.rot90(mask)
    h, w = mask.shape
    dr = {"t": 0, "c": h // 2, "b": h}[anchor[0]]
    dc = {"l": 0, "c": w // 2, "r": w}[anchor[1]]
    _stamp(img, mask, int(round(row)) - dr, int(round(col)) - dc, color)


def nice_ticks(lo: float, hi: float) -> Tuple[np.ndarray, float]:
    """About 5 ticks in [lo, hi] on multiples of 1, 2, 2.5 or 5 x 10^k,
    and their step."""
    raw = (hi - lo) / 5
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw * (1 - 1e-9))
    k = np.arange(math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9) + 1)
    return k * step + 0.0, step  # + 0.0: no -0


def tick_label(v: float, step: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e6 or step < 1e-4:
        return f"{v:.3g}"
    decimals = max(0, -math.floor(math.log10(step) + 1e-9))
    if round(step / 10.0 ** -decimals, 6) % 1:  # 2.5 x 10^k
        decimals += 1
    return f"{v:.{decimals}f}"


def _limits(lo: float, hi: float) -> Tuple[float, float]:
    """The data range with matplotlib's 5% margins; a single value widened."""
    if hi - lo <= 1e-12 * max(abs(lo), abs(hi), 1e-300):
        d = 0.1 * abs(lo) if lo else 1.0
        return lo - d, hi + d
    pad = MARGIN * (hi - lo)
    return lo - pad, hi + pad


class Axes:
    """The data -> pixel transform of one plot: x over [LEFT, RIGHT], y over
    [TOP, BOTTOM] upside down; pixel (row r, column c) covers
    [r, r + 1) x [c, c + 1)."""

    def __init__(self, x: np.ndarray, lower: np.ndarray, upper: np.ndarray):
        if x.size:
            self.x = _limits(float(x.min()), float(x.max()))
            self.y = _limits(float(min(lower.min(), upper.min())), float(max(lower.max(), upper.max())))
        else:
            self.x = self.y = (0.0, 1.0)

    def col(self, x):
        return LEFT + (np.asarray(x, np.float64) - self.x[0]) / (self.x[1] - self.x[0]) * (RIGHT - LEFT)

    def row(self, y):
        return BOTTOM - (np.asarray(y, np.float64) - self.y[0]) / (self.y[1] - self.y[0]) * (BOTTOM - TOP)

    def x_of(self, col):
        return self.x[0] + (np.asarray(col, np.float64) - LEFT) / (RIGHT - LEFT) * (self.x[1] - self.x[0])


def statistics(x: Sequence[float], y: List[Sequence[float]]):
    """iltpu's float64 means and population stds of each y[i], with x, the
    points where all three are finite."""
    x = np.asarray(x, np.float64)
    means = np.asarray([np.mean(v) for v in y], np.float64)
    stds = np.asarray([np.std(v) for v in y], np.float64)
    ok = np.isfinite(x) & np.isfinite(means) & np.isfinite(stds)
    return x[ok], means[ok], stds[ok]


def axes_for(x: Sequence[float], y: List[Sequence[float]]) -> Axes:
    """The transform `lineplot(x, y, ...)` draws with."""
    x, m, s = statistics(x, y)
    return Axes(x, m - s, m + s)


def _band(img, ax: Axes, x, lower, upper) -> None:
    """The band between `lower` and `upper`, linear between the points: in
    every pixel column from the first x to the last, the rows from the one
    holding the upper edge to the one holding the lower, blended at alpha 0.3."""
    order = np.argsort(x, kind="stable")
    x, lower, upper = x[order], lower[order], upper[order]
    c0, c1 = ax.col(x[0]), ax.col(x[-1])
    cols = np.arange(int(math.floor(c0)), int(math.floor(c1)) + 1)
    centres = np.clip(ax.x_of(cols + 0.5), x[0], x[-1])
    top, bottom = ax.row(np.interp(centres, x, upper)), ax.row(np.interp(centres, x, lower))
    rows = np.arange(TOP, BOTTOM)[:, None]
    inside = (rows >= np.floor(top)) & (rows <= np.floor(bottom))
    img[TOP:BOTTOM, cols[0]:cols[-1] + 1][inside] = BAND


def _polyline(img, ax: Axes, x, y) -> None:
    """The line through the points, 2 px wide: each segment sampled at
    least once a pixel, each sample painting the 2 x 2 pixels nearest it."""
    c, r = ax.col(x), ax.row(y)
    dc, dr = np.diff(c), np.diff(r)
    n = np.ceil(np.maximum(np.abs(dc), np.abs(dr))).astype(int) + 1  # samples a segment
    seg = np.repeat(np.arange(len(dc)), n)
    t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(np.maximum(n - 1, 1), n)
    cs = np.concatenate([c[seg] + t * dc[seg], c[-1:]])
    rs = np.concatenate([r[seg] + t * dr[seg], r[-1:]])
    cc = np.floor(cs - 0.5).astype(int)[:, None] + np.array([0, 1, 0, 1])
    rr = np.floor(rs - 0.5).astype(int)[:, None] + np.array([0, 0, 1, 1])
    keep = (cc >= LEFT) & (cc < RIGHT) & (rr >= TOP) & (rr < BOTTOM)
    img[rr[keep], cc[keep]] = BLUE


def _frame(img, ax: Axes, xaxis: str, yaxis: str, title: str) -> None:
    """The axes' frame, ticks outward with their labels, the labels, the title."""
    img[TOP, LEFT:RIGHT + 1] = img[BOTTOM, LEFT:RIGHT + 1] = INK
    img[TOP:BOTTOM + 1, LEFT] = img[TOP:BOTTOM + 1, RIGHT] = INK
    ticks, step = nice_ticks(*ax.x)
    for v, c in zip(ticks, np.round(ax.col(ticks)).astype(int)):
        img[BOTTOM + 1:BOTTOM + 5, c] = INK
        draw_text(img, tick_label(v, step), BOTTOM + 7, c, anchor="tc")
    ticks, step = nice_ticks(*ax.y)
    for v, r in zip(ticks, np.round(ax.row(ticks)).astype(int)):
        img[r, LEFT - 4:LEFT] = INK
        draw_text(img, tick_label(v, step), r, LEFT - 7, anchor="cr")
    draw_text(img, xaxis, HEIGHT - 12, (LEFT + RIGHT) / 2, scale=2, anchor="bc")
    draw_text(img, yaxis, (TOP + BOTTOM) / 2, 6, scale=2, anchor="cl", vertical=True)
    draw_text(img, title, TOP - 10, (LEFT + RIGHT) / 2, scale=2, anchor="bc")


def png_bytes(rgba: np.ndarray) -> bytes:
    """An 8-bit RGBA image (rows, columns, 4) as PNG: one IDAT, filter type 0."""
    h, w, _ = rgba.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, -1)], axis=1)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def render(x: Sequence[float], y: List[Sequence[float]], xaxis: str = "Steps",
           yaxis: str = "Returns", title: str = "") -> np.ndarray:
    """The plot as a (400, 600, 4) uint8 RGBA array."""
    x, m, s = statistics(x, y)
    ax = Axes(x, m - s, m + s)
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    if x.size:
        _band(img, ax, x, m - s, m + s)
        _polyline(img, ax, x, m)
    _frame(img, ax, xaxis, yaxis, title)
    return np.concatenate([img, np.full((HEIGHT, WIDTH, 1), 255, np.uint8)], axis=2)


def lineplot(
    x: Sequence[float],
    y: List[Sequence[float]],
    filename: str,
    xaxis: str = "Steps",
    yaxis: str = "Returns",
    title: str = "",
):
    """y is a list (per x) of per-episode/per-batch value lists; writes
    `<filename>.png` with their mean and a +-1 std band, as iltpu's."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(f"{filename}.png", "wb") as f:
        f.write(png_bytes(render(x, y, xaxis, yaxis, title)))


# ------------------------------------------------------------------ figures
# A figure of a given size holding a grid of axes, for the reports, the
# results matrix and the run diagnostics (`iltpu_torch/analysis/`), in place
# of matplotlib's `plt.subplots(rows, cols, figsize=(w, h))` and
# `savefig(..., dpi=dpi)`.
# The canvas is round(w dpi) x round(h dpi) pixels, as matplotlib's without
# `bbox_inches`. Each slot of the grid is an axes (`Panel`) with its own data
# limits (the data's range with 5% margins), ticks, tick labels, title,
# axis labels and legend. Series draw in matplotlib's order: the bands and
# the scatter points under the lines, each group in call order. Lines take
# the axes' line colour cycle (matplotlib's default ten colours) and bands
# and scatter points its patch cycle, as matplotlib's. Tick labels are drawn
# horizontally where matplotlib would rotate them (the odd ones a line lower).
# Pixels are not matplotlib's; the size and the numbers drawn are.

CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")  # matplotlib's default colour cycle
# viridis at 0, 1/4, 1/2, 3/4 and 1, interpolated linearly between (matplotlib's
# table has 256 entries; these five are its samples at those points)
VIRIDIS = ("#440154", "#3b528b", "#21918c", "#5ec962", "#fde725")
# a slot's margins around its axes' frame, in pixels: tick labels and the y
# label on the left, the title above, tick labels and the x label below
SLOT_LEFT, SLOT_RIGHT, SLOT_TOP, SLOT_BOTTOM = 64, 14, 24, 44


def rgb(color) -> np.ndarray:
    """A '#rrggbb' colour (or an RGB triple of 0-255) as uint8 RGB."""
    if isinstance(color, str):
        return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)
    return np.asarray(color, np.uint8)


def viridis(v) -> np.ndarray:
    """Colours of values in [0, 1] (clipped): (n, 3) uint8, linear between
    the five samples of `VIRIDIS`."""
    v = np.clip(np.atleast_1d(np.asarray(v, np.float64)), 0.0, 1.0)
    anchors = np.stack([rgb(c) for c in VIRIDIS]).astype(np.float64)
    at = np.linspace(0.0, 1.0, len(VIRIDIS))
    return np.round(np.stack([np.interp(v, at, anchors[:, k]) for k in range(3)], -1)).astype(np.uint8)


def _blend(img, rows, cols, color, alpha, times=None) -> None:
    """Paint `color` at alpha `alpha` over the pixels (rows, cols), each
    `times` times over (a pixel covered by k overlapping marks of one colour)."""
    a = 1.0 - (1.0 - alpha) ** (1 if times is None else np.asarray(times, np.float64)[:, None])
    under = img[rows, cols].astype(np.float64)
    img[rows, cols] = np.round(a * color + (1.0 - a) * under).astype(np.uint8)




# matplotlib's dash patterns, in units of the line's width: (on, off)
DASHES = {"--": (3.7, 1.6), ":": (1.0, 1.65)}


def _dashed(arc, ls: str, lw: float) -> np.ndarray:
    """Which samples at arc lengths `arc` (pixels along the line) a line of
    style `ls` ('-', '--' or ':') and width `lw` pixels paints."""
    if ls == "-":
        return np.ones(np.shape(arc), bool)
    on, off = (v * lw for v in DASHES[ls])
    # a sample paints lw pixels along the line: its dashes start lw - 1 shorter
    return np.mod(arc, on + off) < max(1.0, on - (lw - 1))


def _margins(lo: float, hi: float, log: bool) -> Tuple[float, float]:
    """`_limits` in the scale's own space (log10 for a log scale)."""
    if not log:
        return _limits(lo, hi)
    a, b = _limits(math.log10(lo), math.log10(hi))
    return 10.0 ** a, 10.0 ** b


def log_ticks(lo: float, hi: float) -> Tuple[np.ndarray, List[str]]:
    """A log axis's ticks: the powers of ten in [lo, hi] (where fewer than
    two, about 5 linear ticks) and their labels."""
    k = np.arange(math.ceil(math.log10(lo) - 1e-9), math.floor(math.log10(hi) + 1e-9) + 1)
    if len(k) >= 2:
        return 10.0 ** k, [f"1e{int(e)}" for e in k]
    ticks, step = nice_ticks(lo, hi)
    ticks = ticks[ticks > 0]
    return ticks, [tick_label(v, step) for v in ticks]


class Panel:
    """One axes of a `Figure`: its frame spans pixel columns [left, right]
    and rows [top, bottom]; x grows rightwards and y upwards (linear, or
    log10 with `set_yscale("log")`) over the data limits, which are fixed
    when the figure is drawn: `set_xlim`/`set_ylim` where given, else the
    data's range with 5% margins (over every panel sharing y with this one,
    `Figure.grid(sharey=...)`). Pixel (row r, column c) covers
    [r, r + 1) x [c, c + 1)."""

    def __init__(self, top: int, left: int, bottom: int, right: int, dpi: int = 100):
        self.top, self.left, self.bottom, self.right, self.dpi = top, left, bottom, right, dpi
        self.lines, self.fills, self.points, self.hlines, self.texts = [], [], [], [], []
        self.title = self.xlabel = self.ylabel = ""
        self.xticks = self.xticklabels = None
        self.show_legend, self.visible, self.grid_color = False, True, None
        self.xlim = self.ylim = None
        self.yscale = "linear"
        self.x = self.y = (0.0, 1.0)
        self._line_color = self._patch_color = 0

    def _next(self, kind: str, color):
        if color is not None:
            return rgb(color)
        attr = f"_{kind}_color"
        i = getattr(self, attr)
        setattr(self, attr, i + 1)
        return rgb(CYCLE[i % len(CYCLE)])

    def plot(self, x, y, color=None, alpha=1.0, lw=2, label=None, ls="-") -> None:
        """A line through (x, y), `lw` pixels wide, solid ('-'), dashed ('--')
        or dotted (':'); a non-finite point breaks it (a point with no finite
        neighbour draws nothing, as in matplotlib)."""
        self.lines.append((np.asarray(x, np.float64), np.asarray(y, np.float64),
                           self._next("line", color), alpha, lw, label, ls))

    def axhline(self, y: float, color, lw=1, ls="-") -> None:
        """A horizontal line at y across the axes, under the data."""
        self.hlines.append((float(y), rgb(color), lw, ls))

    def fill_between(self, x, lower, upper, alpha=0.2, color=None) -> None:
        """The band between `lower` and `upper` over x, linear between the points."""
        self.fills.append((np.asarray(x, np.float64), np.asarray(lower, np.float64),
                           np.asarray(upper, np.float64), self._next("patch", color), alpha))

    def scatter(self, x, y, s=14, alpha=0.7, color=None) -> None:
        """Disks of area `s` points^2 (a diameter of sqrt(s) / 72 inch)."""
        self.points.append((np.asarray(x, np.float64), np.asarray(y, np.float64),
                            self._next("patch", color), alpha, math.sqrt(s) / 72 * self.dpi / 2))

    def text(self, x: float, y: float, text: str, ha: str = "left", va: str = "bottom",
             color=INK) -> None:
        """`text` (lines split at newlines) at (x, y) in axes coordinates
        ((0, 0) the frame's lower left, (1, 1) its upper right), aligned by
        `ha` (left, center, right) and `va` (bottom, center, top)."""
        self.texts.append((x, y, text, ha, va, rgb(color)))

    def set_title(self, text: str) -> None:
        self.title = text

    def set_xlabel(self, text: str) -> None:
        self.xlabel = text

    def set_ylabel(self, text: str) -> None:
        self.ylabel = text

    def set_xlim(self, lo: float, hi: float) -> None:
        self.xlim = (float(lo), float(hi))

    def set_ylim(self, lo: float, hi: float) -> None:
        self.ylim = (float(lo), float(hi))

    def set_yscale(self, scale: str) -> None:
        """'linear' or 'log' (limits (1, 10) until data or `set_ylim` fix them)."""
        assert scale in ("linear", "log"), scale
        self.yscale = scale
        if scale == "log":
            self.y = (1.0, 10.0)

    def grid(self, color="#e8e6dc") -> None:
        """Grid lines at the ticks, under the data."""
        self.grid_color = rgb(color)

    def set_xticks(self, ticks, labels=None) -> None:
        self.xticks = np.asarray(ticks, np.float64)
        self.xticklabels = None if labels is None else [str(t) for t in labels]

    def legend(self) -> None:
        self.show_legend = True

    def axis(self, mode: str) -> None:
        assert mode == "off", mode
        self.visible = False

    def extent(self) -> Tuple[np.ndarray, np.ndarray]:
        """The x and y values the data limits cover: every series' finite
        points (positive y only on a log scale) and the horizontal lines' y."""
        xs, ys = [], []
        for x, y, *_ in self.lines + self.points:
            ok = np.isfinite(x) & np.isfinite(y)
            xs.append(x[ok])
            ys.append(y[ok])
        for x, lo, hi, *_ in self.fills:
            ok = np.isfinite(x) & np.isfinite(lo) & np.isfinite(hi)
            xs.append(x[ok])
            ys += [lo[ok], hi[ok]]
        ys.append(np.array([h[0] for h in self.hlines]))
        x, y = np.concatenate(xs or [np.zeros(0)]), np.concatenate(ys)
        return x, (y[y > 0] if self.yscale == "log" else y)

    def autoscale(self, ys=None) -> None:
        """Fix the data limits: the set ones, else the extent's (in y, `ys`
        where given: a shared range) with 5% margins."""
        x, own = self.extent()
        y = own if ys is None else ys
        if self.xlim:
            self.x = self.xlim
        elif x.size:
            self.x = _limits(float(x.min()), float(x.max()))
        if self.ylim:
            self.y = self.ylim
        elif y.size:
            self.y = _margins(float(y.min()), float(y.max()), self.yscale == "log")

    def _fy(self, y):
        y = np.asarray(y, np.float64)
        if self.yscale != "log":
            return y
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)), np.nan)

    def col(self, x):
        return self.left + (np.asarray(x, np.float64) - self.x[0]) / (self.x[1] - self.x[0]) * (
            self.right - self.left)

    def row(self, y):
        lo, hi = self._fy(self.y)
        return self.bottom - (self._fy(y) - lo) / (hi - lo) * (self.bottom - self.top)

    def x_of(self, col):
        return self.x[0] + (np.asarray(col, np.float64) - self.left) / (self.right - self.left) * (
            self.x[1] - self.x[0])

    def _inside(self, rr, cc):
        return (rr > self.top) & (rr < self.bottom) & (cc > self.left) & (cc < self.right)

    def _fill(self, img, x, lower, upper, color, alpha) -> None:
        ok = np.isfinite(x) & np.isfinite(lower) & np.isfinite(upper)
        order = np.argsort(x[ok], kind="stable")
        x, lower, upper = x[ok][order], lower[ok][order], upper[ok][order]
        if not x.size:
            return
        cols = np.arange(int(math.floor(self.col(x[0]))), int(math.floor(self.col(x[-1]))) + 1)
        centres = np.clip(self.x_of(cols + 0.5), x[0], x[-1])
        hi, lo = self.row(np.interp(centres, x, upper)), self.row(np.interp(centres, x, lower))
        rows = np.arange(self.top + 1, self.bottom)[:, None]
        inside = (rows >= np.floor(np.minimum(hi, lo))) & (rows <= np.floor(np.maximum(hi, lo)))
        rr, cc = np.nonzero(inside & self._inside(rows, cols[None, :]))
        _blend(img, rows[rr, 0], cols[cc], color, alpha)

    def _line(self, img, x, y, color, alpha, lw, ls="-") -> None:
        c, r = self.col(x), self.row(y)
        ok = np.isfinite(c[:-1]) & np.isfinite(r[:-1]) & np.isfinite(c[1:]) & np.isfinite(r[1:])
        seg = np.flatnonzero(ok)
        dc, dr = c[seg + 1] - c[seg], r[seg + 1] - r[seg]
        n = np.ceil(np.maximum(np.abs(dc), np.abs(dr))).astype(int) + 1  # samples a segment
        k = np.repeat(np.arange(len(seg)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(np.maximum(n - 1, 1), n)
        cs, rs = c[seg][k] + t * dc[k], r[seg][k] + t * dr[k]
        length = np.hypot(dc, dr)
        on = _dashed((np.cumsum(length) - length)[k] + t * length[k], ls, lw)  # the pattern runs on
        cs, rs = cs[on], rs[on]
        off = np.stack(np.meshgrid(np.arange(lw), np.arange(lw)), -1).reshape(-1, 2)
        cc = (np.floor(cs - (lw - 1) / 2).astype(int)[:, None] + off[:, 0]).ravel()
        rr = (np.floor(rs - (lw - 1) / 2).astype(int)[:, None] + off[:, 1]).ravel()
        keep = self._inside(rr, cc)
        flat = np.unique(rr[keep] * img.shape[1] + cc[keep])
        _blend(img, flat // img.shape[1], flat % img.shape[1], color, alpha)

    def _disks(self, img, x, y, color, alpha, radius) -> None:
        ok = np.isfinite(x) & np.isfinite(y)
        c, r = self.col(x[ok]), self.row(y[ok])
        span = np.arange(-math.ceil(radius), math.ceil(radius) + 1)
        dr, dc = [a.ravel() for a in np.meshgrid(span, span, indexing="ij")]
        rr = np.floor(r).astype(int)[:, None] + dr
        cc = np.floor(c).astype(int)[:, None] + dc
        near = (rr + 0.5 - r[:, None]) ** 2 + (cc + 0.5 - c[:, None]) ** 2 <= radius ** 2
        keep = near & self._inside(rr, cc)
        flat, times = np.unique(rr[keep] * img.shape[1] + cc[keep], return_counts=True)
        _blend(img, flat // img.shape[1], flat % img.shape[1], color, alpha, times)

    def ticks(self):
        """((x ticks, their labels), (y ticks, their labels)) inside the limits."""
        if self.xticks is None:
            xt, step = nice_ticks(*self.x)
            xl = [tick_label(v, step) for v in xt]
        else:
            keep = (self.xticks >= self.x[0]) & (self.xticks <= self.x[1])
            xt = self.xticks[keep]
            xl = [lab for lab, k in zip(self.xticklabels or [f"{v:g}" for v in self.xticks], keep) if k]
        if self.yscale == "log":
            yt, yl = log_ticks(*self.y)
        else:
            yt, step = nice_ticks(*self.y)
            yl = [tick_label(v, step) for v in yt]
        return (xt, xl), (yt, yl)

    def draw(self, img) -> None:
        """Draw the panel; its limits are fixed first unless the figure fixed them."""
        if not self.visible:
            return
        t, l, b, r = self.top, self.left, self.bottom, self.right
        (xt, xl), (yt, yl) = self.ticks()
        xc, yr = np.round(self.col(xt)).astype(int), np.round(self.row(yt)).astype(int)
        if self.grid_color is not None:
            img[t + 1:b, xc[(xc > l) & (xc < r)]] = self.grid_color
            img[yr[(yr > t) & (yr < b)], l + 1:r] = self.grid_color
        for y, color, lw, ls in self.hlines:
            self._line(img, np.array(self.x), np.array([y, y]), color, 1.0, lw, ls)
        for f in self.fills:
            self._fill(img, *f)
        for p in self.points:
            self._disks(img, *p)
        for x, y, color, alpha, lw, _, ls in self.lines:
            self._line(img, x, y, color, alpha, lw, ls)
        img[t, l:r + 1] = img[b, l:r + 1] = INK
        img[t:b + 1, l] = img[t:b + 1, r] = INK
        for i, (c, lab) in enumerate(zip(xc, xl)):
            img[b + 1:b + 5, c] = INK
            draw_text(img, lab, b + 7 + (9 * (i % 2) if self.xticklabels else 0), c, anchor="tc")
        for rr, lab in zip(yr, yl):
            img[rr, l - 4:l] = INK
            draw_text(img, lab, rr, l - 7, anchor="cr")
        draw_text(img, self.xlabel, b + 38, (l + r) / 2, anchor="bc")
        draw_text(img, self.ylabel, (t + b) / 2, l - SLOT_LEFT + 4, anchor="cl", vertical=True)
        draw_text(img, self.title, t - 6, (l + r) / 2, anchor="bc")
        for x, y, text, ha, va, color in self.texts:
            lines = text.split("\n")
            top = b - y * (b - t) - {"bottom": 8 * len(lines) - 1, "center": 4 * len(lines), "top": 0}[va]
            col = l + x * (r - l)
            for i, line in enumerate(lines):
                draw_text(img, line, top + 8 * i, col, anchor="t" + ha[0], color=color)
        labelled = [(lab, color, ls) for _, _, color, _, _, lab, ls in self.lines if lab]
        if self.show_legend and labelled:
            _legend(img, labelled, t + 6, r - 6, "right", 1)


def _sample(img, row: int, col: int, color, ls: str, length: int = 16, lw: int = 2) -> None:
    """A legend's line sample: `length` pixels of `ls` from (row, col) rightwards."""
    cols = col + np.flatnonzero(_dashed(np.arange(length) + 0.5, ls, lw))
    img[row:row + lw, cols] = color


def _legend(img, entries, row: int, col: int, align: str, ncol: int) -> None:
    """A boxed legend of (label, colour, style) entries in `ncol` columns,
    its top edge at `row`, its right edge (align='right') or centre
    (align='center') at `col`."""
    width = 28 + 6 * max(len(lab) for lab, _, _ in entries)
    nrow = -(-len(entries) // ncol)
    w, h = width * min(ncol, len(entries)), 12 * nrow + 4
    x0 = col - w if align == "right" else col - w // 2
    img[row:row + h, x0:x0 + w] = 255
    img[row, x0:x0 + w] = img[row + h, x0:x0 + w] = INK
    for i, (lab, color, ls) in enumerate(entries):
        yc, xc = row + 8 + 12 * (i // ncol), x0 + width * (i % ncol)
        _sample(img, yc, xc + 4, color, ls)
        draw_text(img, lab, yc + 1, xc + 24, anchor="cl")


class Figure:
    """A white canvas of round(width_in dpi) x round(height_in dpi) pixels
    holding a grid of `Panel`s (`grid`), a legend of its own (`legend`) and
    a title above them (`suptitle`); `save` draws it and writes the PNG."""

    def __init__(self, width_in: float, height_in: float, dpi: int = 100):
        self.width, self.height = int(round(width_in * dpi)), int(round(height_in * dpi))
        self.dpi = dpi
        self.panels: List[Panel] = []
        self.shared: List[List[Panel]] = []  # groups of panels with one y range
        self.title, self.entries = "", []

    def grid(self, rows: int, cols: int, sharey=False,
             rect: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)) -> List[List[Panel]]:
        """rows x cols axes, each in an equal slot with `SLOT_*` margins
        around its frame (matplotlib's `squeeze=False` layout), the slots
        filling `rect` (left, bottom, right, top as fractions of the figure,
        as `tight_layout(rect=...)`); `sharey` True gives every axes one y
        range, "row" each row its own."""
        x_lo, x_hi = round(rect[0] * self.width), round(rect[2] * self.width)
        y_lo, y_hi = round((1 - rect[3]) * self.height), round((1 - rect[1]) * self.height)
        out = []
        for i in range(rows):
            y0, y1 = y_lo + i * (y_hi - y_lo) // rows, y_lo + (i + 1) * (y_hi - y_lo) // rows
            out.append([])
            for j in range(cols):
                x0, x1 = x_lo + j * (x_hi - x_lo) // cols, x_lo + (j + 1) * (x_hi - x_lo) // cols
                panel = Panel(y0 + SLOT_TOP, x0 + SLOT_LEFT, y1 - SLOT_BOTTOM, x1 - SLOT_RIGHT, self.dpi)
                out[-1].append(panel)
                self.panels.append(panel)
        if sharey == "row":
            self.shared += out
        elif sharey:
            self.shared.append([p for row in out for p in row])
        return out

    def legend(self, entries, ncol: int) -> None:
        """A legend of (label, colour, style) entries at the bottom centre."""
        self.entries = [(lab, rgb(color), ls) for lab, color, ls in entries]
        self.ncol = ncol

    def suptitle(self, text: str) -> None:
        self.title = text

    def render(self) -> np.ndarray:
        """The figure as a (height, width, 4) uint8 RGBA array."""
        img = np.full((self.height, self.width, 3), 255, np.uint8)
        grouped = {id(p) for group in self.shared for p in group}
        for group in self.shared:
            ys = np.concatenate([p.extent()[1] for p in group])
            for p in group:
                p.autoscale(ys)
        for panel in self.panels:
            if id(panel) not in grouped:
                panel.autoscale()
            panel.draw(img)
        draw_text(img, self.title, 6, self.width / 2, anchor="tc")
        if self.entries:
            _legend(img, self.entries, self.height - 12 * -(-len(self.entries) // self.ncol) - 10,
                    self.width // 2, "center", self.ncol)
        return np.concatenate([img, np.full((self.height, self.width, 1), 255, np.uint8)], axis=2)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(png_bytes(self.render()))
