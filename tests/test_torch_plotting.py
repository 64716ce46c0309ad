"""The port's metric plots (iltpu_torch/utils/plotting.py, no matplotlib)
against iltpu's (`iltpu/utils/plotting.py`, matplotlib): `Trainer._plots` of
both packages on the same metrics (GAIL, SAC, BC's early exit) write the
same file names at the same size; the port's PNGs decode through zlib here
with every CRC valid; the mean line and the +-1 std band lie where the
module's own axis transform puts them; edge cases write valid files; and
the port's trainer writes the plots at iltpu's two call sites (after an
evaluation, and at BC's early exit)."""

import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils import plotting
from test_torch_trainer import BASE

torch.set_num_threads(1)


def decode_png(path, pixels=True):
    """(width, height, RGBA array) of an 8-bit RGBA PNG whose rows all use
    filter type 0 (the port's), every chunk's CRC checked; with
    pixels=False (matplotlib's, whose rows take other filters) the array is
    None."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    p, chunks = 8, []
    while p < len(data):
        (n,) = struct.unpack(">I", data[p:p + 4])
        tag, body = data[p + 4:p + 8], data[p + 8:p + 8 + n]
        (crc,) = struct.unpack(">I", data[p + 8 + n:p + 12 + n])
        assert zlib.crc32(tag + body) == crc, tag
        chunks.append((tag, body))
        p += 12 + n
    assert chunks[0][0] == b"IHDR" and chunks[-1] == (b"IEND", b"")
    w, h, depth, color = struct.unpack(">IIBB", chunks[0][1][:10])
    if not pixels:
        return w, h, None
    assert (depth, color) == (8, 6)
    raw = zlib.decompress(b"".join(body for tag, body in chunks if tag == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 4 * w)
    assert not rows[:, 0].any(), "filter type 0 on every row"
    return w, h, rows[:, 1:].reshape(h, w, 4)


def metrics(algorithm, seed=0):
    """A metrics dict as a run leaves it: 10 evaluations, 30 episode ends,
    12 logged updates (BC's early exit: one evaluation at step 0, nothing
    else)."""
    rng = np.random.default_rng(seed)
    if algorithm == "BC":
        return dict(train_steps=[], train_returns=[], test_steps=[0],
                    test_returns=[list(rng.normal(500, 40, 5))], update_steps=[],
                    predicted_rewards=[], alphas=[], entropies=[], Q_values=[])
    t = np.arange(1, 11) * 10_000
    u = np.arange(1, 13) * 8_000
    return dict(
        test_steps=t.tolist(), test_returns=[list(rng.normal(300 * i, 50, 5)) for i in range(10)],
        train_steps=np.sort(rng.integers(1_000, 100_000, 30)).tolist(),
        train_returns=[[float(v)] for v in rng.normal(1_000, 300, 30)],
        update_steps=u.tolist(),
        predicted_rewards=[list(rng.normal(-0.1 * i, 0.05, 16)) for i in range(12)],
        alphas=[float(v) for v in np.exp(-0.2 * np.arange(12))],
        entropies=[list(rng.normal(-3 + 0.1 * i, 0.3, 16)) for i in range(12)],
        Q_values=[list(rng.normal(20 * i, 5, 16)) for i in range(12)],
    )


def plot_with(cls, m, algorithm, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    cls._plots(SimpleNamespace(metrics=m, out_dir=str(out_dir), prefix="",
                               cfg=SimpleNamespace(algorithm=algorithm, env="hopper")))
    return sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))


# what iltpu's _plots passes: {file: (x key, y key, y label)}
SERIES = {"test_returns": ("test_steps", "test_returns", "Returns"),
          "train_returns": ("train_steps", "train_returns", "Returns"),
          "predicted_rewards": ("update_steps", "predicted_rewards", "Predicted Reward"),
          "sac_alpha": ("update_steps", "alphas", "Alpha"),
          "sac_entropy": ("update_steps", "entropies", "Entropy"),
          "Q_values": ("update_steps", "Q_values", "Q-value")}


def assert_drawn(img, x, y):
    """At each x, a #1f77b4 pixel within 1 px of the mean's row under the
    module's own transform; the band's pixels within 1 px of mean +- std,
    and band and line together covering that span."""
    ax = plotting.axes_for(x, y)
    xs = np.asarray(x, np.float64)  # iltpu's statistics, float64
    means = np.asarray([np.mean(v) for v in y], np.float64)
    stds = np.asarray([np.std(v) for v in y], np.float64)
    rgb = img[..., :3]
    blue = (rgb == plotting.BLUE).all(-1)
    band = (rgb == plotting.BAND).all(-1)
    assert (img[..., 3] == 255).all()
    for xi, m, s in zip(xs, means, stds):
        c, r = int(np.floor(ax.col(xi))), int(np.floor(ax.row(m)))
        assert blue[r - 1:r + 2, c].any(), (xi, m)
        top, bottom = int(np.floor(ax.row(m + s))), int(np.floor(ax.row(m - s)))
        rows = np.flatnonzero(band[:, c])
        if rows.size:
            assert rows.min() >= top - 1 and rows.max() <= bottom + 1, (xi, rows, top, bottom)
        filled = np.flatnonzero(band[:, c] | blue[:, c])
        assert filled.min() <= top + 1 and filled.max() >= bottom - 1, (xi, top, bottom)


@pytest.mark.parametrize("algorithm", ["GAIL", "SAC", "BC"])
def test_plots_match_iltpu(tmp_path, algorithm):
    pytest.importorskip("matplotlib")
    m = metrics(algorithm)
    ref = plot_with(JaxTrainer, m, algorithm, tmp_path / "jax")
    got = plot_with(Trainer, m, algorithm, tmp_path / "torch")
    assert got == ref
    assert len(got) == {"GAIL": 6, "SAC": 5, "BC": 1}[algorithm]
    for name in got:
        w, h, img = decode_png(tmp_path / "torch" / name)
        rw, rh, _ = decode_png(tmp_path / "jax" / name, pixels=False)
        assert (w, h) == (rw, rh) == (600, 400)
        xk, yk, _ = SERIES[name[:-4]]
        assert_drawn(img, m[xk], m[yk])


@pytest.mark.parametrize("case", ["single_point", "constant", "negative", "empty", "nan"])
def test_edge_cases_write_valid_files(tmp_path, case):
    x, y = {
        "single_point": ([0], [[3.0, 4.0]]),
        "constant": (list(range(0, 5000, 500)), [[2.5]] * 10),
        "negative": ([1, 2, 3, 4], [[-1e6, -2e6], [-3e6], [-2.5e6, -1e5], [-7e5]]),
        "empty": ([], []),
        "nan": ([1, 2, 3], [[1.0], [float("nan")], [3.0]]),
    }[case]
    plotting.lineplot(x, y, str(tmp_path / "sub" / case), yaxis="Q-value", title="GAIL: hopper")
    w, h, img = decode_png(tmp_path / "sub" / f"{case}.png")
    assert (w, h) == (600, 400)
    if case not in ("empty", "nan"):
        assert_drawn(img, x, y)
    if case == "constant":  # std 0: the line alone, where the band would be
        ax = plotting.axes_for(x, y)
        assert ax.y[0] < 2.5 < ax.y[1]


def test_text_ticks_and_font():
    assert plotting.FONT.shape == (95, 7, 5)
    assert plotting.text_mask("Steps", 2).shape == (14, 2 * (6 * 5 - 1))
    ticks, step = plotting.nice_ticks(-0.05, 1.05)
    assert ticks.tolist() == [0.0, 0.25, 0.5, 0.75, 1.0] and step == 0.25
    assert [plotting.tick_label(v, 2500) for v in (0, 2500, 5000)] == ["0", "2500", "5000"]
    assert plotting.tick_label(0.25, 0.25) == "0.25"
    assert plotting.tick_label(-1.5, 0.5) == "-1.5"


def test_trainer_writes_the_plots_at_both_call_sites(tmp_path):
    """After each evaluation (GAIL, an evaluation every 200 steps, episodes of
    100 steps on pointmass ending) and at BC's early exit, the port's trainer writes the
    files iltpu's _plots names for its metrics."""
    runs = {"GAIL": ["evaluation.interval=200", "steps=600"],
            "BC": ["algorithm=BC", "bc_pretraining.iterations=20", "training.sac_pallas=false",
                   "training.disc_pallas=false", "training.fused_update_scan=false"]}
    for alg, extra in runs.items():
        out = tmp_path / alg
        t = Trainer(load_config(BASE + extra + ["logging.interval=50", "platform=cpu"]),
                    out_dir=str(out))
        t.run()
        written = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        assert written == plot_with(JaxTrainer, t.metrics, alg, tmp_path / f"{alg}_jax")
        assert len(written) == {"GAIL": 6, "BC": 1}[alg]
        for name in written:
            assert decode_png(out / name)[:2] == (600, 400)


# the figure API the reports draw with: a canvas of a given size holding a grid of axes


@pytest.mark.parametrize("size", [(12, 3.5, 120, 1, 3), (7.0, 9, 120, 2, 2), (3.33, 2.17, 100, 1, 1)])
def test_figure_grid_decodes_at_its_size(tmp_path, size):
    w_in, h_in, dpi, rows, cols = size
    fig = plotting.Figure(w_in, h_in, dpi)
    axes = fig.grid(rows, cols)
    assert [len(r) for r in axes] == [cols] * rows
    for r in axes:
        for ax in r:
            ax.plot([0, 1, 2], [1.0, -1.0, 3.0], label="x")
            ax.set_title("t")
            ax.legend()
    fig.save(str(tmp_path / "f.png"))
    w, h, img = decode_png(tmp_path / "f.png")
    assert (w, h) == (round(w_in * dpi), round(h_in * dpi))
    assert (img[..., 3] == 255).all()


def test_figure_series_lie_where_each_axes_puts_them(tmp_path):
    """Two axes of different data ranges: each line's pixels at its own
    axes' transform, in the cycle's first colour (the second line in the
    second), the band's blend at alpha 0.2 between its edges, a scatter
    point's disk at its centre, a slot switched off white throughout."""
    fig = plotting.Figure(10, 6, 100)
    (a, b), (c, off) = fig.grid(2, 2)
    x = np.array([0.0, 10.0, 20.0, 30.0])
    a.plot(x, [1.0, 2.0, 4.0, 3.0])
    a.plot(x, [0.0, 0.5, 0.5, 1.0])
    b.fill_between([0, 1], [-100.0, -50.0], [100.0, 150.0], alpha=0.2)
    c.scatter([0.25, 0.75], [5.0, 6.0], s=14, alpha=0.7)
    off.plot([0, 1], [0, 1])
    off.axis("off")
    img = fig.render()[..., :3]
    c0, c1 = plotting.rgb(plotting.CYCLE[0]), plotting.rgb(plotting.CYCLE[1])
    assert a.y[0] < 0 and a.y[1] > 4 and b.y[0] < -100 and b.y[1] > 150  # limits of their own
    for ax, ys, color in ((a, [1.0, 2.0, 4.0, 3.0], c0), (a, [0.0, 0.5, 0.5, 1.0], c1)):
        for xi, yi in zip(x[1:-1], ys[1:-1]):
            col, row = int(np.floor(ax.col(xi))), int(np.floor(ax.row(yi)))
            assert (img[row - 1:row + 2, col - 1:col + 2] == color).all(-1).any(), (xi, yi)
    band = np.round(0.2 * c0 + 0.8 * 255).astype(np.uint8)
    col = int(np.floor(b.col(0.5)))
    inside = np.flatnonzero((img[:, col] == band).all(-1))
    assert abs(inside.min() - b.row(125.0)) <= 1 and abs(inside.max() - b.row(-75.0)) <= 1
    assert not (img[:, col] == band).all(-1)[:b.top].any()
    disk = np.round(0.7 * c0 + 0.3 * 255).astype(np.uint8)
    for xi, yi in ((0.25, 5.0), (0.75, 6.0)):
        col, row = int(np.floor(c.col(xi))), int(np.floor(c.row(yi)))
        assert (img[row, col] == disk).all() and (img[row + 6, col] == 255).all()
    assert (img[fig.height // 2:, fig.width // 2:] == 255).all()


def test_viridis_anchors():
    assert [plotting.viridis(v)[0].tolist() for v in (0.0, 0.5, 1.0)] == [
        [0x44, 0x01, 0x54], [0x21, 0x91, 0x8C], [0xFD, 0xE7, 0x25]]
    mid = plotting.viridis(0.125)[0].astype(int)
    assert (np.abs(mid - (plotting.rgb("#440154").astype(int) + plotting.rgb("#3b528b")) / 2) <= 0.5).all()


# what the results matrix and the run diagnostics add to the figure API: line
# styles, horizontal lines, fixed and shared limits, a log scale, grid lines,
# text in axes coordinates, a figure legend and a suptitle


@pytest.mark.parametrize("ls,share", [("-", 1.0), ("--", 3.7 / 5.3), (":", 1.0 / 2.65)])
def test_line_styles_paint_their_share_of_a_line(ls, share):
    fig = plotting.Figure(6, 3, 100)
    (ax,) = fig.grid(1, 1)[0]
    ax.plot([0.0, 1.0], [0.5, 0.5], color="#ff0000", lw=3, ls=ls)
    ax.set_ylim(0, 1)
    img = fig.render()[..., :3]
    row = int(np.floor(ax.row(0.5) - 1))
    painted = (img[row, int(np.ceil(ax.col(0.0))):int(ax.col(1.0))] == [255, 0, 0]).all(-1)
    assert abs(painted.mean() - share) < 0.08
    if ls != "-":  # dashes: several runs, not one
        assert np.count_nonzero(np.diff(painted.astype(int)) == 1) >= 5


def test_shared_and_fixed_limits_log_scale_and_hline():
    fig = plotting.Figure(8, 6, 100)
    (a, b), (c, d) = fig.grid(2, 2, sharey="row")
    a.plot([0, 1], [0.0, 1.0])
    b.plot([0, 1], [5.0, 6.0])
    c.plot([0, 1], [10.0, 20.0])
    d.axhline(1.0, "#6b6a60", lw=1, ls=":")
    d.set_xlim(0, 100)
    c.set_yscale("log")
    fig.render()
    assert a.y == b.y and a.y[0] < 0.0 and a.y[1] > 6.0  # one range along the row
    assert c.x == (-0.05, 1.05) and d.x == (0.0, 100.0) and d.y[0] < 1.0 < 20.0 < d.y[1]
    # the log scale: equal decades; the row's range (the horizontal line's 1.0 counts)
    # with 5% margins in log space; powers-of-ten ticks
    assert c.row(10.0) - c.row(100.0) == pytest.approx(c.row(1.0) - c.row(10.0))
    lo, hi = np.log10(c.y)
    assert (lo, hi) == pytest.approx((-0.05 * np.log10(20), 1.05 * np.log10(20)))
    assert plotting.log_ticks(0.01, 2.0) == (pytest.approx([0.01, 0.1, 1.0]), ["1e-2", "1e-1", "1e0"])
    whole = plotting.Figure(6, 3, 100)
    (e, f) = whole.grid(1, 2, sharey=True)[0]
    e.plot([0, 1], [0.0, 1.0])
    f.plot([0, 1], [3.0, 4.0])
    f.set_ylim(-1, 2)
    empty = whole.grid(1, 1)[0][0]
    empty.set_yscale("log")  # a log panel with no data still draws
    whole.render()
    assert f.y == (-1.0, 2.0) and e.y == plotting._limits(0.0, 4.0) and empty.y == (1.0, 10.0)


def test_text_grid_figure_legend_and_suptitle():
    fig = plotting.Figure(8, 4, 100)
    (ax,) = fig.grid(1, 1, rect=(0, 0.1, 1, 0.9))[0]
    ax.plot([0, 1], [0, 1], color="#2a78d6", lw=2)
    ax.text(0.99, 0.02, "GAIL: tuned s=2\nPWIL: untuned s=1", ha="right", va="bottom", color="#00ff00")
    ax.grid("#e8e6dc")
    fig.legend([("GAIL", "#2a78d6", "-"), ("SQIL", "#1baf7a", "--")], ncol=2)
    fig.suptitle("a title")
    img = fig.render()[..., :3]
    assert ax.top >= 0.1 * fig.height and ax.bottom <= 0.9 * fig.height  # inside the rect's slot
    rows, cols = np.nonzero((img == [0, 255, 0]).all(-1))
    right, bottom = ax.left + 0.99 * (ax.right - ax.left), ax.bottom - 0.02 * (ax.bottom - ax.top)
    assert cols.max() <= right and right - cols.max() < 3 and rows.max() <= bottom
    assert rows.max() - rows.min() > 8  # two lines of text
    assert (img[ax.top + 1:ax.bottom, ax.left + 1:ax.right] == [0xE8, 0xE6, 0xDC]).all(-1).any()
    legend = img[int(0.9 * fig.height):]
    for color in ("#2a78d6", "#1baf7a"):
        assert (legend == plotting.rgb(color)).all(-1).any()
    assert (img[:ax.top - 20] == 0).all(-1).any()  # the suptitle's ink above the axes
