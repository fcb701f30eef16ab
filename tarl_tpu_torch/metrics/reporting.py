"""Reports: plots and CSV files from the simulator's accumulators (ports
``tarl_tpu/metrics/reporting.py``).

Six artifacts, in the reference's formats: ``leg_histogram.png``,
``road_optimality.png`` (from the dense per-tick rows, the sparse store's
columns or the hourly accumulator), ``computation_time.png``,
``node_metrics.csv``, ``daily_counts.png`` and ``daily_counts.csv``.  The
data of each is computed with numpy; the two CSV files are written with
the ``csv`` module, byte for byte what ``pandas.DataFrame.to_csv(index=
False)`` writes for the same columns (float64 cells in Python's shortest
round-trip form, NaN as an empty cell, ``\\n`` line ends).

matplotlib is the optional ``reports`` extra: it is imported only inside
the functions that draw, and where it is missing they raise
:class:`PlottingUnavailable`, an :class:`ImportError` that names it, after
writing any CSV file of theirs.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

# The figures each drawing function writes, for a caller that reports
# which ones were not drawn.
LEG_HISTOGRAM_PNG = "leg_histogram.png"
ROAD_OPTIMALITY_PNG = "road_optimality.png"
COMPUTATION_TIME_PNG = "computation_time.png"
DAILY_COUNTS_PNG = "daily_counts.png"


MATPLOTLIB_MISSING = ("matplotlib cannot be imported (the optional "
                      "'reports' extra)")


class PlottingUnavailable(ImportError):
    """matplotlib cannot be imported, so a figure cannot be drawn."""


def _pyplot(figure: str):
    """``matplotlib.pyplot`` on the Agg backend, or
    :class:`PlottingUnavailable` naming matplotlib and the figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise PlottingUnavailable(
            f"{MATPLOTLIB_MISSING}: cannot draw {figure}") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _savefig(fig, output_dir: Optional[str], filename: str):
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        fig.savefig(os.path.join(output_dir, filename))
        print(f"Saved {os.path.join(output_dir, filename)}")
    return fig


def _cell(v) -> str:
    """One CSV cell as pandas writes it: integers in decimal, floats in
    their shortest round-trip form, NaN empty."""
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return "" if v != v else repr(v)
    return str(int(v))


def _write_csv(path: str, columns: dict) -> None:
    """``columns`` (name -> sequence, equal lengths) as a CSV file with a
    header row and no index column."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*(columns[n] for n in names)):
            w.writerow([_cell(v) for v in row])


# --- leg histogram -------------------------------------------------------------

def leg_histogram_data(values: list, timestep: int) -> Optional[dict]:
    """The leg histogram's series from the per-tick ``[departures,
    arrivals, on_way, time]`` rows, binned every ``18 // timestep`` ticks:
    the minute of day and the en-route count at each bin's first tick, the
    departures and arrivals summed over the bin.  ``None`` without rows."""
    if not values:
        return None
    arr = np.asarray(values, dtype=np.float64)
    n = max(1, 18 // max(timestep, 1))
    t = arr.shape[0]
    nbins = (t + n - 1) // n
    padded = np.pad(arr, ((0, nbins * n - t), (0, 0)))
    return {
        "minute": arr[::n, 3][:nbins] / 60.0,
        "on_way": arr[::n, 2][:nbins],
        "departures": padded[:, 0].reshape(nbins, n).sum(axis=1),
        "arrivals": padded[:, 1].reshape(nbins, n).sum(axis=1),
    }


def plot_leg_histogram(values: list, timestep: int,
                       output_dir: Optional[str] = "data/outputs"):
    """Departures, arrivals and agents en route over the day
    (:func:`leg_histogram_data`)."""
    data = leg_histogram_data(values, timestep)
    if data is None:
        print("No data available for plotting.")
        return None
    plt = _pyplot(LEG_HISTOGRAM_PNG)
    fig, ax1 = plt.subplots(figsize=(12, 6))
    t_min = data["minute"]
    ax1.step(t_min, data["on_way"], label="On Way", color="green")
    ax1.step(t_min, data["departures"], label="Departure", color="red",
             linestyle="--", where="post")
    ax1.step(t_min, data["arrivals"], label="Arrival", color="blue",
             linestyle="-.", where="post")
    ax1.set_ylabel("Number of Agents")
    ax1.set_xlabel("Minute of Day")
    ax1.legend(loc="upper left")
    ax1.set_title("Leg Histogram Over Time")
    fig.tight_layout()
    return _savefig(fig, output_dir, LEG_HISTOGRAM_PNG)


# --- road optimality -----------------------------------------------------------

def _plot_series(times_h: np.ndarray, series: list,
                 output_dir: Optional[str]):
    """One line per ``(road id, series)`` pair."""
    plt = _pyplot(ROAD_OPTIMALITY_PNG)
    fig, ax = plt.subplots(figsize=(12, 6))
    for rid, col in series:
        ax.plot(times_h, col, label=f"Road {rid}")
    ax.set_xlabel("Time (h)")
    ax.set_ylabel("Delta Travel Time (s) — sum over outgoing edges")
    ax.set_title("Road Optimality (Aggregated by Source Road) Over Time")
    if len(series) <= 20:
        ax.legend()
    fig.tight_layout()
    return _savefig(fig, output_dir, ROAD_OPTIMALITY_PNG)


def plot_road_optimality(values: list,
                         output_dir: Optional[str] = "data/outputs",
                         road_ids: Optional[list] = None):
    """Each road's congestion delay (the sum of ``max(travel - fftt, 0)``
    over its outgoing turn edges) over time, from ``(time s, float[R])``
    rows; every road, or ``road_ids``."""
    if not values:
        print("No road optimality data available for plotting.")
        return None
    times = np.asarray([t for t, _ in values]) / 3600.0
    mat = np.stack([np.asarray(v) for _, v in values], axis=0)
    ids = road_ids if road_ids else range(mat.shape[1])
    return _plot_series(times, [(rid, mat[:, rid]) for rid in ids],
                        output_dir)


def plot_road_optimality_columns(times_s: np.ndarray, cols: dict,
                                 output_dir: Optional[str] = "data/outputs"):
    """:func:`plot_road_optimality` from the sparse store's columns
    (``cols``: road id -> [T] series), with no ``[T, R]`` matrix."""
    if not cols or not np.asarray(times_s).size:
        print("No road optimality data available for plotting.")
        return None
    return _plot_series(np.asarray(times_s) / 3600.0,
                        [(rid, np.asarray(s)) for rid, s in cols.items()],
                        output_dir)


# --- computation time ----------------------------------------------------------

def plot_computation_time(timers, output_dir: str = "data/outputs"):
    """The four phase timers as a pie chart."""
    times = [timers.inserting_time, timers.choice_time, timers.core_time,
             timers.withdraw_time]
    labels = ["Inserting", "Choice", "Core", "Withdraw"]
    total = sum(times)
    if total == 0:
        print("No computation time data available for plotting.")
        return None

    def fmt(pct):
        return f"{pct:.1f}%\n{pct / 100 * total:.2f} s"

    plt = _pyplot(COMPUTATION_TIME_PNG)
    fig = plt.figure(figsize=(8, 8))
    plt.pie(times, labels=labels, autopct=fmt, startangle=90)
    plt.title(f"Computation Time Distribution\nTotal: {total:.2f} s")
    plt.axis("equal")
    return _savefig(fig, output_dir, COMPUTATION_TIME_PNG)


# --- node metrics ----------------------------------------------------------------

def _trim_hours(hourly_counts: np.ndarray) -> np.ndarray:
    """The hourly rows up to the last one with traffic (at least one)."""
    nz = np.nonzero(hourly_counts.sum(axis=1))[0]
    last = int(nz[-1]) + 1 if nz.size else 1
    return hourly_counts[:last]


def compute_node_metrics(hourly_counts: np.ndarray, max_flow: np.ndarray,
                         output_dir: Optional[str] = "data/outputs") -> dict:
    """Per road: the hourly traversal counts and the mean and standard
    deviation over the hours of V/C (count over flow capacity, NaN where
    the capacity is 0); written to ``node_metrics.csv`` unless
    ``output_dir`` is None.  Returns ``{road: {"avg_vc", "std_vc",
    "hourly_counts"}}``."""
    counts_per_node = _trim_hours(np.asarray(hourly_counts)).T  # [R, H]
    num_nodes, num_hours = counts_per_node.shape
    cap = np.asarray(max_flow, dtype=np.float64).copy()
    cap[cap == 0] = np.nan
    vc = counts_per_node / cap[:, None]
    avg_vc = np.nanmean(vc, axis=1)
    std_vc = np.nanstd(vc, axis=1)

    if output_dir is not None:
        columns = {"node_id": range(num_nodes), "avg_vc": avg_vc,
                   "std_vc": std_vc}
        for h in range(num_hours):
            columns[f"count_{h}h"] = counts_per_node[:, h]
        path = os.path.join(output_dir, "node_metrics.csv")
        _write_csv(path, columns)
        print(f"Wrote {path}")

    return {
        n: {"avg_vc": float(avg_vc[n]), "std_vc": float(std_vc[n]),
            "hourly_counts": counts_per_node[n].tolist()}
        for n in range(num_nodes)
    }


# --- daily counts ----------------------------------------------------------------

def daily_counts_data(hourly_counts: np.ndarray,
                      expected_counts: dict) -> dict:
    """Per road of ``expected_counts`` (sorted ids within the network):
    its simulated daily count and the expected one, float64."""
    sim_totals = np.asarray(hourly_counts).sum(axis=0)
    road_ids = sorted(k for k in expected_counts
                      if 0 <= k < sim_totals.shape[0])
    return {
        "link_id": road_ids,
        "simulated": sim_totals[road_ids].astype(np.float64),
        "expected": np.asarray([expected_counts[i] for i in road_ids],
                               dtype=np.float64),
    }


def plot_daily_counts(hourly_counts: np.ndarray, expected_counts: dict,
                      output_dir: Optional[str] = "data/outputs"):
    """Simulated against expected daily counts per road: ``daily_counts.
    csv`` (written first, unless ``output_dir`` is None) and the scatter
    ``daily_counts.png``."""
    data = daily_counts_data(hourly_counts, expected_counts)
    x, y = data["expected"], data["simulated"]
    if output_dir is not None:
        path = os.path.join(output_dir, "daily_counts.csv")
        _write_csv(path, {**data, "difference": y - x})
        print(f"Daily counts CSV saved as {path}")

    plt = _pyplot(DAILY_COUNTS_PNG)
    fig, ax = plt.subplots()
    ax.scatter(x, y, alpha=0.7)
    max_val = float(max(x.max() if x.size else 0.0,
                        y.max() if y.size else 0.0))
    ax.plot([0, max_val], [0, max_val], "r--", linewidth=1)
    ax.set_xlabel("Expected daily count")
    ax.set_ylabel("Simulated daily count")
    ax.set_title("Daily Link Counts: Expected vs Simulated")
    fig.tight_layout()
    return _savefig(fig, output_dir, DAILY_COUNTS_PNG)
