"""Series-to-PNG charting.

Reference semantics: tools/Graph.java (xchart) re-done with matplotlib:
Series of (x, y) report lines, statSeries min/max/avg envelope across
same-x series (Graph.java:214-250), cleanSeries flat-tail trimming
(Graph.java:167-192).
"""

from __future__ import annotations

from typing import List, Optional

EPS = 1e-9


class ReportLine:
    __slots__ = ("x", "y")

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)


class Series:
    def __init__(self, description: str = ""):
        self.description = description
        self.vals: List[ReportLine] = []

    def add_line(self, line: ReportLine) -> None:
        self.vals.append(line)


class StatSeries:
    def __init__(self, min_s: Series, max_s: Series, avg_s: Series):
        self.min = min_s
        self.max = max_s
        self.avg = avg_s


def stat_series(title: str, series: List[Series]) -> StatSeries:
    """Per-index min/max/avg across series; indexes must share x values.
    Exhausted (shorter) series carry their last value into the average but
    not min/max, and the divisor is the full series count — exactly
    Graph.statSeries (Graph.java:214-250)."""
    s_min = Series(f"{title}(min)")
    s_max = Series(f"{title}(max)")
    s_avg = Series(f"{title}(avg)")
    largest = max(series, key=lambda s: len(s.vals), default=None)
    for i in range(len(largest.vals) if largest else 0):
        x = largest.vals[i].x
        tot = 0.0
        mn, mx = float("inf"), float("-inf")
        for s in series:
            if i < len(s.vals):
                if abs(s.vals[i].x - x) > EPS:
                    raise ValueError(
                        f"We need the indexes to be the same, x={x}, lx={s.vals[i].x}"
                    )
                y = s.vals[i].y
                tot += y
                mn = min(mn, y)
                mx = max(mx, y)
            else:
                tot += s.vals[-1].y
        s_min.add_line(ReportLine(x, mn))
        s_max.add_line(ReportLine(x, mx))
        s_avg.add_line(ReportLine(x, tot / len(series)))
    return StatSeries(s_min, s_max, s_avg)


class Graph:
    def __init__(self, graph_title: str, x_name: str, y_name: str):
        self.graph_title = graph_title
        self.x_name = x_name
        self.y_name = y_name
        self.series: List[Series] = []
        self.forced_min_y: Optional[float] = None

    def add_serie(self, s: Series) -> None:
        self.series.append(s)

    def set_forced_min_y(self, y: float) -> None:
        self.forced_min_y = y

    def clean_series(self) -> None:
        """Trim trailing entries where every series has gone flat
        (Graph.java:167-192); all series must share one length."""
        if not self.series:
            return
        unique_size = len(self.series[0].vals)
        for s in self.series:
            if len(s.vals) != unique_size:
                raise ValueError(
                    f"different size uniqueSize={unique_size}, size={len(s.vals)}"
                )
        last = [s.vals[unique_size - 1].y for s in self.series]
        for i in range(unique_size - 2, 1, -1):
            for ii, s in enumerate(self.series):
                if abs(last[ii] - s.vals[i].y) > EPS:
                    return
            for s in self.series:
                s.vals.pop()

    def save(self, dest: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 8))
        for s in self.series:
            ax.plot(
                [v.x for v in s.vals],
                [v.y for v in s.vals],
                label=s.description or None,
                linewidth=1.2,
            )
        ax.set_title(self.graph_title)
        ax.set_xlabel(self.x_name)
        ax.set_ylabel(self.y_name)
        if self.forced_min_y is not None:
            ax.set_ylim(bottom=self.forced_min_y)
        if any(s.description for s in self.series):
            ax.legend(loc="best", fontsize=8)
        ax.grid(True, alpha=0.3)
        fig.savefig(dest, dpi=150, bbox_inches="tight")
        plt.close(fig)
