"""Progress subsystem (utils/progress.py vs /root/reference/ProgressBar.h).

The reference's ThreadSafeProgress holds one mutex across counter update
and redraw (ProgressBar.h:70-79); ours must match — an interleaved
reporter may never draw a stale (smaller) total than one already drawn.
"""

import io
import re
import threading

from lowcut.utils.progress import ProgressBar, ThreadSafeProgress


def test_bar_renders_and_finalizes():
    out = io.StringIO()
    bar = ProgressBar(goal=100, bar_width=10, stream=out, enabled=True)
    bar.update(50)
    bar.final()
    s = out.getvalue()
    assert "50.0 %" in s
    assert "100.0 %" in s
    # Final line: bar_width + 1 '=' glyphs (ProgressBar.h:49-52 parity).
    assert "[" + "=" * 11 + "]" in s


def test_set_progress_public_api():
    out = io.StringIO()
    bar = ProgressBar(goal=200, bar_width=10, stream=out, enabled=True)
    bar.set_progress(100)
    assert "50.0 %" in out.getvalue()


def test_threadsafe_progress_two_thread_hammer():
    """Two threads hammer report(); drawn percentages must be monotone
    (no stale-total redraw) and the final drawn total must be complete."""
    out = io.StringIO()
    total = 200_000
    bar = ProgressBar(goal=total, bar_width=80, stream=out, enabled=True)
    tsp = ThreadSafeProgress(bar, total)

    def worker():
        for _ in range(100):
            tsp.report(1000)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    pcts = [float(m) for m in re.findall(r"(\d+\.\d) %", out.getvalue())]
    assert pcts, "nothing drawn"
    assert pcts == sorted(pcts), "stale total drawn out of order"
    assert pcts[-1] == 100.0
    assert tsp._counter == total
