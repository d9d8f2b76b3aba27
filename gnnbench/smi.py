"""The card's clocks and power beside the window, read by ``nvidia-smi``.

One ``nvidia-smi`` process samples the SM clock, the power draw and limit
and the temperature once a second while the window runs; ``stop`` ends it,
waits for it and returns the lowest, median and highest of each. Where
there is no ``nvidia-smi`` nothing is sampled.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess

FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")
NAMES = ("sm_clock_mhz", "power_w", "power_limit_w", "temperature_c")


class Sampler:
    """Samples the first card (the one a one-chip run uses)."""

    def __init__(self):
        exe = shutil.which("nvidia-smi")
        self.proc = None if exe is None else subprocess.Popen(
            [exe, "--id=0", f"--query-gpu={','.join(FIELDS)}",
             "--format=csv,noheader,nounits", "-lms=1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        cols = {k: [] for k in NAMES}
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(FIELDS):
                continue
            for k, p in zip(NAMES, parts):
                try:
                    cols[k].append(float(p))
                except ValueError:
                    pass
        return {k: [min(v), statistics.median(v), max(v)]
                for k, v in cols.items() if v}
