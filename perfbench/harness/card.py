"""What the card's driver says of it: name and power limit before a run,
clocks, temperature, power draw and the reasons its clocks are held down
right after the window (read outside the window)."""

from __future__ import annotations

import subprocess

FIELDS = ("name", "power.limit")
STATE = ("clocks.sm", "clocks.max.sm", "temperature.gpu", "power.draw",
         "clocks_event_reasons.active")


def query(fields) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({type(err).__name__})"


def line() -> str:
    return query(FIELDS)


def state() -> str:
    return query(STATE)
