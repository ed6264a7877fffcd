"""Where a run's host thread runs, and the card's state beside the window.

Every run prints these on earlier lines of standard error, so that a
spread between runs can be traced to the host: the CPUs the process may
run on, the CPU it runs on at the start and the end of the window, the
card's PCI bus id with that device's `local_cpulist` and `numa_node`, and
the card's clocks, power and temperature before and after the window.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

SMI_FIELDS = "clocks.sm,power.draw,power.limit,temperature.gpu"


def _smi(query: str) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def card_state() -> str:
    """clocks.sm, power.draw, power.limit, temperature.gpu of the first
    card, as nvidia-smi prints them, or "unknown"."""
    return _smi(SMI_FIELDS) or "unknown"


def card_node() -> dict:
    """The first NVIDIA display or 3D device on the PCI bus (sysfs, read
    without starting CUDA): its bus id, local CPUs and NUMA node; values
    are None where they cannot be read."""
    info = {"pci": None, "local_cpulist": None, "numa_node": None}
    root = Path("/sys/bus/pci/devices")
    try:
        devs = sorted(root.iterdir())
    except OSError:
        return info
    for dev in devs:
        try:
            if (dev / "vendor").read_text().strip() != "0x10de" \
                    or not (dev / "class").read_text().strip().startswith(("0x0300", "0x0302")):
                continue
        except OSError:
            continue
        info["pci"] = dev.name
        for key in ("local_cpulist", "numa_node"):
            try:
                info[key] = (dev / key).read_text().strip()
            except OSError:
                pass
        break
    return info


def current_cpu() -> int | None:
    """The CPU this thread last ran on (field 39 of /proc/thread-self/stat)."""
    try:
        stat = Path("/proc/thread-self/stat").read_text()
    except OSError:
        return None
    return int(stat.rsplit(")", 1)[1].split()[36])
