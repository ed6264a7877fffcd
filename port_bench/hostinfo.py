"""Where a run's host thread runs, and the card's state beside the window.

Every run prints these on earlier lines of standard error, so that a
spread between runs can be traced to the host: the CPUs the process may
run on, the CPU it runs on at the start and the end of the window, the
card's PCI bus id with that device's `local_cpulist` and `numa_node`, and
the card's clocks, power and temperature before and after the window. A
run over several cards also prints how they are linked.

A run over several cards gives each rank whole cores of its own, near its
card where the card's `local_cpulist` says which are (`split_cores`,
`pin_threads`), so that no rank's host thread shares a core with another
rank's and a rank stays on the same cores from run to run.
"""

from __future__ import annotations

import os
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


def card_links() -> str:
    """How the cards are linked to each other (NVLink or PCIe), as
    `nvidia-smi topo -m` prints its matrix, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return "\n" + out.stdout.rstrip() if out.returncode == 0 and out.stdout.strip() else "unknown"


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


def cpu_list(text: str) -> set:
    """The CPUs of a sysfs list such as "0-3,8,10-11"."""
    out = set()
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out.update(range(int(a), int(b or a) + 1))
    return out


def cpu_cores(cpus) -> list:
    """`cpus` grouped by the physical core they run on (sysfs topology;
    a CPU whose core cannot be read is a core of its own), each core a
    tuple of its CPUs, in the order of their first CPU."""
    groups = {}
    for c in sorted(cpus):
        topo = Path(f"/sys/devices/system/cpu/cpu{c}/topology")
        try:
            key = ((topo / "physical_package_id").read_text().strip(),
                   (topo / "core_id").read_text().strip())
        except OSError:
            key = ("cpu", c)
        groups.setdefault(key, []).append(c)
    return sorted((tuple(v) for v in groups.values()), key=lambda core: core[0])


def split_cores(cores: list, near: list) -> list | None:
    """Disjoint CPUs for each rank, whole `cores` each: the cores near a
    rank's card (`near[r]`, a set of CPUs, or None where not known) shared
    out in rank order among the ranks whose cards they are near; where that
    leaves a rank no core or gives one core twice, all `cores` shared out
    in rank order. None when there are fewer cores than ranks."""
    ranks = len(near)
    if len(cores) < ranks:
        return None

    def even(pool, among):
        each = len(pool) // len(among)
        return {r: [c for core in pool[k * each:(k + 1) * each] for c in core]
                for k, r in enumerate(among)}

    by_pool = {}
    for r, cpus in enumerate(near):
        pool = tuple(core for core in cores if cpus and set(core) <= cpus)
        by_pool.setdefault(pool, []).append(r)
    got = {}
    for pool, among in by_pool.items():
        if len(pool) < len(among):
            got = even(cores, list(range(ranks)))
            break
        got.update(even(pool, among))
    out = [got[r] for r in range(ranks)]
    flat = [c for cpus in out for c in cpus]
    if len(flat) != len(set(flat)):
        got = even(cores, list(range(ranks)))
        out = [got[r] for r in range(ranks)]
    return out


def card_local_cpus(props) -> set | None:
    """The CPUs near a CUDA card (its PCI device's `local_cpulist`), from
    the card's `torch.cuda.get_device_properties`; None where they cannot
    be read."""
    try:
        addr = f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
        return cpu_list((Path("/sys/bus/pci/devices") / addr / "local_cpulist").read_text())
    except (AttributeError, OSError, ValueError):
        return None


def pin_threads(cpus) -> int:
    """Bind every thread of this process to `cpus` (threads started later
    inherit the binding); returns how many threads were bound."""
    n = 0
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
            n += 1
        except OSError:
            pass
    return n
