"""The host-speed record printed on an earlier line of every run: what a
host-paced rate depends on besides the code, to tell a slow host from a
regression. Nothing of it goes into the result."""

import os
import random
import subprocess
import time
from typing import Dict

SMI_FIELDS = ("name", "clocks.sm", "power.draw", "power.limit", "temperature.gpu")


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def probe_ms(seed: int = 20260101, n: int = 200_000) -> float:
    """Host ms of a fixed seeded piece of Python work (draw, sort, sum), the
    kind of work the host loop does between launches."""
    t = time.perf_counter()
    rng = random.Random(seed)
    xs = [rng.random() for _ in range(n)]
    xs.sort()
    sum(xs)
    return 1e3 * (time.perf_counter() - t)


def smi() -> Dict:
    """nvidia-smi's reading of each card: clocks, power and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    if out.returncode != 0:
        return {"error": out.stderr.strip()[-200:]}
    return {"cards": [dict(zip(SMI_FIELDS, (v.strip() for v in line.split(","))))
                      for line in out.stdout.strip().splitlines()]}


def record() -> Dict:
    return {"cpu": cpu_model(), "logical_cores": os.cpu_count(),
            "loadavg": list(os.getloadavg()), "probe_ms": probe_ms(), "nvidia_smi": smi()}
